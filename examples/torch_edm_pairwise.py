"""The paper's own benchmark problem on the port: the Euclidean distance
matrix over the lower-triangular domain, scheduled by g(lambda)
(examples/edm_pairwise.py on repro_torch).

Shows the packed output (half the memory), exactness against the O(N^2)
oracle, and the launched-block accounting against the bounding box. On
the card ``edm`` runs the tri_edm.ltm kernel; with --device cpu its plain
PyTorch version.

  PYTHONPATH=src python examples/torch_edm_pairwise.py
  PYTHONPATH=src python examples/torch_edm_pairwise.py --device cpu
"""

import argparse

import torch

from repro_torch import device as DEV
from repro_torch.core import analysis as A
from repro_torch.core import mapping as M
from repro_torch.kernels.tri_edm import ops as E
from repro_torch.kernels.tri_edm import ref as R
from repro_torch.obs import launch as OBS

N, D, BLOCK = 1024, 3, 64


def main(device="cuda"):
    impl = "cuda" if DEV.attn_impl(device) == "cuda" else "torch"
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn((N, D), generator=gen).to(DEV.resolve(device))
    n = N // BLOCK

    # packed LTM EDM: one block per lower-triangle tile
    with OBS.capture() as launches:
        packed = E.edm(x, BLOCK, impl=impl)
    (meta, _), = launches
    assert meta.name == "tri_edm.ltm" and meta.impl == impl
    assert meta.tiles_launched == M.tri(n) and meta.tiles_bb == n * n
    print(f"packed output: {tuple(packed.shape)} = T(n={n}) x {BLOCK} x "
          f"{BLOCK} ({packed.numel() * 4 / 2**20:.1f} MiB vs full "
          f"{N * N * 4 / 2**20:.1f} MiB), {meta.tiles_launched} blocks "
          f"launched ({impl})")

    # exactness vs oracle
    full = R.unpack_tri(packed, N)
    ref = R.edm_full(x)
    err = float((torch.tril(full) - torch.tril(ref)).abs().max())
    print(f"max |err| vs O(N^2) oracle: {err:.2e}")
    assert err < 1e-4

    # the paper's block accounting
    stats = A.strategy_stats(n)
    for key in ("bb", "ltm", "rb", "utm"):
        s = stats[key]
        print(f"  {key:4s} launched={s.launched:5d} wasted={s.wasted:5d} "
              f"block-ratio vs BB={s.block_ratio_vs_bb:.3f}")
    assert stats["ltm"].launched == meta.tiles_launched
    lam = M.tri(n) - 1
    print(f"g({lam}) = {M.ltm_map(lam)}  (last block -> row n-1, col n-1)")
    print("edm_pairwise OK")
    return {"shape": tuple(packed.shape), "launched": meta.tiles_launched,
            "stats": {key: (s.launched, s.wasted, s.block_ratio_vs_bb)
                      for key, s in stats.items()},
            "last": tuple(M.ltm_map(lam))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernel; cpu: its plain version")
    main(ap.parse_args().device)
