"""Tetrahedral block space on the port: 3-body interactions with tet(n)
launches (examples/tet_3body.py on repro_torch).

The unique TRIPLES of tiles form a discrete tetrahedron
{(i, j, k): k <= j <= i < n}. A 3-D bounding box launches n^3 tile
triples and wastes ~5/6 of them; tet_map launches exactly
n(n+1)(n+2)/6 and, with multiset permutation weights, reproduces the full
symmetric 3-body sum (to f32 roundoff).

On the card ``three_body`` runs the tri_3body.tet kernel, which takes
blocks of 64 or 128 points: the reference's block of 8 is raised to 64
there and its 32 rows scaled alike to 256 (both printed). With --device
cpu the plain PyTorch version runs the reference's sizes.

  PYTHONPATH=src python examples/torch_tet_3body.py
  PYTHONPATH=src python examples/torch_tet_3body.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import device as DEV
from repro_torch.core import mapping as M
from repro_torch.core import schedule as S
from repro_torch.kernels.tri_3body import kernel as TK
from repro_torch.kernels.tri_3body import ops as OPS
from repro_torch.kernels.tri_3body import ref as REF
from repro_torch.obs import launch as OBS

N_ROWS, BLOCK, D = 32, 8, 3  # the reference's sizes


def sizes(device):
    """(n_rows, block): the reference's on the CPU; on the card the block
    raised to the smallest the kernel takes, the rows by the same
    factor."""
    if DEV.attn_impl(device) != "cuda":
        return N_ROWS, BLOCK
    scale = -(-TK.SUPPORTED_BLOCKS[0] // BLOCK)
    print(f"the card's kernel takes blocks {TK.SUPPORTED_BLOCKS}: block "
          f"{BLOCK} -> {BLOCK * scale}, rows {N_ROWS} -> {N_ROWS * scale} "
          f"(x{scale})")
    return N_ROWS * scale, BLOCK * scale


def main(device="cuda"):
    impl = "cuda" if DEV.attn_impl(device) == "cuda" else "torch"
    n_rows, block = sizes(device)
    n = n_rows // block
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((n_rows, D), generator=gen).to(DEV.resolve(device))

    # 1. launch-space accounting
    sched = S.TetrahedralSchedule(n=n)
    bb3 = S.Dense3DSchedule(n=n)
    waste = 1 - bb3.domain_blocks / bb3.num_blocks
    print(f"tiles/side n={n}: tetrahedral launches {sched.num_blocks}, "
          f"BB-3D launches {bb3.num_blocks} ({100 * waste:.1f}% waste)")

    # 2. packed per-triple reductions through the tet launch
    with OBS.capture() as launches:
        packed = OPS.three_body(x, block, impl=impl)
    (meta, _), = launches
    assert meta.name == "tri_3body.tet" and meta.impl == impl
    assert meta.tiles_launched == sched.num_blocks == M.tet(n)
    print(f"packed output: {tuple(packed.shape)} (one reduction per unique "
          f"(i,j,k) tile triple, {impl})")

    # 3. first few triples with their map
    for lam in range(4):
        i, j, k = M.tet_map(lam)
        print(f"  lambda={lam} -> (i,j,k)=({i},{j},{k})  "
              f"s={float(packed[lam, 0]):+.3f}")

    # 4. exactness: weighted unique-tile total == dense einsum over all
    #    n_rows^3 ordered point triples
    total = float(OPS.three_body_total(x, block, impl=impl))
    dense = float(REF.three_body_total_ref(x))
    print(f"weighted total {total:.4f} vs dense einsum {dense:.4f}")
    np.testing.assert_allclose(total, dense, rtol=1e-5)
    print("OK: tet(n) launches reproduce the full 3-body sum")
    return {"n": n, "block": block, "tet": sched.num_blocks,
            "bb3": bb3.num_blocks, "launched": meta.tiles_launched,
            "maps": [tuple(M.tet_map(lam)) for lam in range(4)]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernel; cpu: its plain version")
    main(ap.parse_args().device)
