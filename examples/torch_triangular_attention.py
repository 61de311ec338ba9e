"""Direct use of the port's triangular-domain attention: causal (LTM),
sliding-window (band) and VLM prefix-causal (prefix) schedules, held
against the dense oracle, with the tiles each launch walks
(examples/triangular_attention.py on repro_torch).

On the card ``triangular_attention`` runs the tri_attn.fwd kernel and its
backward; with --device cpu their plain PyTorch versions.

  PYTHONPATH=src python examples/torch_triangular_attention.py
  PYTHONPATH=src python examples/torch_triangular_attention.py --device cpu
"""

import argparse

import torch

from repro_torch import device as DEV
from repro_torch.core import mapping as M
from repro_torch.kernels.tri_attn import ops as AO
from repro_torch.kernels.tri_attn import ref as AR
from repro_torch.obs import launch as OBS

B, H, HKV, S, DH, BLK = 2, 8, 2, 512, 64, 128


def main(device="cuda"):
    impl = DEV.attn_impl(device)
    dev = DEV.resolve(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((B, h, S, DH), generator=gen).to(dev)
               for h in (H, HKV, HKV))
    n = S // BLK

    cases = {
        "causal (LTM)": dict(window=None, prefix=0, tiles=M.tri(n)),
        "sliding-window 128 (Band)": dict(window=128, prefix=0,
                                          tiles=M.band_blocks(n, 2)),
        "prefix-causal 128 (Prefix, VLM)": dict(
            window=None, prefix=128, tiles=M.prefix_full_blocks(n, 1)),
    }
    tiles = {}
    for name, c in cases.items():
        with OBS.capture() as launches:
            out = AO.triangular_attention(q, k, v, window=c["window"],
                                          prefix=c["prefix"], impl=impl,
                                          block=BLK)
        ref = AR.mha_reference(q, k, v, window=c["window"],
                               prefix=c["prefix"])
        err = float((out - ref).abs().max())
        assert err < 2e-3, (name, impl, err)
        (meta, _), = launches
        assert meta.name == "tri_attn.fwd" and meta.impl == impl
        assert meta.tiles_launched == c["tiles"] and meta.cells == B * H
        tiles[name] = meta.tiles_launched
        print(f"{name:34s} tiles={c['tiles']:3d} (BB grid: {n * n}) "
              f"max|err|={err:.1e}  [{impl} vs oracle OK]")

    # gradients flow through the autograd Function (dq and dk/dv launches)
    qg = q.clone().requires_grad_()
    with OBS.capture() as launches:
        AO.triangular_attention(qg, k, v, impl=impl, block=BLK).sum() \
            .backward()
    names = sorted(m.name for m, _ in launches)
    assert names == ["tri_attn.bwd_dkv", "tri_attn.bwd_dq",
                     "tri_attn.fwd"], names
    print(f"dq norm through the autograd Function: "
          f"{float(qg.grad.norm()):.3f} (launches: {', '.join(names)})")
    print("triangular_attention OK")
    return {"tiles": tiles, "bb": n * n, "grad_launches": names}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
