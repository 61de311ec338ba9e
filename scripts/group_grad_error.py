"""How the bf16 dk/dv error of the attention backward grows with the query
group g: the wgmma kernels (``tri_attn.bwd``, on a card) and a plain-torch
emulation of their rounding, each against the plain version.

    python3 scripts/group_grad_error.py            # the card if there is one
    python3 scripts/group_grad_error.py --device cpu  # the emulation alone

The inputs are those of the odd-group card tests in
tests/test_torch_cuda.py (``_tri_case``: blk 64, 5 tiles, batch 1, bf16,
ltm and prefix schedules, D 64 and 128). The plain version
(``scan_impl.bwd_torch``) computes P and dS in f32 and sums dk/dv over
the group in f32. The kernels round P and dS to bf16 as the A operands of
dV += P^T dO and dK += dS^T Q, each head's terms in turn, in one f32
accumulator; the emulation does that rounding over whole matrices and
nothing else. Each reading is max |got - plain| / (atol + rtol |plain|) at
the bf16 grad tolerance of the card tests (atol = rtol = 2e-2): 1 is that
tolerance's edge. On a card the packed kernels (``packed_bwd``) are read
too, on the inputs of the odd-group packed test (a 3/2/1-tile
ltm/band/prefix pack), against ``scan_impl.packed_bwd_torch``. Prints
one line a case and, on a card, its name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels.tri_attn import ops as OPS  # noqa: E402
from repro_torch.kernels.tri_attn import scan_impl as SC  # noqa: E402

ATOL = RTOL = 2e-2  # GRAD_TOL[bfloat16] of tests/test_torch_cuda.py
BLK, N = 64, 5
KINDS = {"ltm": (None, 0), "prefix": (None, BLK + 3)}  # (window, prefix)
GROUPS = [(1, 2), (2, 2), (3, 2), (7, 2), (8, 1), (12, 1), (48, 1)]


def case(dev, kind, d, g, hkv):
    """The card tests' ``_tri_case(dev, kind, 64, d, g, hkv, bf16, n=5,
    b=1)``: the same seed and draws."""
    rng = np.random.default_rng(BLK + d + g + hkv + N)
    h, s = g * hkv, N * BLK
    window, prefix = KINDS[kind]
    sched = OPS.make_sched(s, block=BLK, window=window, prefix=prefix)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=dev).to(torch.bfloat16) for shape in
        ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d), (1, h, s, d)))
    return sched, q, k, v, do


def packed_case(dev, d, g, hkv):
    """The odd-group packed test's pack and draws."""
    rng = np.random.default_rng(g + d + 2)
    psched = OPS.make_packed_sched([3 * BLK, 2 * BLK, BLK], block=BLK,
                                   window=[None, BLK + 3, None],
                                   prefix=[0, 0, BLK // 2 + 1])
    s = psched.s_total
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=dev).to(torch.bfloat16) for shape in
        ((1, g * hkv, s, d), (1, hkv, s, d), (1, hkv, s, d),
         (1, g * hkv, s, d)))
    return psched, q, k, v, do


def emulated_dkv(q, k, v, do, lse, delta, sched, scale):
    """dk, dv with P and dS rounded to bf16 before their products and the
    group's heads summed in f32."""
    b, hkv, s, d = k.shape
    g = q.shape[1] // hkv
    qg = q.float().reshape(b, hkv, g, s, d)
    dog = do.float().reshape(b, hkv, g, s, d)
    lg = lse.reshape(b, hkv, g, s, 1)
    dg = delta.reshape(b, hkv, g, s, 1)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = ((kp <= qp) & (qp - kp < (sched.window or 2 ** 30))) | \
        (kp < sched.prefix)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    p = torch.where(mask, torch.exp(qg @ kf.transpose(-1, -2) * scale - lg),
                    0.0)
    ds = p * (dog @ vf.transpose(-1, -2) - dg) * scale
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    dv = (rnd(p).transpose(-1, -2) @ dog).sum(dim=2)
    dk = (rnd(ds).transpose(-1, -2) @ qg).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def ratio(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    dev = torch.device(ap.parse_args().device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels.tri_attn import kernel as K

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    for kind in KINDS:
        for d in (64, 128):
            for g, hkv in GROUPS:
                sched, q, k, v, do = case(dev, kind, d, g, hkv)
                scale = d ** -0.5
                if on_card:
                    out, lse = K.fwd(q, k, v, sched)
                else:
                    out, lse = SC.fwd_torch(q, k, v, sched, scale)
                delta = (do.float() * out.float()).sum(dim=-1)
                _, dk, dv = SC.bwd_torch(q, k, v, out, lse, do, sched, scale)
                edk, edv = emulated_dkv(q, k, v, do, lse, delta, sched,
                                        scale)
                line = (f"{kind} D {d} g {g:2d} Hkv {hkv}: emulation dk "
                        f"{ratio(edk, dk):.3f} dv {ratio(edv, dv):.3f}")
                if on_card:
                    _, kdk, kdv = K.bwd(q, k, v, out, lse, do, sched)
                    line += (f"; kernel dk {ratio(kdk, dk):.3f} dv "
                             f"{ratio(kdv, dv):.3f}")
                print(line, flush=True)
    if not on_card:
        return 0
    for d in (64, 128):
        for g, hkv in GROUPS:
            psched, q, k, v, do = packed_case(dev, d, g, hkv)
            out, lse = K.packed_fwd(q, k, v, psched)
            _, dk, dv = SC.packed_bwd_torch(q, k, v, out, lse, do, psched,
                                            d ** -0.5)
            _, kdk, kdv = K.packed_bwd(q, k, v, out, lse, do, psched)
            print(f"packed D {d} g {g:2d} Hkv {hkv}: kernel dk "
                  f"{ratio(kdk, dk):.3f} dv {ratio(kdv, dv):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
