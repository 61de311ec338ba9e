"""One call of each kernel wrapper of the port (every ``WRAPPERS`` entry) at
a small shape, on any device: the CPU runs the plain version, the card the
kernel, and "meta" the meta branch the dry-run counts with. Inputs come
from a numpy seed. Shared by tests/test_torch_roofline.py (meta against
the CPU) and tests/test_torch_cuda.py (meta against the card)."""

import numpy as np
import torch

from repro_torch.kernels.ssm_scan import kernel as SK
from repro_torch.kernels.tri_3body import kernel as TK
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_edm import kernel as EK
from repro_torch.kernels.wkv_scan import kernel as WK

BLK = 16


def _t(rng, shape, dtype=torch.float32):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           ).to(dtype)


def _attn_inputs(rng, s, dtype, h=4, hkv=2, d=32):
    q, k, v = (_t(rng, (1, n, s, d), dtype) for n in (h, hkv, hkv))
    do = _t(rng, (1, h, s, d), dtype)
    lse = _t(rng, (1, h, s)).abs()
    delta = _t(rng, (1, h, s))
    return q, k, v, do, lse, delta


def _cases(dtype):
    """{launch name: (wrapper, args on the CPU, kwargs)}."""
    rng = np.random.default_rng(29)
    sched = OPS.make_sched(4 * BLK, block=BLK)
    psched = OPS.make_packed_sched([2 * BLK, BLK, 3 * BLK], block=BLK)
    q, k, v, do, lse, delta = _attn_inputs(rng, 4 * BLK, dtype)
    pq, pk, pv, pdo, plse, pdelta = _attn_inputs(rng, psched.s_total, dtype)
    b, h, hkv, d, s_cache = 3, 4, 2, 32, 4 * BLK
    kv_lens = [40, 7, 64]
    tbl, tiles = OPS.make_decode_table(kv_lens, [0, 1, 2], blk=BLK,
                                       n_members=b + 1, n_slots=b,
                                       s_cache=s_cache)
    qd = _t(rng, (b, h, d), dtype)
    kc, vc = (_t(rng, (b, s_cache, hkv, d), dtype) for _ in range(2))
    fpsched = OPS.make_packed_sched([BLK, 2 * BLK], block=BLK)
    ftbl, ftiles = OPS.make_fused_table(fpsched, [30, 12], [0, 2], blk=BLK,
                                        n_members=2 + b + 1, n_slots=b,
                                        s_cache=s_cache)
    fq, fk, fv = (_t(rng, (1, n, fpsched.s_total, d), dtype)
                  for n in (h, hkv, hkv))
    x = _t(rng, (4 * BLK, 3))
    x3 = _t(rng, (128, 3))
    sb, sl, sd, sn = 2, 8, 32, 4
    ssm = (_t(rng, (sb, sl, sd)), _t(rng, (sb, sl, sd)).abs() * 0.1,
           -_t(rng, (sd, sn)).abs(), _t(rng, (sb, sl, sn)),
           _t(rng, (sb, sl, sn)))
    wb, wl, wh, whd = 2, 8, 2, 8
    wkv = tuple(_t(rng, (wb, wl, wh, whd)) for _ in range(3)) + (
        -_t(rng, (wb, wl, wh, whd)).abs(), _t(rng, (wh, whd)))
    return {
        "tri_attn.packed_fwd": (K.packed_fwd, (pq, pk, pv, psched), {}),
        "tri_attn.packed_decode_fwd": (
            K.packed_decode_fwd, (qd, kc, vc, torch.as_tensor(tbl)),
            dict(capacity=tiles, blk=BLK, tiles=tiles)),
        "tri_attn.fused_step_fwd": (
            K.fused_step_fwd, (fq, fk, fv, qd, kc, vc, torch.as_tensor(ftbl)),
            dict(psched=fpsched, capacity=ftiles, tiles=ftiles)),
        "tri_attn.fwd": (K.fwd, (q, k, v, sched), {}),
        "tri_attn.fwd_bb": (K.fwd_bb, (q, k, v, sched), {}),
        "tri_attn.bwd_dq": (K.bwd_dq, (q, k, v, do, lse, delta, sched), {}),
        "tri_attn.bwd_dkv": (K.bwd_dkv, (q, k, v, do, lse, delta, sched),
                             {}),
        "tri_attn.packed_bwd_dq": (
            K.packed_bwd_dq, (pq, pk, pv, pdo, plse, pdelta, psched), {}),
        "tri_attn.packed_bwd_dkv": (
            K.packed_bwd_dkv, (pq, pk, pv, pdo, plse, pdelta, psched), {}),
        "tri_edm.ltm": (EK.edm_ltm, (x, BLK), {}),
        "tri_edm.bb": (EK.edm_bb, (x, BLK), {}),
        "tri_edm.dummy_ltm": (EK.dummy_ltm, (9,), {}),
        "tri_3body.tet": (TK.three_body_tet, (x3, 64), {}),
        "tri_3body.bb3": (TK.three_body_bb3, (x3, 64), {}),
        "tri_3body.dummy_tet": (TK.dummy_tet, (5,), {}),
        "ssm_scan.selective_scan": (SK.selective_scan, ssm, {}),
        "wkv_scan.wkv": (WK.wkv, wkv, {}),
    }


NAMES = sorted(_cases(torch.float32))
DEVICE_ARG = {"tri_edm.dummy_ltm", "tri_3body.dummy_tet"}
WRAPPERS = {**K.WRAPPERS, **EK.WRAPPERS, **TK.WRAPPERS, **SK.WRAPPERS,
            **WK.WRAPPERS}


def call(name: str, device, dtype=torch.float32):
    """Run wrapper ``name`` once on ``device`` (its inputs moved there;
    the attention wrappers in ``dtype``). Returns its outputs as a flat
    tuple of tensors."""
    fn, args, kw = _cases(dtype)[name]
    dev = torch.device(device)
    if name in DEVICE_ARG:
        out = fn(*args, device=dev)
    else:
        args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                     for a in args)
        out = fn(*args, **kw)
    return out if isinstance(out, tuple) else (out,)
