"""The numerics of the bf16 tensor-core backward (csrc/attn_mma_bwd.cuh)
against the reference's kernels.

``tri_bwd_dq`` and ``tri_bwd_dkv`` on the card work in 64 x 64 sub-tiles
(a blk 128 tile is 2 x 2 of them) and compute, per sub-tile: S and dP in
f32, s scaled, the token mask writing the finite MASK_VALUE, p =
exp2((s - lse) log2 e) with log2 e applied to the difference (after the
mask), dS = p (dP - delta) scale in f32 from the f32 p, and P and dS
rounded to bf16 only as the A operands of dQ += dS K, dV += P^T dO and
dK += dS^T Q. dk/dv sum the group's query heads in one f32 accumulator,
where the reference rounds each head's partial to bf16 and sums them
after. ``_tc_dq`` and ``_tc_dkv`` below do that in plain torch, walking
the sub-tiles in the kernels' order; the same numpy inputs in bf16 go
through the reference's ``bwd`` (Pallas in interpret mode, as its own
tests run it), for ltm, band, a 3-token band (whole tile rows masked) and
prefix schedules at blk 64 and 128, D 64 and 128, g 1 and 4, at the bf16
attention tolerance of tests/oracles.py. Last, which body ``tile_body``
names for the backward and the grid the dk/dv fold launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_attn.kernel import MASK_VALUE

torch.set_num_threads(2)

LOG2E = float(np.float32(np.log2(np.e)))
QB = 64  # rows of a sub-tile: wgmma's M
# window / prefix (tokens) of each kind at tile edge blk
KINDS = {"ltm": lambda blk: (None, 0), "band": lambda blk: (blk + 5, 0),
         "band_short": lambda blk: (3, 0), "prefix": lambda blk: (None, blk + 3)}
GEOMS = [(64, 64), (64, 128), (128, 64), (64, 192)]  # (blk, D)
GROUPS = [(1, 2), (4, 1)]  # (g, Hkv)
NEMOTRON_GROUP = (12, 1)  # at D 192


def _mask(qp0, kp0, win, pre):
    """The reference's token mask of the sub-tile at member positions
    [qp0, qp0 + QB) x [kp0, kp0 + QB)."""
    qp = qp0 + torch.arange(QB)[:, None]
    kp = kp0 + torch.arange(QB)[None, :]
    m = (kp <= qp) & ((qp - kp) < (win if win else 2 ** 30))
    return m | (kp < pre)


def _p_ds(qs, ks, vs, dos, lse, dlt, mask, scale):
    """P and dS of one sub-tile: f32 (..., QB, QB), queries by keys."""
    s = torch.einsum("...qd,...kd->...qk", qs, ks) * scale
    s = torch.where(mask, s, torch.tensor(MASK_VALUE, dtype=torch.float32))
    p = torch.exp2((s - lse[..., None]) * LOG2E)
    dp = torch.einsum("...qd,...kd->...qk", dos, vs)
    return p, p * (dp - dlt[..., None]) * scale


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tc_dq(q, k, v, do, lse, dlt, sched, scale, rnd=_bf16):
    """tri_bwd_dq: each 64-row sub-row walks j over [first_col, last_col],
    each tile's 64-key sub-tiles in turn; dQ += bf16(dS) K (``rnd`` is the
    rounding of the A operand)."""
    blk, win, pre = sched.bq, sched.window or 0, sched.prefix
    g = q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    dq = torch.empty(q.shape, dtype=torch.bfloat16)
    for i in range(sched.n):
        for sub in range(blk // QB):
            qp0 = i * blk + QB * sub
            rows = slice(qp0, qp0 + QB)
            acc = torch.zeros(q.shape[:2] + (QB, q.shape[-1]))
            for j in range(max(0, i - sched.w_b + 1),
                           max(i, sched.p_b - 1) + 1):
                for half in range(blk // QB):
                    kp0 = j * blk + QB * half
                    cols = slice(kp0, kp0 + QB)
                    _, ds = _p_ds(q[:, :, rows].float(), kf[:, :, cols],
                                  vf[:, :, cols], do[:, :, rows].float(),
                                  lse[:, :, rows], dlt[:, :, rows],
                                  _mask(qp0, kp0, win, pre), scale)
                    acc = acc + rnd(ds) @ kf[:, :, cols]
            dq[:, :, rows] = acc.to(torch.bfloat16)
    return dq


def _tc_dkv(q, k, v, do, lse, dlt, sched, scale, rnd=_bf16):
    """tri_bwd_dkv: each 64-key half of column j walks the group's heads,
    rows over [cm_first_row(j), cm_last_row(j)] and their 64-row chunks;
    dV += bf16(P)^T dO and dK += bf16(dS)^T Q, the heads in one f32
    accumulator."""
    blk, win, pre = sched.bq, sched.window or 0, sched.prefix
    b, hkv, _, d = k.shape
    g = q.shape[1] // hkv
    qg, dog = (x.float().reshape(b, hkv, g, -1, d) for x in (q, do))
    lg, dg = (x.reshape(b, hkv, g, -1) for x in (lse, dlt))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(sched.n):
        first, last = sched.cm_first_row(j), sched.cm_last_row(j)
        for half in range(blk // QB):
            kp0 = j * blk + QB * half
            cols = slice(kp0, kp0 + QB)
            kj, vj = k[:, :, None, cols].float(), v[:, :, None, cols].float()
            acc_k = torch.zeros((b, hkv, QB, d))
            acc_v = torch.zeros_like(acc_k)
            for gi in range(g):
                for qp0 in range(first * blk, (last + 1) * blk, QB):
                    rows = slice(qp0, qp0 + QB)
                    qs, dos = qg[:, :, gi, rows], dog[:, :, gi, rows]
                    p, ds = _p_ds(qs, kj[:, :, 0], vj[:, :, 0], dos,
                                  lg[:, :, gi, rows], dg[:, :, gi, rows],
                                  _mask(qp0, kp0, win, pre), scale)
                    acc_v = acc_v + rnd(p).transpose(-1, -2) @ dos
                    acc_k = acc_k + rnd(ds).transpose(-1, -2) @ qs
            dk[:, :, cols] = acc_k.to(k.dtype)
            dv[:, :, cols] = acc_v.to(v.dtype)
    return dk, dv


def _case(kind, blk, d, g, hkv, seed=0):
    b, n = 1, 3
    h, s = g * hkv, n * blk
    rng = np.random.default_rng(seed + blk + d + g)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d))]
    window, prefix = KINDS[kind](blk)
    jsched = JOPS.make_sched(s, block_q=blk, block_k=blk, window=window,
                             prefix=prefix)
    sched = OPS.make_sched(s, block=blk, window=window, prefix=prefix)
    return ([jnp.asarray(x, jnp.bfloat16) for x in arrs],
            [torch.as_tensor(x).to(torch.bfloat16) for x in arrs], jsched,
            sched)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("g,hkv", GROUPS)
@pytest.mark.parametrize("blk,d", GEOMS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tensor_core_backward_matches_reference_bwd(kind, blk, d, g, hkv):
    (jq, jk, jv, jdo), (q, k, v, do), jsched, sched = _case(kind, blk, d, g,
                                                            hkv)
    jout, jlse = JK.fwd(jq, jk, jv, jsched, interpret=True)
    want = JK.bwd(jq, jk, jv, jout, jlse, jdo, jsched, interpret=True)
    out = torch.from_numpy(_np(jout).copy()).to(torch.bfloat16)
    lse = torch.from_numpy(_np(jlse).copy())
    dlt = (do.float() * out.float()).sum(dim=-1)
    scale = d ** -0.5
    got = (_tc_dq(q, k, v, do, lse, dlt, sched, scale),
           *_tc_dkv(q, k, v, do, lse, dlt, sched, scale))
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == torch.bfloat16 and tuple(x.shape) == w.shape, name
        assert torch.isfinite(x.float()).all(), name
        O.assert_close(_np(x), _np(w), "attn", jnp.bfloat16, name)

def _f32(x):
    return jnp.asarray(x, jnp.float32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tensor_core_backward_at_nemotrons_group(kind):
    """nemotron-4's group (96 query heads over 8 kv heads: g 12) at its
    head dim, against the reference's interpret-mode ``fwd`` and ``bwd``
    run in float32 on the same bf16 values. Its bf16 run rounds each of
    the 12 query heads' dk/dv partials to bf16 before summing them, which
    alone moves a few elements past the bf16 attention tolerance (ROADMAP
    C); the kernels sum the group in f32, as the float32 run does."""
    (jq, jk, jv, jdo), (q, k, v, do), jsched, sched = _case(
        kind, 64, 192, *NEMOTRON_GROUP)
    jq, jk, jv, jdo = (_f32(x) for x in (jq, jk, jv, jdo))
    jout, jlse = JK.fwd(jq, jk, jv, jsched, interpret=True)
    want = JK.bwd(jq, jk, jv, jout, jlse, jdo, jsched, interpret=True)
    out = torch.from_numpy(_np(jout).copy()).to(torch.bfloat16)
    lse = torch.from_numpy(_np(jlse).copy())
    dlt = (do.float() * out.float()).sum(dim=-1)
    scale = 192 ** -0.5
    got = (_tc_dq(q, k, v, do, lse, dlt, sched, scale),
           *_tc_dkv(q, k, v, do, lse, dlt, sched, scale))
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == torch.bfloat16 and tuple(x.shape) == w.shape, name
        O.assert_close(_np(x), _np(w), "attn", jnp.bfloat16, name)


def test_bf16_p_and_ds_are_what_moves_the_grads():
    """The wgmma backward's grads differ from the port's plain version
    (scan_impl, f32 P and dS) by the rounding of P and dS to bf16 alone:
    the emulation without that rounding meets the plain version within
    chip_smoke.py's OUT_TOL (outputs one bf16 step apart at most), with it
    the grads move further, within the bf16 grad tolerance of the card
    tests (GRAD_TOL, tests/test_torch_cuda.py), which chip_smoke.py holds
    the bf16 wgmma backward to. A band of blk + 5 tokens, blk 64, D 128,
    g 4: few live keys a query, so P and dS are large and their terms
    cancel in dK."""
    from repro_torch.kernels.tri_attn import scan_impl as SC

    blk, d, g, n = 64, 128, 4, 4
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in
        ((1, g, n * blk, d), (1, 1, n * blk, d), (1, 1, n * blk, d),
         (1, g, n * blk, d)))
    sched = OPS.make_sched(n * blk, block=blk, window=blk + 5)
    scale = d ** -0.5
    out, lse = SC.fwd_torch(q, k, v, sched, scale)
    dlt = (do.float() * out.float()).sum(dim=-1)
    plain = (SC.dq_torch(q, k, v, do, lse, dlt, sched, scale),
             *SC.dkv_torch(q, k, v, do, lse, dlt, sched, scale))
    exact = (_tc_dq(q, k, v, do, lse, dlt, sched, scale, rnd=lambda x: x),
             *_tc_dkv(q, k, v, do, lse, dlt, sched, scale, rnd=lambda x: x))
    rounded = (_tc_dq(q, k, v, do, lse, dlt, sched, scale),
               *_tc_dkv(q, k, v, do, lse, dlt, sched, scale))
    errs = {}
    for name, got in (("exact", exact), ("rounded", rounded)):
        errs[name] = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(got, plain))
        tol = dict(atol=4e-3, rtol=1e-2) if name == "exact" \
            else dict(atol=2e-2, rtol=2e-2)
        for a, b, grad in zip(got, plain, ("dq", "dk", "dv")):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       err_msg=f"{name} {grad}", **tol)
    assert errs["rounded"] > errs["exact"], errs


def test_masked_p_is_zero_without_folding_log2e():
    """A masked pair gives p = exp2((MASK_VALUE - lse) log2 e): the product
    overflows to -inf and p is exactly 0, the reference's exp(MASK_VALUE -
    lse), so dS is 0 too."""
    lse = torch.tensor([-3.0, 0.0, 7.5])
    s = torch.full((3,), MASK_VALUE, dtype=torch.float32)
    p = torch.exp2((s - lse) * LOG2E)
    assert torch.equal(p, torch.zeros(3))
    assert torch.equal(torch.exp(s - lse), p)
    assert torch.equal(p * (torch.tensor(2.0) - lse) * 0.125, torch.zeros(3))


@pytest.mark.parametrize("dtype,blk,body", [
    (torch.bfloat16, 16, "fma_f32"), (torch.bfloat16, 32, "fma_f32"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "fma_f32"), (torch.float32, 128, "fma_f32")])
def test_tile_body_of_the_backward(dtype, blk, body):
    assert K.tile_body(dtype, blk, "bwd") == body
    with pytest.raises(ValueError, match="op must be fwd or bwd"):
        K.tile_body(dtype, blk, "dq")


@pytest.mark.parametrize("s,blk,dtype,dq_grid,dkv_grid", [
    # the training attention: 64 q-row blocks a head, 32 column pairs
    (4096, 64, torch.bfloat16, (64, 32, 1), (32, 4, 1)),
    # blk 128: two 64-row blocks a row tile, two 64-key blocks a pair
    (640, 128, torch.bfloat16, (10, 32, 1), (6, 4, 1)),
    # the CUDA-core bodies: one block a row tile, one a column pair
    (640, 128, torch.float32, (5, 32, 1), (3, 4, 1)),
    (96, 16, torch.bfloat16, (6, 32, 1), (3, 4, 1))])
def test_bwd_grid_folds_the_columns(s, blk, dtype, dq_grid, dkv_grid):
    sched = OPS.make_sched(s, block=blk)
    assert K.bwd_grid("dq", sched, 32, 1, dtype) == dq_grid
    assert K.bwd_grid("dkv", sched, 4, 1, dtype) == dkv_grid


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", [5, 6, 64])
def test_folded_columns_cover_every_column_once(kind, n):
    """Block `pair` walks column pair, then n - 1 - pair (the middle
    column alone for an odd n): every column exactly once, and for ltm
    every pair walks n + 1 tile rows, so the blocks' work is even."""
    blk = 64
    window, prefix = KINDS[kind](blk)
    sched = OPS.make_sched(n * blk, block=blk, window=window, prefix=prefix)
    walked, rows = [], []
    for pair in range((n + 1) // 2):
        cols = [pair] if 2 * pair + 1 == n else [pair, n - 1 - pair]
        walked += cols
        rows.append(sum(sched.cm_last_row(j) - sched.cm_first_row(j) + 1
                        for j in cols))
    assert sorted(walked) == list(range(n))
    assert sum(rows) == sched.rm_steps
    if kind == "ltm":
        assert rows[:n // 2] == [n + 1] * (n // 2)
