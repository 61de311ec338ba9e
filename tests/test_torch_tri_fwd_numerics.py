"""The numerics of the bf16 tensor-core tile body (csrc/attn_mma.cuh) against
the reference's kernels.

The tile body of ``tri_fwd`` and ``fwd_bb`` on the card computes, per key
tile: S in f32, scaled, the token mask writing the finite MASK_VALUE, the
row max over the tile and the running max, p = exp2((s - m) log2 e) with
log2 e applied to the difference (after the mask), l summed from the f32
p, and P rounded to bf16 before the PV product. ``_tc_tile`` below does
that in plain torch; ``_tc_fwd`` walks a row's tiles in the reference's
order as ``tri_fwd`` does, ``_tc_fwd_bb`` computes each live tile's partial
from a fresh state and merges a row's partials in ascending j as
``fwd_bb`` does. The same numpy inputs in bf16 go through the reference's
``fwd`` and ``fwd_bb`` (Pallas in interpret mode, as their own tests run
them), for ltm, band, a 3-token band (whole tile rows masked) and prefix
schedules at blk 16 and 64, D 64 and 128, at the bf16 attention tolerance
of tests/oracles.py. MASK_VALUE * log2 e overflows in float32, which is
why the body never folds log2 e into the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_attn.kernel import MASK_VALUE

torch.set_num_threads(2)

LOG2E = float(np.float32(np.log2(np.e)))
# window / prefix (tokens) of each kind at tile edge blk
KINDS = {"ltm": lambda blk: (None, 0), "band": lambda blk: (blk + 5, 0),
         "band_short": lambda blk: (3, 0), "prefix": lambda blk: (None, blk + 3)}
GEOMS = [(16, 64), (16, 128), (64, 64), (64, 128)]  # (blk, D)


def _token_mask(i, j, blk, win, pre):
    ar = torch.arange(blk)
    qp = i * blk + ar[:, None]
    kp = j * blk + ar[None, :]
    m = (kp <= qp) & ((qp - kp) < (win if win else 2 ** 30))
    return m | (kp < pre)


def _tc_tile(qi, kj, vj, mask, m, l, acc, scale):
    """One key tile of the tensor-core body: f32 (B, H, blk, ...) tensors;
    returns the new (m, l, acc)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qi, kj) * scale
    s = torch.where(mask, s, torch.tensor(MASK_VALUE, dtype=torch.float32))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp2((m - m_new) * LOG2E)
    p = torch.exp2((s - m_new[..., None]) * LOG2E)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vj)
    return m_new, l, acc


def _fresh(q, blk):
    b, h, _, d = q.shape
    return (torch.full((b, h, blk), MASK_VALUE, dtype=torch.float32),
            torch.zeros((b, h, blk), dtype=torch.float32),
            torch.zeros((b, h, blk, d), dtype=torch.float32))


def _kv_heads(q, k, v):
    g = q.shape[1] // k.shape[1]
    return (x.float().repeat_interleave(g, dim=1) for x in (k, v))


def _tc_fwd(q, k, v, sched, scale):
    """tri_fwd's walk: row i over [first_col, last_col] in order."""
    blk, win, pre = sched.bq, sched.window or 0, sched.prefix
    kf, vf = _kv_heads(q, k, v)
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    lse = torch.empty(q.shape[:3], dtype=torch.float32)
    for i in range(sched.n):
        rows = slice(i * blk, (i + 1) * blk)
        m, l, acc = _fresh(q, blk)
        for j in range(max(0, i - sched.w_b + 1), max(i, sched.p_b - 1) + 1):
            cols = slice(j * blk, (j + 1) * blk)
            m, l, acc = _tc_tile(q[:, :, rows].float(), kf[:, :, cols],
                                 vf[:, :, cols],
                                 _token_mask(i, j, blk, win, pre), m, l, acc,
                                 scale)
        out[:, :, rows] = (acc / l[..., None]).to(torch.bfloat16)
        lse[:, :, rows] = m + torch.log(l)
    return out, lse


def _tc_fwd_bb(q, k, v, sched, scale):
    """fwd_bb: every live tile (j <= i) its own partial, merged in
    ascending j."""
    blk, win = sched.bq, sched.window or 0
    kf, vf = _kv_heads(q, k, v)
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    lse = torch.empty(q.shape[:3], dtype=torch.float32)
    for i in range(sched.n):
        rows = slice(i * blk, (i + 1) * blk)
        m_run, l_run, acc = _fresh(q, blk)
        for j in range(i + 1):
            cols = slice(j * blk, (j + 1) * blk)
            m_j, l_j, o_j = _tc_tile(q[:, :, rows].float(), kf[:, :, cols],
                                     vf[:, :, cols],
                                     _token_mask(i, j, blk, win, 0),
                                     *_fresh(q, blk), scale)
            m_new = torch.maximum(m_run, m_j)
            w_run, w_j = torch.exp(m_run - m_new), torch.exp(m_j - m_new)
            l_run = l_run * w_run + l_j * w_j
            acc = acc * w_run[..., None] + o_j * w_j[..., None]
            m_run = m_new
        out[:, :, rows] = (acc / l_run[..., None]).to(torch.bfloat16)
        lse[:, :, rows] = m_run + torch.log(l_run)
    return out, lse


def _case(kind, blk, d, seed):
    b, h, hkv, n = 1, 2, 1, 3
    s = n * blk
    rng = np.random.default_rng(seed + blk + d)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]
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


def _check(got, want):
    out, lse = got
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    O.assert_close(_np(out), _np(want[0]), "attn", jnp.bfloat16, "out")
    O.assert_close(_np(lse), _np(want[1]), "attn", jnp.bfloat16, "lse")


@pytest.mark.parametrize("blk,d", GEOMS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tensor_core_walk_matches_reference_fwd(kind, blk, d):
    (jq, jk, jv), (q, k, v), jsched, sched = _case(kind, blk, d, 0)
    want = JK.fwd(jq, jk, jv, jsched, interpret=True)
    _check(_tc_fwd(q, k, v, sched, d ** -0.5), want)


@pytest.mark.parametrize("blk,d", GEOMS)
@pytest.mark.parametrize("kind", ["band", "band_short", "ltm"])
def test_tensor_core_partials_match_reference_fwd_bb(kind, blk, d):
    (jq, jk, jv), (q, k, v), jsched, sched = _case(kind, blk, d, 1)
    want = JK.fwd_bb(jq, jk, jv, jsched, interpret=True)
    _check(_tc_fwd_bb(q, k, v, sched, d ** -0.5), want)


def test_mask_value_times_log2e_overflows_float32():
    """Folding log2 e into the scale before the mask would turn a fully
    masked row (every s = MASK_VALUE, m = MASK_VALUE) into NaN; applied to
    the difference, the row keeps the reference's p = 1, l = blk."""
    mask = torch.tensor(MASK_VALUE, dtype=torch.float32)
    assert torch.isinf(mask * LOG2E) and mask * LOG2E < 0
    with np.errstate(over="ignore"):
        assert np.isneginf(np.float32(MASK_VALUE) * np.float32(LOG2E))
    s = torch.full((4,), MASK_VALUE, dtype=torch.float32)
    folded = torch.exp2(s * LOG2E - s.amax() * LOG2E)
    assert torch.isnan(folded).all()
    p = torch.exp2((s - s.amax()) * LOG2E)
    assert torch.equal(p, torch.ones(4)) and float(p.sum()) == 4.0


@pytest.mark.parametrize("dtype,blk,body", [
    (torch.bfloat16, 16, "mma.sync"), (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "fma_f32")])
def test_tile_body_by_dtype_and_edge(dtype, blk, body):
    from repro_torch.kernels.tri_attn import kernel as K

    assert K.tile_body(dtype, blk) == body
