"""The numerics and the owners of the bf16 tensor-core packed forward
(csrc/packed_fwd.cu and the prefill half of csrc/fused_step.cu, on
csrc/attn_mma.cuh's row_tile) against the reference's kernels.

``packed_fwd`` and the fused step's prefill half on the card run the body
of ``tri_fwd`` (tests/test_torch_tri_fwd_numerics.py emulates its tile:
``_tc_tile``) on each owner of a pack, one packed q-row tile of one head:
the owner finds its member over the tile-row offsets of its table (the
(7, R) table's row 1, or the fused (8, R) table's q_off row over its
prefill columns), walks the member-local lambdas of its row through the
member map from the row's segment origin, reads Q at the member's first
tile row row0 + i and K, V at row0 + j, masks by the member-local token
positions (the reference's ``_packed_token_mask``) and rounds P to bf16
for the PV product. ``_tc_packed`` below does that in plain torch; the
same numpy inputs in bf16 go through the reference's ``packed_fwd`` and
``fused_step_fwd`` (Pallas in interpret mode, as their own tests run
them; the fused round with live decode members in its table) on the
packed backward numerics test's mixed zoo (ltm, prefix, band and a
3-token band member of 5, 2, 3 and 1 tiles) at blk 16 and 64, D 64 and
128, g 1 and 4, at the bf16 attention tolerance of tests/oracles.py. The walk over the pack is held bitwise
equal to the dense emulation of each member alone, which is what the
kernels' shared body makes true on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro_torch.core import packing as PK
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from test_torch_packed_bwd_numerics import _zoo
from test_torch_tri_fwd_numerics import _fresh, _kv_heads, _tc_fwd, _tc_tile, \
    _token_mask

torch.set_num_threads(2)

GEOMS = [(16, 64), (16, 128), (64, 64), (64, 128)]  # (blk, D)
GROUPS = [(1, 2), (4, 1)]  # (g, Hkv)


def _tc_packed(q, k, v, members, rows, scale):
    """The owners of packed_fwd over members whose first tile rows are
    ``rows``: each packed tile row's member found by the search over
    ``rows``, its row walked through the member map at row0. Returns (out
    in bf16, lse in f32)."""
    blk = members[0].bq
    kf, vf = _kv_heads(q, k, v)
    out = torch.full(q.shape, float("nan"), dtype=torch.bfloat16)
    lse = torch.full(q.shape[:3], float("nan"), dtype=torch.float32)
    for tile in range(sum(m.n for m in members)):
        r = int(np.searchsorted(rows, tile, side="right")) - 1
        m, row0 = members[r], int(rows[r])
        i = tile - row0
        at = slice(tile * blk, (tile + 1) * blk)
        lam0 = int(PK.segment_origin_params(i, m.w_b, m.p_b))
        state = _fresh(q, blk)
        for s in range(m.rm_last_col(i) - m.rm_first_col(i) + 1):
            ti, tj = (int(x) for x in PK.member_map_params(lam0 + s, m.n,
                                                           m.w_b, m.p_b))
            assert ti == i, (m, i, s)
            cols = slice((row0 + tj) * blk, (row0 + tj + 1) * blk)
            state = _tc_tile(q[:, :, at].float(), kf[:, :, cols],
                             vf[:, :, cols],
                             _token_mask(ti, tj, blk, m.window or 0,
                                         m.prefix), *state, scale)
        m_run, l_run, acc = state
        out[:, :, at] = (acc / l_run[..., None]).to(torch.bfloat16)
        lse[:, :, at] = m_run + torch.log(l_run)
    return out, lse


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _assert_members_alone(got, q, k, v, psched, scale):
    """Each member's rows of the packed walk are the dense walk of the
    member alone (tri_fwd at row0 0), bit for bit."""
    blk, row0 = psched.blk, 0
    for m in psched.members:
        at = slice(row0 * blk, (row0 + m.n) * blk)
        alone = _tc_fwd(q[:, :, at], k[:, :, at], v[:, :, at], m, scale)
        for x, a, name in zip(got, alone, ("out", "lse")):
            assert torch.equal(x[:, :, at], a), (name, m)
        row0 += m.n


@pytest.mark.parametrize("g,hkv", GROUPS)
@pytest.mark.parametrize("blk,d", GEOMS)
def test_packed_tensor_core_walk_matches_reference(blk, d, g, hkv):
    jps, tps = _zoo(blk, JOPS.make_packed_sched), _zoo(blk,
                                                       OPS.make_packed_sched)
    h, s = g * hkv, tps.s_total
    arrs = _inputs(((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d)),
                   blk + d + g)
    want = JK.packed_fwd(*(jnp.asarray(x, jnp.bfloat16) for x in arrs), jps,
                         interpret=True)
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16) for x in arrs)
    scale = d ** -0.5
    got = _tc_packed(q, k, v, tps.members, tps.table()[1], scale)
    for x, w, name in zip(got, want, ("out", "lse")):
        assert tuple(x.shape) == w.shape, name
        assert torch.isfinite(x.float()).all(), name  # every owner wrote
        O.assert_close(_np(x), _np(w), "attn", jnp.bfloat16, name)
    _assert_members_alone(got, q, k, v, tps, scale)


@pytest.mark.parametrize("g,hkv", GROUPS)
@pytest.mark.parametrize("blk,d", [(16, 64), (64, 128)])
def test_fused_prefill_half_matches_reference(blk, d, g, hkv):
    """The fused step's prefill owners, found over the (8, R) table's
    q_off row with live decode members after the prefill columns, against
    the pack output of the reference's fused_step_fwd; and equal, bit for
    bit, to the packed walk over the (7, R) table of the same pack, which
    the card holds the fused kernel's prefill half to."""
    jps, tps = _zoo(blk, JOPS.make_packed_sched), _zoo(blk,
                                                       OPS.make_packed_sched)
    b, h, s, s_cache = 5, g * hkv, tps.s_total, 4 * blk
    kv_lens, slots = [4 * blk, 3, 2 * blk + 5], [0, 2, 3]
    n_members = len(tps.members) + b + 1
    kw = dict(blk=blk, n_members=n_members, n_slots=b, s_cache=s_cache)
    jtbl, needed = JOPS.make_fused_table(jps, kv_lens, slots, **kw)
    tbl, t_needed = OPS.make_fused_table(tps, kv_lens, slots, **kw)
    assert t_needed == needed and tbl.tobytes() == jtbl.tobytes()
    assert needed > tps.steps  # live decode tiles in the round
    arrs = _inputs(((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d), (b, h, d),
                    (b, s_cache, hkv, d), (b, s_cache, hkv, d)), blk + d + g)
    jin = [jnp.asarray(x, jnp.bfloat16) for x in arrs[:4]] + \
        [jnp.asarray(x) for x in arrs[4:]] + [jnp.asarray(jtbl)]
    spec = JOPS.FusedStepSpec(n_members=n_members, capacity=needed,
                              blk=blk, impl="pallas")
    want_pack, _ = JOPS.fused_step_attention(*jin, jps, spec)
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16) for x in arrs[:3])
    scale = d ** -0.5
    r_p = len(tps.members)
    assert (tbl[1, :r_p] == 0).all() and (tbl[1, r_p:] == 1).all()
    got, _ = _tc_packed(q, k, v, tps.members, tbl[5, :r_p], scale)
    assert torch.isfinite(got.float()).all()
    O.assert_close(_np(got), _np(want_pack), "attn", jnp.bfloat16, "pack")
    packed, _ = _tc_packed(q, k, v, tps.members, tps.table()[1], scale)
    assert torch.equal(got, packed)


@pytest.mark.parametrize("kernel", ["packed_fwd", "fused_step_fwd"])
@pytest.mark.parametrize("dtype,blk,body", [
    (torch.bfloat16, 16, "mma.sync"), (torch.bfloat16, 32, "mma.sync"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "fma_f32")])
def test_tile_body_of_the_packed_and_fused_kernels(kernel, dtype, blk, body):
    """packed_fwd and the fused step's prefill half run the forward body
    of tri_fwd: tile_body(dtype, blk, "fwd")."""
    assert K.tile_body(dtype, blk, "fwd") == body
