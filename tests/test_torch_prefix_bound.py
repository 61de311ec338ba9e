"""A prefix at least as long as its sequence: every key is visible.

``TriSched.p_b`` is bounded by the member's n tiles, so a dense or packed
prefix-causal schedule whose prefix runs past its sequence gives
``impl="ref"``'s output and grads (the full-softmax oracle, here and in
the JAX package) instead of walking key tiles past the member. The tile
counts stay the reference's (its ``prefix_full_blocks`` clamps); only
the member table's p_b row differs where the prefix ran past. The
reference keeps its fault (its scan is off; a tested deliberate
difference), and every attention wrapper refuses a schedule whose p_b
exceeds n before it launches anything.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import ops as JOPS
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS

torch.set_num_threads(2)

B, H, HKV, D, BLK = 1, 4, 2, 16, 16


def _qkv(s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, s, D), (B, HKV, s, D), (B, HKV, s, D))]


def _fwd_bwd(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.as_tensor(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("prefix", [64, 100])
def test_dense_prefix_past_length_matches_ref(prefix):
    q, k, v = _qkv(64, prefix)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    sched = OPS.make_sched(64, block=BLK, prefix=prefix)
    assert (sched.n, sched.p_b) == (4, 4)
    got, got_g = _fwd_bwd(lambda *t: OPS.triangular_attention(
        *t, prefix=prefix, impl="torch", block=BLK), (q, k, v), g)
    want, want_g = _fwd_bwd(lambda *t: OPS.triangular_attention(
        *t, prefix=prefix, impl="ref"), (q, k, v), g)
    O.assert_close(got, want, "attn")
    for a, b in zip(got_g, want_g):
        O.assert_close(a, b, "attn_grad")
    # the JAX package's oracle, and its grads, on the same inputs
    jref = lambda *t: JOPS.triangular_attention(*t, prefix=prefix,
                                                impl="ref")
    jq = [jnp.asarray(a) for a in (q, k, v)]
    O.assert_close(got, np.asarray(jref(*jq)), "attn")
    jg = jax.grad(lambda *t: jnp.sum(jref(*t) * jnp.asarray(g)),
                  argnums=(0, 1, 2))(*jq)
    for a, b in zip(got_g, jg):
        O.assert_close(a, np.asarray(b), "attn_grad")
    # every key visible: plain softmax attention over the whole sequence
    O.assert_close(got, O.attention_oracle(q, k, v, prefix=64), "attn")


def test_packed_prefix_past_member_matches_ref():
    """Members of 32 and 64 tokens, member prefix (48, 0): the first
    member attends all its own keys and none of the second's."""
    lens, prefix = [32, 64], [48, 0]
    q, k, v = _qkv(96, 7)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    psched = OPS.make_packed_sched(lens, block=BLK, prefix=prefix)
    assert [(m.n, m.p_b) for m in psched.members] == [(2, 2), (4, 0)]
    run = lambda impl: _fwd_bwd(lambda *t: OPS.packed_prefill_attention(
        *t, psched, impl=impl), (q, k, v), g)
    got, got_g = run("torch")
    want, want_g = run("ref")
    O.assert_close(got, want, "attn")
    for a, b in zip(got_g, want_g):
        O.assert_close(a, b, "attn_grad")
    jps = JOPS.make_packed_sched(lens, block=BLK, prefix=prefix)
    O.assert_close(got, np.asarray(JOPS.packed_prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jps, impl="ref")), "attn")
    # the table differs from the reference's only in the clamped p_b
    gt, wt = psched.table(), jps.table()
    assert (gt[4] == [2, 0]).all() and (wt[4] == [3, 0]).all()
    assert np.array_equal(np.delete(gt, 4, 0), np.delete(wt, 4, 0))
    assert psched.steps == jps.steps


@pytest.mark.parametrize("prefix", [48, 64, 100])
def test_tile_counts_stay_the_references(prefix):
    jsched = JOPS.make_sched(64, block_q=BLK, block_k=BLK, prefix=prefix)
    sched = OPS.make_sched(64, block=BLK, prefix=prefix)
    assert sched.rm_steps == sched.cm_steps == jsched.rm_steps
    host = {sched.rm_map(lam) for lam in range(sched.rm_steps)}
    assert host == {(i, j) for i in range(4) for j in range(4)
                    if j <= i or j < sched.p_b}
    cm = {sched.cm_map(lam) for lam in range(sched.cm_steps)}
    assert cm == host


def test_reference_keeps_its_fault():
    """The JAX package is untouched: its scan walks column tiles past n
    at prefix 100 and misses its own oracle, where the port agrees."""
    q, k, v = (jnp.asarray(a) for a in _qkv(64, 100))
    want = np.asarray(JOPS.triangular_attention(q, k, v, prefix=100,
                                                impl="ref"))
    scan = np.asarray(JOPS.triangular_attention(q, k, v, prefix=100,
                                                impl="scan", block_q=BLK,
                                                block_k=BLK))
    assert np.abs(scan - want).max() > 0.1


class _StaleSched(K.TriSched):
    """A schedule built without the bound: p_b = ceil(prefix / bk)."""

    @property
    def p_b(self) -> int:
        return -(-self.prefix // self.bk) if self.prefix else 0


def test_wrappers_refuse_prefix_width_past_n():
    stale = _StaleSched(kind="prefix", n=4, bq=BLK, bk=BLK, prefix=100)
    assert stale.p_b == 7
    good = OPS.make_packed_sched([32], block=BLK)
    pstale = dataclasses.replace(good, members=(
        _StaleSched(kind="prefix", n=2, bq=BLK, bk=BLK, prefix=48),))
    q, k, v = (torch.as_tensor(a) for a in _qkv(64, 3))
    qp, kp, vp = (x[:, :, :32].contiguous() for x in (q, k, v))
    lse = torch.zeros((B, H, 64))
    calls = {
        "fwd": lambda: K.fwd(q, k, v, stale),
        "bwd_dq": lambda: K.bwd_dq(q, k, v, q, lse, lse, stale),
        "bwd_dkv": lambda: K.bwd_dkv(q, k, v, q, lse, lse, stale),
        "packed_fwd": lambda: K.packed_fwd(qp, kp, vp, pstale),
        "packed_bwd_dq": lambda: K.packed_bwd_dq(
            qp, kp, vp, qp, lse[..., :32], lse[..., :32], pstale),
        "packed_bwd_dkv": lambda: K.packed_bwd_dkv(
            qp, kp, vp, qp, lse[..., :32], lse[..., :32], pstale),
        "fused_step_fwd": lambda: K.fused_step_fwd(
            qp, kp, vp, q[:, :, 0], k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3), torch.zeros((8, 2), dtype=torch.int32),
            psched=pstale, capacity=2, tiles=1),
    }
    for op, call in calls.items():
        launches = K.WRAPPERS[f"tri_attn.{op}"].launches
        with pytest.raises(ValueError, match=f"{op}: prefix width p_b"):
            call()
        assert K.WRAPPERS[f"tri_attn.{op}"].launches == launches
    K.check_prefix_bound("fwd", OPS.make_sched(64, block=BLK, prefix=100))
