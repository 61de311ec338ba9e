"""repro_torch packed attention ops == the JAX reference's.

The same numpy inputs go through the reference's packed prefill / decode
(impl="pallas" in interpret mode, and impl="scan") and through the port's
plain PyTorch version (impl="torch", CPU), at the tolerance policy of
tests/oracles.py. The launch telemetry (tile counters) is compared too.
On the CPU, impl="cuda" raises instead of running anything else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro.obs import metrics as JMET
from repro.serve import decode as JD
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.obs import metrics as MET

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _counters(reg, name, impl):
    return {c: reg.counter_value(c, {"name": name, "impl": impl})
            for c in ("launches_total", "tiles_launched_total",
                      "tiles_domain_total", "tiles_bb_total")}


# ltm, prefix (bidirectional prefix of blk + 1 tokens), band, short ltm
def _packed_case(blk):
    lens = [5 * blk, 2 * blk, 3 * blk, blk]
    window = [None, None, blk + 3, None]
    prefix = [0, blk + 1, 0, 0]
    return lens, window, prefix


@pytest.mark.parametrize("g,d,blk,dtype", [
    (1, 16, 8, "float32"), (2, 32, 16, "float32"), (4, 16, 16, "float32"),
    (2, 16, 8, "bfloat16"), (4, 32, 8, "bfloat16"), (1, 32, 16, "bfloat16")])
def test_packed_prefill_matches_reference(g, d, blk, dtype):
    hkv = 2 if g < 4 else 1
    h = g * hkv
    lens, window, prefix = _packed_case(blk)
    jps = JOPS.make_packed_sched(lens, block=blk, window=window,
                                 prefix=prefix)
    tps = OPS.make_packed_sched(lens, block=blk, window=window,
                                prefix=prefix)
    s = tps.s_total
    rng = np.random.default_rng(g * 100 + d + blk)
    jq, tq = _pair(rng.standard_normal((1, h, s, d), np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((1, hkv, s, d), np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((1, hkv, s, d), np.float32), dtype)
    jreg, treg = JMET.Registry(), MET.Registry()
    with JMET.scope(jreg):
        want_out, want_lse = JK.packed_fwd(jq, jk, jv, jps, interpret=True)
        want_scan = JOPS.packed_prefill_attention(jq, jk, jv, jps,
                                                  impl="scan")
    with MET.scope(treg):
        got_out, got_lse = K.packed_fwd(tq, tk, tv, tps)
    tol = O.tol("attn", DTYPES[dtype][0])
    np.testing.assert_allclose(_np(got_out), _np(want_out), **tol)
    np.testing.assert_allclose(_np(got_out), _np(want_scan), **tol)
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), **tol)
    got_ops = OPS.packed_prefill_attention(tq, tk, tv, tps, impl="torch")
    np.testing.assert_array_equal(_np(got_ops), _np(got_out))
    ref = OPS.packed_prefill_attention(tq, tk, tv, tps, impl="ref")
    np.testing.assert_allclose(_np(got_out), _np(ref), **tol)
    # the port counts the same tiles per launch as the reference
    jc = _counters(jreg, "tri_attn.packed_fwd", "pallas")
    tc = _counters(treg, "tri_attn.packed_fwd", "torch")
    assert jc == tc and tc["tiles_domain_total"] == tps.steps * h


@pytest.mark.parametrize("q_dtype,c_dtype,blk", [
    ("float32", "float32", 8), ("bfloat16", "float32", 16),
    ("float32", "bfloat16", 8), ("bfloat16", "bfloat16", 16)])
def test_packed_decode_matches_reference(q_dtype, c_dtype, blk):
    b, h, hkv, d = 6, 4, 2, 16
    s_cache = 8 * blk
    # skewed lengths; slots 1 and 4 retired; slot 3 band-limited
    # (kv_first > 0); two empty member columns (n_members = b + 1 > live)
    kv_lens, slots = [8 * blk, 3, 2 * blk + 5, blk + 1], [0, 2, 3, 5]
    window = [None, None, blk + 2, None]
    n_members = b + 1
    tbl, needed = OPS.make_decode_table(kv_lens, slots, blk=blk,
                                        n_members=n_members, n_slots=b,
                                        s_cache=s_cache, window=window)
    jtbl, jneeded = JOPS.make_decode_table(kv_lens, slots, blk=blk,
                                           n_members=n_members, n_slots=b,
                                           s_cache=s_cache, window=window)
    assert needed == jneeded and tbl.tobytes() == jtbl.tobytes()
    cap = JD.round_capacity(needed)
    rng = np.random.default_rng(blk)
    jq, tq = _pair(rng.standard_normal((b, h, d), np.float32), q_dtype)
    jk, tk = _pair(rng.standard_normal((b, s_cache, hkv, d), np.float32),
                   c_dtype)
    jv, tv = _pair(rng.standard_normal((b, s_cache, hkv, d), np.float32),
                   c_dtype)
    jreg, treg = JMET.Registry(), MET.Registry()
    wants = {}
    with JMET.scope(jreg):
        for impl in ("pallas", "scan"):
            spec = JOPS.DecodeRoundSpec(n_members=n_members, capacity=cap,
                                        blk=blk, impl=impl)
            wants[impl] = JOPS.packed_decode_attention(
                jq, jk, jv, jnp.asarray(jtbl), spec)
    spec = OPS.DecodeRoundSpec(n_members=n_members, capacity=cap, blk=blk,
                               impl="torch", tiles=needed)
    with MET.scope(treg):
        got = OPS.packed_decode_attention(tq, tk, tv, torch.as_tensor(tbl),
                                          spec)
    tol = O.tol("attn", jnp.bfloat16 if "bfloat16" in (q_dtype, c_dtype)
                else jnp.float32)
    for impl, want in wants.items():
        np.testing.assert_allclose(_np(got), _np(want), err_msg=impl, **tol)
    for retired in (1, 4):
        assert torch.count_nonzero(got[retired]) == 0
    # the kernel wrapper's CPU path returns the (B + 1)-row layout
    full = K.packed_decode_fwd(tq, tk, tv, torch.as_tensor(tbl),
                               capacity=cap, blk=blk, tiles=needed)
    assert full.shape == (b + 1, h, d)
    np.testing.assert_array_equal(_np(full[:b]), _np(got))
    # telemetry: the reference's grid walks the bucketed capacity, the
    # port walks only the live tiles (no pad steps); BB bounds agree
    jc = _counters(jreg, "tri_attn.packed_decode_fwd", "scan")
    tc = _counters(treg, "tri_attn.packed_decode_fwd", "torch")
    assert jc["tiles_launched_total"] == cap >= needed
    assert tc["tiles_launched_total"] == tc["tiles_domain_total"] == needed
    assert jc["tiles_bb_total"] == tc["tiles_bb_total"] == b * 8


def test_cuda_impl_on_cpu_tensors_raises():
    blk = 8
    tps = OPS.make_packed_sched([2 * blk], block=blk)
    q = torch.zeros((1, 2, 2 * blk, 16))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        OPS.packed_prefill_attention(q, q, q, tps, impl="cuda")
    tbl, needed = OPS.make_decode_table([3], [0], blk=blk, n_members=2,
                                        n_slots=1)
    spec = OPS.DecodeRoundSpec(2, 8, blk, "cuda", needed)
    cache = torch.zeros((1, 2 * blk, 2, 16))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        OPS.packed_decode_attention(torch.zeros((1, 2, 16)), cache, cache,
                                    torch.as_tensor(tbl), spec)
