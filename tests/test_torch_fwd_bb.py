"""repro_torch's BB attention baseline (tri_attn.fwd_bb) == the JAX package.

The same numpy inputs go through the reference's ``fwd_bb`` (its Pallas
kernel in interpret mode) and ``triangular_attention(impl="bb")``, and
through the port's plain version ``fwd_bb_torch`` (what ``kernel.fwd_bb``
runs on CPU tensors) and ``triangular_attention(impl="bb_torch")``, for
ltm and band schedules, f32 and bf16, GQA groups 1 and 2, at the
tolerances of tests/test_torch_tri_attn_train.py; the port's triangular
forward ``fwd_torch`` holds the same outputs. The launch counters equal
the reference's. The BB impls are forward only and refuse prefix > 0:
the reference's BB guard j <= i drops the above-diagonal tiles a
prefix-causal row needs, which the last test shows on the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro.kernels.tri_attn import ref as JREF
from repro.obs import metrics as JMET
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (b, h, hkv, s, d, block, window): ltm and band cases of the reference's
# kernel tests (tests/test_kernels_tri_attn.py CASES), GQA groups 1 and 2
BB_CASES = {
    ("ltm", 1): (1, 2, 2, 64, 16, 16, None),
    ("ltm", 2): (2, 4, 2, 64, 16, 16, None),
    ("band", 1): (1, 2, 2, 64, 16, 16, 24),
    ("band", 2): (1, 4, 2, 96, 16, 16, 40),
}


def _inputs(case, dtype, seed=0):
    b, h, hkv, s, d = case[:5]
    rng = np.random.default_rng(seed + s + h + hkv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x, jd) for x in (q, k, v)],
            [torch.as_tensor(x).to(td) for x in (q, k, v)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,g", sorted(BB_CASES))
def test_fwd_bb_matches_reference(kind, g, dtype):
    b, h, hkv, s, d, blk, window = case = BB_CASES[(kind, g)]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    jsched = JOPS.make_sched(s, block_q=blk, block_k=blk, window=window)
    want_out, want_lse = JK.fwd_bb(jq, jk, jv, jsched, interpret=True)
    sched = OPS.make_sched(s, block=blk, window=window)
    assert sched.kind == jsched.kind == kind
    jdt = DTYPES[dtype][0]
    out, lse = K.fwd_bb(tq, tk, tv, sched)  # CPU tensors: the plain version
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    plain = SC.fwd_bb_torch(tq, tk, tv, sched, d ** -0.5)
    assert torch.equal(out, plain[0]) and torch.equal(lse, plain[1])
    O.assert_close(_np(out), _np(want_out), "attn", jdt)
    O.assert_close(_np(lse), _np(want_lse), "attn", jdt)
    tri_out, tri_lse = SC.fwd_torch(tq, tk, tv, sched, d ** -0.5)
    O.assert_close(_np(out), _np(tri_out), "attn", jdt)
    O.assert_close(_np(lse), _np(tri_lse), "attn", jdt)
    got = OPS.triangular_attention(tq, tk, tv, window=window,
                                   impl="bb_torch", block=blk)
    want = JOPS.triangular_attention(jq, jk, jv, window=window, impl="bb",
                                     block_q=blk, block_k=blk)
    assert got.dtype == tq.dtype
    O.assert_close(_np(got), _np(want), "attn", jdt)
    O.assert_close(_np(got), _np(JREF.mha_reference(jq, jk, jv,
                                                    window=window)),
                   "attn", jdt)


@pytest.mark.parametrize("kind,g", sorted(BB_CASES))
def test_fwd_bb_counters_match_reference(kind, g):
    b, h, hkv, s, d, blk, window = case = BB_CASES[(kind, g)]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "float32")
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        JK.fwd_bb(jq, jk, jv, JOPS.make_sched(s, block_q=blk, block_k=blk,
                                              window=window), interpret=True)
    sched = OPS.make_sched(s, block=blk, window=window)
    with MET.scope(treg):
        K.fwd_bb(tq, tk, tv, sched)
    n = s // blk
    for counter in ("launches_total", "tiles_launched_total",
                    "tiles_domain_total", "tiles_wasted_total",
                    "tiles_bb_total", "launch_bytes_total"):
        want = jreg.counter_value(counter, {"name": "tri_attn.fwd_bb",
                                            "impl": "pallas"})
        assert treg.counter_value(counter, {"name": "tri_attn.fwd_bb",
                                            "impl": "torch"}) == want
    summ = OBS.kernel_summary(treg)["tri_attn.fwd_bb"]
    assert (summ["launches"], summ["tiles_launched"], summ["tiles_domain"],
            summ["tiles_wasted"]) == \
        (1, n * n * b * h, n * (n + 1) // 2 * b * h,
         n * (n - 1) // 2 * b * h)
    cuda = K.fwd_bb_meta("cuda", sched, b * h)
    assert (cuda.tiles_launched, cuda.tiles_domain, cuda.tiles_bb,
            cuda.cells, cuda.grid) == (n * n, n * (n + 1) // 2, n * n,
                                       b * h, (n, n))


@pytest.mark.parametrize("impl", ["bb", "bb_torch"])
@pytest.mark.parametrize("grad", ["q", "k", "v"])
def test_bb_is_forward_only(impl, grad):
    (_, tqkv) = _inputs(BB_CASES[("ltm", 2)], "float32")
    tqkv["qkv".index(grad)].requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        OPS.triangular_attention(*tqkv, impl=impl, block=16)


def test_reference_bb_prefix_fault_is_refused_by_the_port():
    """The reference's impl='bb' at prefix 24 (S 64, blk 16) differs from
    its own oracle by far more than any tolerance (its guard j <= i drops
    the prefix tiles above the diagonal), while its scan agrees; the port
    refuses the schedule in the op, the kernel wrapper and the plain
    version."""
    b, h, s, d, blk, prefix = 2, 2, 64, 16, 16, 24
    (jq, jk, jv), (tq, tk, tv) = _inputs((b, h, h, s, d), "float32", seed=3)
    oracle = _np(JREF.mha_reference(jq, jk, jv, prefix=prefix))
    bb = _np(JOPS.triangular_attention(jq, jk, jv, prefix=prefix, impl="bb",
                                       block_q=blk, block_k=blk))
    scan = _np(JOPS.triangular_attention(jq, jk, jv, prefix=prefix,
                                         impl="scan", block_q=blk,
                                         block_k=blk))
    assert np.abs(bb - oracle).max() > 0.1
    O.assert_close(scan, oracle, "attn")
    for impl in ("bb", "bb_torch"):
        with pytest.raises(ValueError, match="refuses prefix"):
            OPS.triangular_attention(tq, tk, tv, prefix=prefix, impl=impl,
                                     block=blk)
    sched = OPS.make_sched(s, block=blk, prefix=prefix)
    with pytest.raises(ValueError, match="prefix-causal"):
        K.fwd_bb(tq, tk, tv, sched)
    with pytest.raises(ValueError, match="prefix-causal"):
        SC.fwd_bb_torch(tq, tk, tv, sched, d ** -0.5)
