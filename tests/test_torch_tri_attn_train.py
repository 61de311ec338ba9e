"""repro_torch triangular attention (the training path) == the JAX package.

The same numpy inputs go through ``triangular_attention`` of both
packages: forward output and log-sum-exp, and the grads of q, k and v, on
the reference kernel tests' CASES (tests/test_kernels_tri_attn.py) at the
tolerances of tests/oracles.py. The reference runs its Pallas kernels (in
interpret mode) on two cases and its scan impl on the rest; the port runs
its plain version ('torch', what its kernel wrappers run on CPU tensors)
and its full-matrix oracle ('ref'). The launch telemetry of the forward,
dq and dk/dv launches carries the reference's tile counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro.kernels.tri_attn import ref as JREF
from repro.obs import launch as JOBS
from repro.obs import metrics as JMET
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET
from test_kernels_tri_attn import CASES

torch.set_num_threads(2)

PALLAS_CASES = (1, 5)  # GQA group 2 and prefix-causal run the Pallas kernels
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, dtype):
    b, h, hkv, s, d = case[:5]
    rng = np.random.default_rng(s + d + h + hkv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    cot = np.cos(np.arange(b * h * s * d, dtype=np.float32)).reshape(
        b, h, s, d)
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x, jd) for x in (q, k, v)],
            [torch.as_tensor(x).to(td) for x in (q, k, v)], cot)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_impl(idx):
    return "pallas" if idx in PALLAS_CASES else "scan"


def _close_grad(got, want, dtype):
    """float32: the oracles' attn_grad tolerance. bfloat16 (which the
    oracles give no grad tolerance): the bf16 attn tolerance with its
    absolute part taken relative to the largest magnitude, since each
    grad sums many bf16-rounded terms (cf. tests/test_torch_models.py)."""
    if dtype == "float32":
        tol = O.tol("attn_grad", jnp.float32)
    else:
        tol = O.tol("attn", jnp.bfloat16)
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=[str(c) for c in CASES])
def test_forward_out_and_lse_match_jax(idx, dtype):
    case = CASES[idx]
    _, _, _, s, _, blk, window, prefix = case
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(case, dtype)
    if _jax_impl(idx) == "pallas":
        jsched = JOPS.make_sched(s, block_q=blk, block_k=blk, window=window,
                                 prefix=prefix)
        want_out, want_lse = JK.fwd(jq, jk, jv, jsched, interpret=True)
    else:
        want_out = JOPS.triangular_attention(jq, jk, jv, window=window,
                                             prefix=prefix, impl="scan",
                                             block_q=blk, block_k=blk)
        _, want_lse = JREF.mha_reference(jq, jk, jv, window=window,
                                         prefix=prefix, return_lse=True)
    sched = OPS.make_sched(s, block=blk, window=window, prefix=prefix)
    out, lse = K.fwd(tq, tk, tv, sched)  # CPU tensors: the plain version
    O.assert_close(_np(out), _np(want_out), "attn", DTYPES[dtype][0])
    O.assert_close(_np(lse), _np(want_lse), "attn", DTYPES[dtype][0])
    for impl in ("torch", "ref"):
        got = OPS.triangular_attention(tq, tk, tv, window=window,
                                       prefix=prefix, impl=impl, block=blk)
        assert got.dtype == tq.dtype
        O.assert_close(_np(got), _np(want_out), "attn", DTYPES[dtype][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=[str(c) for c in CASES])
def test_grads_match_jax(idx, dtype):
    case = CASES[idx]
    _, _, _, _, _, blk, window, prefix = case
    (jq, jk, jv), (tq, tk, tv), cot = _inputs(case, dtype)

    def jloss(q, k, v):
        o = JOPS.triangular_attention(q, k, v, window=window, prefix=prefix,
                                      impl=_jax_impl(idx), block_q=blk,
                                      block_k=blk)
        return jnp.sum(o.astype(jnp.float32) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for impl in ("torch", "ref"):
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
        out = OPS.triangular_attention(*leaves, window=window, prefix=prefix,
                                       impl=impl, block=blk)
        (out.float() * torch.as_tensor(cot)).sum().backward()
        for leaf, w, name in zip(leaves, want, "qkv"):
            assert leaf.grad.dtype == leaf.dtype and \
                leaf.grad.shape == leaf.shape, (impl, name)
            _close_grad(_np(leaf.grad), _np(w), dtype)


@pytest.mark.parametrize("idx", [1, 3, 5])
def test_launch_tiles_match_reference(idx):
    """tiles_launched / tiles_domain / tiles_bb of tri_attn.fwd, bwd_dq and
    bwd_dkv: the port's plain version (impl 'torch') counts what the
    reference's scan impl counts, and the metas of the CUDA launches
    carry the same numbers."""
    case = CASES[idx]
    b, h, _, s, _, blk, window, prefix = case
    (jq, jk, jv), (tq, tk, tv), cot = _inputs(case, "float32")
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        jax.grad(lambda q, k, v: jnp.sum(JOPS.triangular_attention(
            q, k, v, window=window, prefix=prefix, impl="scan", block_q=blk,
            block_k=blk) * cot), argnums=(0, 1, 2))(jq, jk, jv)
    with MET.scope(treg):
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
        out = OPS.triangular_attention(*leaves, window=window, prefix=prefix,
                                       impl="torch", block=blk)
        (out * torch.as_tensor(cot)).sum().backward()
    sched = OPS.make_sched(s, block=blk, window=window, prefix=prefix)
    jsched = JOPS.make_sched(s, block_q=blk, block_k=blk, window=window,
                             prefix=prefix)
    for name in ("tri_attn.fwd", "tri_attn.bwd_dq", "tri_attn.bwd_dkv"):
        for counter in ("launches_total", "tiles_launched_total",
                        "tiles_domain_total", "tiles_bb_total"):
            want = jreg.counter_value(counter, {"name": name,
                                                "impl": "scan"})
            assert want > 0, (name, counter)
            assert treg.counter_value(counter, {"name": name,
                                                "impl": "torch"}) == want
        got = OBS.meta_from_trisched(name, sched, impl="cuda", cells=b * h)
        ref = JOBS.meta_from_trisched(name, jsched, impl="pallas",
                                      cells=b * h)
        assert (got.tiles_launched, got.tiles_domain, got.tiles_bb,
                got.kind, got.block_shape) == \
            (ref.tiles_launched, ref.tiles_domain, ref.tiles_bb, ref.kind,
             ref.block_shape)


@pytest.mark.parametrize("kind,window,prefix", [("ltm", None, 0),
                                                ("band", 40, 0),
                                                ("prefix", None, 24)])
def test_trisched_enumerations_match_reference(kind, window, prefix):
    """rm_map / cm_map and the row and column bounds of the port's
    TriSched against the reference's, host ints and tensors (the maps
    themselves are held exhaustively in tests/test_torch_mapping.py)."""
    for n in (1, 2, 3, 5, 8, 24):
        blk = 16
        sched = OPS.make_sched(n * blk, block=blk, window=window,
                               prefix=prefix)
        jsched = JOPS.make_sched(n * blk, block_q=blk, block_k=blk,
                                 window=window, prefix=prefix)
        assert sched.kind == jsched.kind == kind or n * blk <= (window or 0)
        # the port bounds p_b by n: where the prefix runs past the sequence
        # (24 tokens at n = 1) the reference's p_b, and its rows' last
        # column, run past the last tile (ROADMAP queue C)
        assert (sched.rm_steps, sched.cm_steps, sched.w_b, sched.p_b) == \
            (jsched.rm_steps, jsched.cm_steps, jsched.w_b,
             min(jsched.p_b, n))
        lam = np.arange(sched.rm_steps, dtype=np.int32)
        for fn in ("rm_map", "cm_map"):
            got = getattr(sched, fn)(torch.as_tensor(lam))
            want = getattr(jsched, fn)(jnp.asarray(lam))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            host = [getattr(sched, fn)(int(x)) for x in lam]
            np.testing.assert_array_equal(np.asarray(host).T,
                                          np.stack([g.numpy() for g in got]))
        idx = np.arange(n, dtype=np.int32)
        for fn in ("rm_first_col", "rm_last_col", "cm_first_row",
                   "cm_last_row"):
            got = getattr(sched, fn)(torch.as_tensor(idx))
            want = getattr(jsched, fn)(jnp.asarray(idx))
            if fn == "rm_last_col":
                want = np.minimum(np.asarray(want), n - 1)
            np.testing.assert_array_equal(np.broadcast_to(got.numpy(), n),
                                          np.broadcast_to(np.asarray(want),
                                                          n))
            assert [getattr(sched, fn)(int(x)) for x in idx] == \
                list(np.broadcast_to(np.asarray(want), n))


def test_cuda_impl_refuses_cpu_tensors():
    (_, (tq, tk, tv), _) = _inputs(CASES[1], "float32")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        OPS.triangular_attention(tq, tk, tv, impl="cuda", block=16)
