"""repro_torch WKV6 (kernels/wkv_scan) == the JAX reference.

The port's oracle ref.py, which is also the plain version beside the
CUDA kernel, is held against the reference's Pallas kernel (interpret
mode) and its oracle ``impl="ref"`` at (B, L, H, hd) = (1, 8, 1, 8),
(2, 32, 4, 16) and (2, 64, 2, 64), and against ``impl="ref"`` alone at a
prime L = 37 (the reference's kernel asserts L % block_l == 0), all at
atol = rtol = 1e-5. Also: state chaining, bfloat16, an aliased decode
state, the model's chunked formulation against the reference's, the
chunk rule, and the launch counters and ``kernel_summary`` of the same
calls. Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.wkv_scan import ops as JOPS
from repro.models import rwkv6 as JRW
from repro.obs import launch as JOBS
from repro.obs import metrics as JMET
from repro_torch.kernels.wkv_scan import kernel as K
from repro_torch.kernels.wkv_scan import ops as OPS
from repro_torch.kernels.wkv_scan import ref as REF
from repro_torch.models import rwkv6 as RW
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(1, 8, 1, 8), (2, 32, 4, 16), (2, 64, 2, 64)]


def _inputs(b, l, h, hd, seed=0, state=False):
    """r, k, v, lw (B, L, H, hd), u (H, hd) and, with ``state``, a random
    s0 (B, H, hd, hd), as float32 numpy arrays; lw < 0."""
    rng = np.random.default_rng(seed + 97 * l + hd)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    r, k, v = f(b, l, h, hd), f(b, l, h, hd), f(b, l, h, hd)
    lw = -np.exp(f(b, l, h, hd))
    u = f(h, hd)
    out = [r, k, v, lw, u]
    if state:
        out.append(f(b, h, hd, hd))
    return out


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("ref_impl", ["pallas", "ref"])
@pytest.mark.parametrize("b,l,h,hd", SHAPES)
def test_ref_matches_reference(b, l, h, hd, ref_impl):
    xs = _inputs(b, l, h, hd, state=True)
    want_o, want_s = JOPS.wkv(*_j(*xs), impl=ref_impl)
    got_o, got_s = REF.wkv_ref(*_t(*xs))
    _close(got_o, want_o)
    _close(got_s, want_s)
    # the plain version beside the kernel, through the op and the wrapper
    for fn in (lambda *a: OPS.wkv(*a, impl="torch"), K.wkv):
        o, s = fn(*_t(*xs))
        _close(o, want_o)
        _close(s, want_s)


def test_prime_length_matches_reference_oracle():
    """L = 37: the chunk is 37 (min(64, 37) divides it); the reference's
    Pallas kernel would assert, its oracle runs."""
    xs = _inputs(2, 37, 3, 16, seed=1)
    want_o, want_s = JOPS.wkv(*_j(*xs), impl="ref")
    got_o, got_s = K.wkv(*_t(*xs))
    _close(got_o, want_o)
    _close(got_s, want_s)
    assert K.chunk_len(37) == 37


def test_state_chaining():
    r, k, v, lw, u = _t(*_inputs(1, 64, 2, 16, seed=2))
    o_full, s_full = K.wkv(r, k, v, lw, u)
    o1, s1 = K.wkv(r[:, :32], k[:, :32], v[:, :32], lw[:, :32], u)
    o2, s2 = K.wkv(r[:, 32:], k[:, 32:], v[:, 32:], lw[:, 32:], u, s1)
    _close(torch.cat([o1, o2], 1), o_full)
    _close(s2, s_full)


def test_aliased_state_is_updated_in_place():
    """A decode step passes its cache leaf as s0 and state_out."""
    r, k, v, lw, u, s0 = _t(*_inputs(3, 1, 4, 16, seed=3, state=True))
    want_o, want_s = REF.wkv_ref(r, k, v, lw, u, s0)
    cache = s0.clone()
    o, s = K.wkv(r, k, v, lw, u, cache, state_out=cache)
    assert s is cache
    _close(o, want_o)
    _close(cache, want_s)


def test_bfloat16_matches_reference_kernel():
    xs = _inputs(2, 32, 2, 16, seed=4)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs[:4]] + [jnp.asarray(xs[4])]
    tx = [torch.as_tensor(x).to(torch.bfloat16) for x in xs[:4]] + \
        [torch.as_tensor(xs[4])]
    want_o, want_s = JOPS.wkv(*jx, impl="pallas", block_l=16)
    got_o, got_s = K.wkv(*tx, block_l=16)
    assert got_o.dtype == torch.bfloat16 and want_o.dtype == jnp.bfloat16
    assert got_s.dtype == torch.float32
    # both run the recurrence in f32 on the same bf16 inputs; the outputs
    # round to bf16 once
    O.assert_close(got_o.float(), want_o, "attn", jnp.bfloat16)
    _close(got_s, want_s)


@pytest.mark.parametrize("l", [32, 20])
def test_model_chunk_matches_reference(l):
    """The model's exact intra-chunk formulation (_wkv_chunk) from a
    random state, and the kernel's oracle against it."""
    r, k, v, lw, u, s0 = _inputs(2, l, 2, 16, seed=5, state=True)
    want_o, want_s = JRW._wkv_chunk(*_j(s0, r, k, v, lw, u))
    got_o, got_s = RW._wkv_chunk(*_t(s0, r, k, v, lw, u))
    _close(got_o, want_o)
    _close(got_s, want_s)
    ref_o, ref_s = REF.wkv_ref(*_t(r, k, v, lw, u, s0))
    _close(ref_o, got_o, atol=1e-4, rtol=1e-4)
    _close(ref_s, got_s, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("l,block_l", [(1, 64), (37, 64), (48, 64),
                                       (100, 64), (2048, 64), (64, 16)])
def test_chunk_rule_is_the_model_loop(l, block_l):
    """block_l is halved until it divides L, as the reference model's
    chunk loop does."""
    want = min(block_l, l)
    while l % want:
        want //= 2
    assert K.chunk_len(l, block_l) == want
    assert l % K.chunk_len(l, block_l) == 0


def test_counters_and_summary_match_reference():
    """At (2, 32, 4, 16), block 16: 2 chunks over 8 cells, kind
    "chunked", the same bytes (s0 counted as zeros when absent)."""
    xs = _inputs(2, 32, 4, 16, seed=6)
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        JOPS.wkv(*_j(*xs), impl="pallas", block_l=16)
    with MET.scope(treg):
        K.wkv(*_t(*xs), block_l=16)
    want, got = JOBS.kernel_summary(jreg), OBS.kernel_summary(treg)
    assert sorted(got) == sorted(want) == ["wkv_scan.wkv"]
    g = got["wkv_scan.wkv"]
    assert (g["launches"], g["tiles_launched"], g["tiles_domain"]) == \
        (1, 2 * 8, 2 * 8)
    assert want["wkv_scan.wkv"].pop("impls") == ["pallas"]
    assert g.pop("impls") == ["torch"]
    assert g == want["wkv_scan.wkv"]


@pytest.mark.parametrize("b,l,h,hd,block_l", [(2, 32, 4, 16, 16),
                                              (4, 2048, 32, 64, 64),
                                              (4, 1, 32, 64, 64)])
def test_kernel_meta_matches_reference(b, l, h, hd, block_l):
    bl = K.chunk_len(l, block_l)
    got = K.wkv_meta("cuda", b, l, h, hd, bl)
    want = JOBS.meta_dense("wkv_scan.wkv", "wkv_scan", impl="pallas",
                           grid=(l // bl,), block_shape=(bl, hd),
                           tiles_domain=l // bl, kind="chunked", cells=b * h)
    for field in ("name", "family", "kind", "grid", "block_shape",
                  "tiles_launched", "tiles_domain", "tiles_bb", "cells"):
        assert getattr(got, field) == getattr(want, field), field


def test_op_refuses_cuda_impl_on_cpu_and_unknown_impls():
    xs = _t(*_inputs(1, 8, 1, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        OPS.wkv(*xs, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        OPS.wkv(*xs, impl="pallas")
    o, s = OPS.wkv(*xs, impl="ref")
    assert o.dtype == s.dtype == torch.float32
