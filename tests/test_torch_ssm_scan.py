"""repro_torch selective scan (kernels/ssm_scan) == the JAX reference.

The port's oracle ref.py, which is also the plain version beside the
CUDA kernel, is held against the reference's Pallas kernel (interpret
mode) and its oracle ``impl="ref"`` at the reference test's five (B, L,
D, N) shapes, at L = 37 (not a multiple of the 128-step chunk) and at
L = 1, in f32 at atol = rtol = 1e-4 and with bfloat16 inputs at 5e-2
(the reference test's tolerances). Also: state chaining, an aliased
decode state, the model's chunked formulation against the reference's,
the block rule, the launch meta, counters and ``kernel_summary`` of the
same calls, and the refusals (impl "cuda" on CPU tensors, unknown
impls, inputs that need a gradient). Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ops as JOPS
from repro.models import mamba as JMB
from repro.obs import launch as JOBS
from repro.obs import metrics as JMET
from repro_torch.kernels.ssm_scan import kernel as K
from repro_torch.kernels.ssm_scan import ops as OPS
from repro_torch.kernels.ssm_scan import ref as REF
from repro_torch.models import mamba as MB
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET

torch.set_num_threads(2)

TOL = {np.float32: dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
SHAPES = [(1, 8, 16, 4), (2, 32, 64, 16), (2, 128, 256, 16), (1, 64, 128, 8),
          (3, 16, 32, 32), (2, 37, 32, 8), (3, 1, 64, 16)]


def _inputs(b, l, d, n, seed=0, state=False):
    """x, dt (B, L, D) with dt = softplus(N(0, 1) - 1), A (D, N) < 0, Bt,
    Ct (B, L, N) and, with ``state``, a random h0 (B, D, N), as float32
    numpy arrays (the reference test's distributions)."""
    rng = np.random.default_rng(seed + 31 * l + d + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, l, d)
    dt = np.log1p(np.exp(f(b, l, d) - 1)).astype(np.float32)
    A = -np.exp(0.3 * f(d, n)).astype(np.float32)
    out = [x, dt, A, f(b, l, n), f(b, l, n)]
    if state:
        out.append(f(b, d, n))
    return out


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or TOL[np.float32]))


@pytest.mark.parametrize("ref_impl", ["pallas", "ref"])
@pytest.mark.parametrize("b,l,d,n", SHAPES)
def test_ref_matches_reference(b, l, d, n, ref_impl):
    xs = _inputs(b, l, d, n, state=True)
    want_y, want_h = JOPS.selective_scan(*_j(*xs), impl=ref_impl,
                                         block_d=min(64, d),
                                         block_l=min(32, l) if l % 32 == 0
                                         else l)
    for got_y, got_h in (REF.selective_scan_ref(*_t(*xs)),
                         OPS.selective_scan(*_t(*xs), impl="torch"),
                         OPS.selective_scan(*_t(*xs), impl="ref"),
                         K.selective_scan(*_t(*xs))):
        _close(got_y, want_y)
        _close(got_h, want_h)


def test_bfloat16_matches_reference_kernel():
    """The reference test's bf16 sweep: y in bf16, the state in f32."""
    xs = _inputs(2, 32, 64, 8, seed=1)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    jx[2] = jnp.asarray(xs[2])  # A stays f32
    tx = [torch.as_tensor(x).to(torch.bfloat16) for x in xs]
    tx[2] = torch.as_tensor(xs[2])
    want_y, want_h = JOPS.selective_scan(*jx, impl="pallas", block_d=32,
                                         block_l=16)
    got_y, got_h = K.selective_scan(*tx, block_d=32, block_l=16)
    assert got_y.dtype == torch.bfloat16 and want_y.dtype == jnp.bfloat16
    assert got_h.dtype == torch.float32
    _close(got_y.float(), want_y.astype(jnp.float32), **TOL["bfloat16"])
    _close(got_h, want_h)


def test_state_chaining_across_calls():
    """scan(x1 ++ x2) == scan(x2, h0=scan(x1).h), the decode contract."""
    x, dt, A, Bt, Ct = _t(*_inputs(2, 64, 32, 8, seed=2))
    y_full, h_full = K.selective_scan(x, dt, A, Bt, Ct)
    y1, h1 = K.selective_scan(x[:, :32], dt[:, :32], A, Bt[:, :32],
                              Ct[:, :32])
    y2, h2 = K.selective_scan(x[:, 32:], dt[:, 32:], A, Bt[:, 32:],
                              Ct[:, 32:], h1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(h2, h_full)


def test_aliased_state_is_updated_in_place():
    """A decode step passes its cache leaf as h0 and state_out."""
    x, dt, A, Bt, Ct, h0 = _t(*_inputs(4, 1, 64, 16, seed=3, state=True))
    want_y, want_h = REF.selective_scan_ref(x, dt, A, Bt, Ct, h0)
    cache = h0.clone()
    y, h = K.selective_scan(x, dt, A, Bt, Ct, cache, state_out=cache)
    assert h is cache
    _close(y, want_y)
    _close(cache, want_h)


@pytest.mark.parametrize("l", [32, 20, 1])
def test_model_chunk_matches_reference(l):
    """The model's associative-scan chunk (_ssm_chunk) from a random
    state equals the reference's, and the kernel's oracle equals it."""
    x, dt, A, Bt, Ct, h0 = _inputs(2, l, 16, 8, seed=4, state=True)
    decay = np.exp(dt[..., None] * A)
    inject = (dt * x)[..., None] * Bt[:, :, None, :]
    want_y, want_h = JMB._ssm_chunk(*_j(h0, decay, inject, Ct))
    got_y, got_h = MB._ssm_chunk(*_t(h0, decay, inject, Ct))
    _close(got_y, want_y, atol=2e-5, rtol=2e-5)
    _close(got_h, want_h, atol=2e-5, rtol=2e-5)
    ref_y, ref_h = REF.selective_scan_ref(*_t(x, dt, A, Bt, Ct, h0))
    _close(ref_y, got_y)
    _close(ref_h, got_h)


@pytest.mark.parametrize("l,block", [(1, 128), (37, 128), (48, 128),
                                     (2047, 128), (2048, 128), (16384, 256),
                                     (16, 256)])
def test_block_rule_is_the_model_loop(l, block):
    """A block is halved until it divides its axis, as the reference
    model's chunk loop does; a dividing block stays the reference's."""
    want = min(block, l)
    while l % want:
        want //= 2
    assert K.chunk_len(l, block) == want
    assert l % K.chunk_len(l, block) == 0


@pytest.mark.parametrize("b,l,d,block_d,block_l", [(2, 32, 64, 32, 16),
                                                   (4, 2048, 16384, 256, 128),
                                                   (4, 1, 16384, 256, 128),
                                                   (1, 8, 16, 256, 128)])
def test_kernel_meta_matches_reference(b, l, d, block_d, block_l):
    """The reference's launch record, block_d = min(block_d, D), block_l
    = min(block_l, L)."""
    bd, bl = min(block_d, d), min(block_l, l)
    got = K.ssm_meta("cuda", b, l, d, K.chunk_len(l, block_l),
                     K.chunk_len(d, block_d))
    want = JOBS.meta_dense("ssm_scan.selective_scan", "ssm_scan",
                           impl="pallas", grid=(l // bl,),
                           block_shape=(bl, bd), tiles_domain=l // bl,
                           kind="chunked", cells=b * (d // bd))
    for field in ("name", "family", "kind", "grid", "block_shape",
                  "tiles_launched", "tiles_domain", "tiles_bb", "cells"):
        assert getattr(got, field) == getattr(want, field), field


def test_counters_and_summary_match_reference():
    """At (2, 32, 64, 8), blocks (32, 16): 2 chunks over 4 cells, kind
    "chunked", the same bytes (h0 counted as zeros when absent)."""
    xs = _inputs(2, 32, 64, 8, seed=6)
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        JOPS.selective_scan(*_j(*xs), impl="pallas", block_d=32,
                            block_l=16)
    with MET.scope(treg):
        K.selective_scan(*_t(*xs), block_d=32, block_l=16)
    want, got = JOBS.kernel_summary(jreg), OBS.kernel_summary(treg)
    name = "ssm_scan.selective_scan"
    assert sorted(got) == sorted(want) == [name]
    g = got[name]
    assert (g["launches"], g["tiles_launched"], g["tiles_domain"]) == \
        (1, 2 * 4, 2 * 4)
    assert want[name].pop("impls") == ["pallas"]
    assert g.pop("impls") == ["torch"]
    assert g == want[name]


def test_op_refuses_cuda_impl_on_cpu_and_unknown_impls():
    xs = _t(*_inputs(1, 8, 16, 4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        OPS.selective_scan(*xs, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        OPS.selective_scan(*xs, impl="pallas")
    y, h = OPS.selective_scan(*xs, impl="ref")
    assert y.dtype == h.dtype == torch.float32


def test_wrapper_refuses_inputs_that_need_a_gradient():
    """No backward exists: the wrapper refuses on any device, before a
    launch or the plain version; the plain version itself stays
    differentiable (the model trains through its chunked form)."""
    x, dt, A, Bt, Ct = _t(*_inputs(1, 8, 16, 4, seed=7))
    before = K.selective_scan.launches
    for i in range(5):
        args = [x, dt, A, Bt, Ct]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(ValueError, match="no backward"):
            K.selective_scan(*args)
    assert K.selective_scan.launches == before
    xg = x.clone().requires_grad_()
    y, _ = K.selective_scan_torch(xg, dt, A, Bt, Ct)
    y.sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
