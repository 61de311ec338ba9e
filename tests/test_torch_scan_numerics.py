"""The numerics of the recurrent scan kernels, emulated in plain torch.

``wkv_scan.wkv`` (csrc/wkv_scan.cu) splits each (batch, head) stream into
chunks of ``WKV_CHUNK`` steps chained in one launch: chunk 0 walks from
s0; every other chunk walks from a zero state (its local outputs, its
local state dS_c and P_c = prod_t e^{lw_t}), then takes its
predecessor's state S_{c-1}, publishes S_c = diag(P_c) S_{c-1} + dS_c
and adds (r_t * prod_{tau < t} e^{lw_tau}) S_{c-1} to each local output.
``_wkv_chunks`` below does the same in f32, chunk by chunk in the
kernel's ticket order (every stream's chunk c before chunk c + 1), at
small chunk lengths, L with a short last chunk and L < C, and is held
against the reference's interpret-mode Pallas ``wkv`` at atol = rtol =
1e-5 (the f32 tolerance of test_torch_wkv_scan.py): the chunks' sums
round otherwise than the walk. A call of one chunk is the walk itself,
bitwise equal to the port's sequential oracle; an aliased state (s0 is
state_out) gives the same bits as a separate one.

``ssm_scan.selective_scan`` (csrc/ssm_scan.cu) takes each decay as one
``ex2.approx.ftz`` of dt (A log2 e): 2^x within 2 ulp, and 0 where 2^x
is below 2^-126. ``_ssm_flushed`` emulates that flush (with the exact
2^x) and is held against the reference's interpret-mode Pallas
``selective_scan`` at its test's f32 tolerance (1e-4), also where some
decays flush. Inputs come from a numpy seed.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import kernel as JSSM
from repro.kernels.wkv_scan import kernel as JWKV
from repro_torch.kernels.wkv_scan import kernel as WK
from repro_torch.kernels.wkv_scan import ref as WR

torch.set_num_threads(2)

CSRC = Path(WK.__file__).resolve().parents[2] / "csrc"
WKV_TOL = dict(atol=1e-5, rtol=1e-5)
SSM_TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634
FLT_MIN = 2.0 ** -126


def _wkv_inputs(b, l, h, hd, seed=0):
    """r, k, v, lw (B, L, H, hd), u (H, hd) and s0 (B, H, hd, hd) as
    float32 numpy arrays; lw < 0 (the card tests' distributions)."""
    rng = np.random.default_rng(seed + 13 * l + hd)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    r, k, v = f(b, l, h, hd), f(b, l, h, hd), f(b, l, h, hd)
    lw = -np.exp(f(b, l, h, hd))
    return [r, k, v, lw, f(h, hd), f(b, h, hd, hd)]


def _step(s, rt, kt, vt, wt, u):
    """One step of the walk, the oracle's (ref.py) expressions: (out_t,
    S_t) from S_{t-1}."""
    out = (rt[..., :, None] * s).sum(-2) \
        + (rt * u * kt).sum(-1, keepdim=True) * vt
    return out, wt[..., None] * s + kt[..., :, None] * vt[..., None, :]


def _wkv_chunks(r, k, v, lw, u, s0, chunk, state_out=None):
    """The kernel's chunked walk in f32 torch: (out, s_L), s_L written into
    ``state_out`` (which may be s0) when given."""
    b, l, h, hd = r.shape
    w = torch.exp(lw)
    outs, s_prev = [], None
    for c in range(-(-l // chunk)):  # every stream's chunk c, in order
        t0, t1 = c * chunk, min(l, (c + 1) * chunk)
        s = s0.clone() if c == 0 else torch.zeros_like(s0)
        p = torch.ones((b, h, hd), dtype=torch.float32)
        local, rp = [], []
        for t in range(t0, t1):
            o, s = _step(s, r[:, t], k[:, t], v[:, t], w[:, t], u)
            local.append(o)
            rp.append(r[:, t] * p)
            p = p * w[:, t]
        if c == 0:  # from s0: the outputs are final, S_0 is the walk's
            outs += local
            s_prev = s
            continue
        s_in, s_prev = s_prev, p[..., None] * s_prev + s
        outs += [o + (x[..., :, None] * s_in).sum(-2)
                 for o, x in zip(local, rp)]
    if state_out is not None:
        s_prev = state_out.copy_(s_prev)
    return torch.stack(outs, 1), s_prev


def _reference_wkv(xs):
    """The reference's Pallas kernel in interpret mode, one chunk of L
    steps (its chunk must divide L)."""
    l = xs[0].shape[1]
    o, s = JWKV.wkv(*(jnp.asarray(x) for x in xs), block_l=l, interpret=True)
    return np.asarray(o), np.asarray(s)


def test_chunk_constant_matches_the_source():
    src = (CSRC / "wkv_scan.cu").read_text()
    got = re.search(r"constexpr int WKV_CHUNK = (\d+);", src)
    assert got is not None and int(got.group(1)) == WK.WKV_CHUNK


@pytest.mark.parametrize("chunk,l", [(4, 1), (4, 3), (4, 4), (4, 5),
                                     (4, 21), (8, 37), (16, 64), (16, 50)])
@pytest.mark.parametrize("hd", [8, 16])
def test_chunked_wkv_matches_reference(chunk, l, hd):
    xs = _wkv_inputs(2, l, 3, hd, seed=chunk)
    want_o, want_s = _reference_wkv(xs)
    got_o, got_s = _wkv_chunks(*(torch.as_tensor(x) for x in xs), chunk)
    np.testing.assert_allclose(got_o.numpy(), want_o, **WKV_TOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, **WKV_TOL)


def test_chunked_wkv_at_the_kernel_chunk():
    """C = WKV_CHUNK over three chunks and a short fourth, hd 32."""
    l = 3 * WK.WKV_CHUNK + 5
    xs = _wkv_inputs(1, l, 2, 32, seed=3)
    want_o, want_s = _reference_wkv(xs)
    got_o, got_s = _wkv_chunks(*(torch.as_tensor(x) for x in xs),
                               WK.WKV_CHUNK)
    np.testing.assert_allclose(got_o.numpy(), want_o, **WKV_TOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, **WKV_TOL)


@pytest.mark.parametrize("l", [1, 7, 16])
def test_one_chunk_is_the_sequential_walk(l):
    """L <= C: the chunked walk is the port's sequential oracle, bitwise."""
    xs = [torch.as_tensor(x) for x in _wkv_inputs(2, l, 3, 16, seed=4)]
    got_o, got_s = _wkv_chunks(*xs, 16)
    want_o, want_s = WR.wkv_ref(*xs)
    assert torch.equal(got_o, want_o) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("l", [1, 13])
def test_aliased_state_gives_the_same_bits(l):
    """s0 as state_out: chunk 0 reads s0 before the last chunk writes s_L."""
    xs = [torch.as_tensor(x) for x in _wkv_inputs(2, l, 3, 8, seed=5)]
    want_o, want_s = _wkv_chunks(*xs, 4)
    cache = xs[5].clone()
    got_o, got_s = _wkv_chunks(*xs[:5], cache, 4, state_out=cache)
    assert got_s is cache
    assert torch.equal(got_o, want_o) and torch.equal(cache, want_s)


def _ssm_inputs(b, l, d, n, seed=0, dt_scale=1.0):
    """x, dt = dt_scale softplus(N(0, 1) - 1), A = -exp(0.3 N(0, 1)), Bt,
    Ct and h0 (the reference test's distributions) as float32 numpy."""
    rng = np.random.default_rng(seed + 31 * l + d + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, l, d)
    dt = (dt_scale * np.log1p(np.exp(f(b, l, d) - 1))).astype(np.float32)
    a = -np.exp(0.3 * f(d, n)).astype(np.float32)
    return [x, dt, a, f(b, l, n), f(b, l, n), f(b, d, n)]


def _ex2_ftz(x):
    """2^x with results below 2^-126 flushed to 0 (ex2.approx.ftz, less
    its 2-ulp approximation)."""
    y = torch.exp2(x)
    return torch.where(y < FLT_MIN, torch.zeros_like(y), y)


def _ssm_flushed(x, dt, a, bt, ct, h0):
    """The kernel's scan in f32 torch: decays ex2_ftz(dt (A log2 e))."""
    a2 = a * LOG2E
    h, ys = h0.clone(), []
    for t in range(x.shape[1]):
        dtt = dt[:, t, :, None]
        h = _ex2_ftz(dtt * a2) * h \
            + (dt[:, t] * x[:, t])[..., None] * bt[:, t, None, :]
        ys.append((h * ct[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("b,l,d,n", [(1, 8, 16, 4), (2, 32, 64, 16),
                                     (3, 16, 32, 32), (2, 64, 128, 8)])
def test_flushed_scan_matches_reference(b, l, d, n):
    xs = _ssm_inputs(b, l, d, n)
    want_y, want_h = JSSM.selective_scan(*(jnp.asarray(x) for x in xs),
                                         interpret=True)
    got_y, got_h = _ssm_flushed(*(torch.as_tensor(x) for x in xs))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SSM_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SSM_TOL)


def test_flush_reaches_only_decays_that_wipe_the_state():
    """dt 60x larger: about 1% of the decays fall between 2^-149 and
    2^-126 and flush to 0 where exp keeps a subnormal, every larger one
    stays; the scan still agrees with the reference, since such a decay
    already wipes the state."""
    xs = _ssm_inputs(2, 16, 32, 16, dt_scale=60.0)
    t = [torch.as_tensor(x) for x in xs]
    decays = torch.exp(t[1][..., None] * t[2])
    flushed = _ex2_ftz(t[1][..., None] * (t[2] * LOG2E))
    sub = (decays > 0) & (decays < FLT_MIN)
    assert int(sub.sum()) > 100 and bool((flushed[sub] == 0).all())
    assert bool((flushed[decays >= 2 * FLT_MIN] > 0).all())
    want_y, want_h = JSSM.selective_scan(*(jnp.asarray(x) for x in xs),
                                         interpret=True)
    got_y, got_h = _ssm_flushed(*t)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SSM_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SSM_TOL)
