"""Mamba (selective SSM) layer, the "mamba" token mixer of Jamba (port
of ``repro/models/mamba.py``).

Diagonal selective state space, per channel c and state n:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The scan region is what the reference marks ``ssm_scan_kernel``: with
impl "cuda" it is the kernel (``kernels/ssm_scan``) for every sequence
length, a single-token decode step included, and a given state's "h" is
updated in place (the kernel's h0 and h_L are the same tensor). With
impl "torch" it is the reference's own formulation: an associative scan
inside chunks of up to CHUNK steps (``_ssm_chunk``) carrying the (d_inner,
d_state) state across chunks for S > 1, its fast path for S == 1. The
causal conv, the D skip, the SiLU gate and the projections stay outside
the kernel, as in the reference; dtypes follow it (the scan inputs in
f32, the gate in x's dtype).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import layers as L

CHUNK = 128


def init_mamba(gen, cfg, dtype, device, stack: int):
    """The reference's leaves and inits (dt_bias 0, a_log log(1..N),
    d_skip 1), each stacked on a leading axis of ``stack`` layers."""
    d, din, ds, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv

    def dense(shape):
        return L.dense_init(gen, shape, shape[0], dtype, device, stack)

    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense((d, 2 * din)),
        "conv_w": dense((dc, din)),
        "x_proj": dense((din, 2 * ds + 1)),
        "dt_bias": torch.zeros((stack, din), dtype=torch.float32,
                               device=device),
        "a_log": a_log.expand(stack, din, ds).clone(),
        "d_skip": torch.ones((stack, din), dtype=torch.float32,
                             device=device),
        "out_proj": dense((din, d)),
    }


def _causal_conv(x, w, prev):
    """Depthwise causal conv. x: (B, S, din); w: (dc, din); prev: (B,
    dc-1, din) carry from the previous segment. Returns (y (B, S, din),
    new_prev)."""
    dc = w.shape[0]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(dc))
    new_prev = xp[:, -(dc - 1):].clone() if dc > 1 else prev
    return y, new_prev


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus forms it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _assoc_scan(a, b):
    """Inclusive scan along axis 1 under (a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2), in log2(L) doubling steps (the reference's
    jax.lax.associative_scan; another association order, the same
    operator)."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def _ssm_chunk(h0, a, bx, c):
    """One chunk. h0: (B, din, ds); a: (B, L, din, ds) decay exp(dt*A);
    bx: (B, L, din, ds) input injections; c: (B, L, ds). Returns (y (B,
    L, din), h_end)."""
    a_sc, b_sc = _assoc_scan(a, bx)
    h = a_sc * h0[:, None] + b_sc
    y = torch.einsum("blds,bls->bld", h, c)
    return y, h[:, -1]


def _ssm_chunked(xin, dt, a, b_t, c_t, h0):
    """The reference model's scan region on the plain path."""
    s = xin.shape[1]
    decay = torch.exp(dt[..., None] * a)  # (B, S, din, ds)
    inject = (dt * xin)[..., None] * b_t[:, :, None, :]
    if s == 1:  # decode fast path
        h = decay[:, 0] * h0 + inject[:, 0]
        return torch.einsum("bds,bs->bd", h, c_t[:, 0])[:, None], h
    chunk = min(CHUNK, s)
    while s % chunk:
        chunk //= 2
    if xin.is_meta:
        # the dry-run's count (no values to carry): every chunk's scan in
        # one batched pass, the same elementwise work as the loop below in
        # S / chunk times fewer ops
        b, n = xin.shape[0], s // chunk
        a_sc, b_sc = _assoc_scan(*(t.reshape((b * n, chunk) + t.shape[2:])
                                   for t in (decay, inject)))
        h = a_sc.reshape(decay.shape) * h0[:, None] + \
            b_sc.reshape(decay.shape)
        return torch.einsum("blds,bls->bld", h, c_t), h[:, -1]
    ys, h = [], h0
    for c in range(0, s, chunk):
        y, h = _ssm_chunk(h, decay[:, c:c + chunk], inject[:, c:c + chunk],
                          c_t[:, c:c + chunk])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_mix(params, x, cfg, *, state=None, impl: str = "torch"):
    """x: (B, S, d) -> (out, new_state); state: {"h" (B, din, ds) f32,
    "conv" (B, dc-1, din)} or None (zeros). With impl "cuda" a given
    state's "h" is updated in place and returned as new_state["h"]."""
    b, s, _ = x.shape
    din, ds, dc = cfg.d_inner, cfg.d_state, cfg.d_conv
    xz = x @ params["in_proj"]
    xin, z = xz[..., :din], xz[..., din:]
    conv_prev = state["conv"] if state is not None else \
        torch.zeros((b, dc - 1, din), dtype=x.dtype, device=x.device)
    xin, conv_new = _causal_conv(xin, params["conv_w"], conv_prev)
    xin = L._silu(xin).float()

    proj = xin @ params["x_proj"].float()
    b_t, c_t, dt_in = proj[..., :ds], proj[..., ds:2 * ds], proj[..., -1]
    dt = _softplus(dt_in[..., None] + params["dt_bias"])  # (B, S, din)
    a = -torch.exp(params["a_log"])  # (din, ds)

    if impl == "cuda":
        st = None if state is None else state["h"]
        y, h_end = ssm_ops.selective_scan(xin, dt, a, b_t.contiguous(),
                                          c_t.contiguous(), st, impl="cuda",
                                          state_out=st)
    else:
        h0 = state["h"].float() if state is not None else \
            torch.zeros((b, din, ds), dtype=torch.float32, device=x.device)
        y, h_end = _ssm_chunked(xin, dt, a, b_t, c_t, h0)

    y = y + params["d_skip"] * xin
    out = (y.to(x.dtype) * L._silu(z)) @ params["out_proj"]
    return out, {"h": h_end, "conv": conv_new}


def init_mamba_state(cfg, batch: int, dtype, device):
    """One layer's recurrent state: h in f32, the conv carry in
    ``dtype``."""
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }
