"""RWKV-6 (Finch) block (port of ``repro/models/rwkv6.py``):
data-dependent-decay linear attention (WKV6), token shift and the
squared-ReLU channel mix.

Recurrence per head (state S: (hd_k, hd_v)):
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + tanh(x_w A) B)) per channel.

The WKV region is what the reference marks ``wkv_scan_kernel``: with
impl "cuda" it is the kernel (``kernels/wkv_scan``) for every sequence
length, a single-token decode step included, and a given state's "s" is
updated in place (the kernel's s0 and s_L are the same tensor). With
impl "torch" it is the reference's own formulation: chunks of the exact
intra-chunk decay form (``_wkv_chunk``) for S > 1, its fast path for
S == 1. dtypes follow the reference: r, k, v and the log-decay in f32,
mu cast to x's dtype, the LoRA decay in f32 clipped to [-8, 4], the WKV
output cast to x's dtype before the group norm.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv_scan import ops as wkv_ops
from repro_torch.models import layers as L

CHUNK = 32
MU_NAMES = ("r", "k", "v", "g", "w", "ck", "cr")


def init_rwkv(gen, cfg, dtype, device, stack: int):
    """The reference's leaves and inits (mu 0.5, w0 -0.7, w_lora_b 0,
    u 0.5), each stacked on a leading axis of ``stack`` layers."""
    d, ff = cfg.d_model, cfg.d_ff
    h, hd, lora = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_lora_dim

    def full(shape, value):
        return torch.full((stack,) + shape, value, dtype=torch.float32,
                          device=device)

    def dense(shape, dt=dtype):
        return L.dense_init(gen, shape, shape[0], dt, device, stack)

    return {
        "mu": {n: full((d,), 0.5) for n in MU_NAMES},
        "wr": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
        "wg": dense((d, d)), "wo": dense((d, d)),
        "w0": full((d,), -0.7),
        "w_lora_a": dense((d, lora), torch.float32),
        "w_lora_b": full((lora, d), 0.0),
        "u": full((h, hd), 0.5),
        "ln_x_scale": full((d,), 1.0),
        "ln_x_bias": full((d,), 0.0),
        "cm_wk": dense((d, ff)), "cm_wv": dense((ff, d)),
        "cm_wr": dense((d, d)),
    }


def _shift(x, prev):
    """Token shift: x_{t-1} with ``prev`` (B, d) seeding position 0."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _wkv_chunk(s0, r, k, v, lw, u):
    """Exact intra-chunk WKV6 over one chunk (the reference's): r, k, v,
    lw (B, L, H, hd), s0 (B, H, hd, hd). Every exp() argument is a sum of
    log-decays, hence <= 0; entries outside the strict lower triangle are
    -inf before the exp. Returns (out (B, L, H, hd), s_end)."""
    l = r.shape[1]
    lw_inc = torch.cumsum(lw, dim=1)           # sum_{p<=t}
    lw_exc = lw_inc - lw                       # sum_{p<t}
    lw_last = lw_inc[:, -1:]                   # sum over the chunk
    arg = lw_exc[:, :, None] - lw_inc[:, None, :, :]  # (B, t, s, H, hd)
    tril = torch.tril(torch.ones((l, l), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    arg = torch.where(tril[None, :, :, None, None], arg, float("-inf"))
    scores = torch.einsum("bthc,bshc,btshc->bths", r, k, torch.exp(arg))
    out = torch.einsum("bths,bshc->bthc", scores, v)
    out = out + torch.einsum("bthc,hc,bthc->bth", r, u, k)[..., None] * v
    out = out + torch.einsum("bthk,bhkv->bthv", r * torch.exp(lw_exc), s0)
    k_dec = k * torch.exp(lw_last - lw_inc)
    s_end = torch.exp(lw_last)[:, 0][..., None] * s0 \
        + torch.einsum("bshk,bshv->bhkv", k_dec, v)
    return out, s_end


def _wkv_chunked(r, k, v, lw, u, s0):
    """The reference model's WKV region on the plain path."""
    s = r.shape[1]
    if s == 1:  # decode fast path
        r0, k0, v0 = r[:, 0], k[:, 0], v[:, 0]
        out = torch.einsum("bhk,bhkv->bhv", r0, s0) \
            + torch.einsum("bhc,hc,bhc->bh", r0, u, k0)[..., None] * v0
        s_end = torch.exp(lw[:, 0])[..., None] * s0 \
            + torch.einsum("bhk,bhv->bhkv", k0, v0)
        return out[:, None], s_end
    chunk = min(CHUNK, s)
    while s % chunk:
        chunk //= 2
    if r.is_meta:
        # the dry-run's count (no values to carry): every chunk in one
        # batched pass, the same work as the loop below in S / chunk times
        # fewer ops
        b, n = r.shape[0], s // chunk
        out, s_end = _wkv_chunk(
            s0[:, None].expand((b, n) + s0.shape[1:]).reshape(
                (b * n,) + s0.shape[1:]),
            *(t.reshape((b * n, chunk) + t.shape[2:]) for t in (r, k, v, lw)),
            u)
        return out.reshape(r.shape), \
            s_end.reshape((b, n) + s_end.shape[1:])[:, -1]
    outs = []
    for c in range(0, s, chunk):
        out_c, s0 = _wkv_chunk(s0, r[:, c:c + chunk], k[:, c:c + chunk],
                               v[:, c:c + chunk], lw[:, c:c + chunk], u)
        outs.append(out_c)
    return torch.cat(outs, dim=1), s0


def rwkv_time_mix(params, x, cfg, *, state=None, impl: str = "torch"):
    """x: (B, S, d) -> (out, new_state); state: {"shift" (B, d), "s" (B,
    H, hd, hd) f32} or None (zeros). With impl "cuda" a given state's "s"
    is updated in place and returned as new_state["s"]."""
    b, s, d = x.shape
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    prev = state["shift"] if state is not None else \
        torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _shift(x, prev)
    mu = params["mu"]
    xr, xk, xv = _mix(x, xs, mu["r"]), _mix(x, xs, mu["k"]), \
        _mix(x, xs, mu["v"])
    xg, xw = _mix(x, xs, mu["g"]), _mix(x, xs, mu["w"])

    r = (xr @ params["wr"]).reshape(b, s, h, hd).float()
    k = (xk @ params["wk"]).reshape(b, s, h, hd).float()
    v = (xv @ params["wv"]).reshape(b, s, h, hd).float()
    g = L._silu(xg @ params["wg"])

    # Finch data-dependent decay via LoRA; log w in [-e^4, ~-0.0017]
    lw_raw = params["w0"] + torch.tanh(
        xw.float() @ params["w_lora_a"]) @ params["w_lora_b"]
    lw = -torch.exp(torch.clamp(lw_raw, -8.0, 4.0)).reshape(b, s, h, hd)

    if impl == "cuda":
        st = None if state is None else state["s"]
        out, s_end = wkv_ops.wkv(r, k, v, lw, params["u"], st, impl="cuda",
                                 state_out=st)
    else:
        s0 = state["s"].float() if state is not None else \
            torch.zeros((b, h, hd, hd), dtype=torch.float32,
                        device=x.device)
        out, s_end = _wkv_chunked(r, k, v, lw, params["u"], s0)

    out = L.layer_norm(out.reshape(b, s, d).to(x.dtype),
                       params["ln_x_scale"], params["ln_x_bias"],
                       cfg.norm_eps)
    out = (out * g) @ params["wo"]
    return out, {"shift": x[:, -1], "s": s_end}


def rwkv_channel_mix(params, x, cfg, *, state=None):
    """x: (B, S, d) -> (out, new shift (B, d))."""
    b, _, d = x.shape
    prev = state if state is not None else \
        torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _shift(x, prev)
    xk = _mix(x, xs, params["mu"]["ck"])
    xr = _mix(x, xs, params["mu"]["cr"])
    kk = torch.relu(xk @ params["cm_wk"])
    out = torch.sigmoid(xr @ params["cm_wr"]) * ((kk * kk) @ params["cm_wv"])
    return out, x[:, -1]


def init_rwkv_state(cfg, batch: int, dtype, device):
    """One layer's recurrent state: the shifts in ``dtype``, s in f32."""
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return {
        "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        "s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        "shift_c": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
    }
