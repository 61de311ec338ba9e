"""Shared model layers: RMS norm, RoPE, GQA attention, the swiglu MLP.

Port of the dense-attention part of ``repro/models/layers.py``. Parameters
are plain dicts of tensors. The large projections stay ``torch.matmul``,
as the reference leaves them to XLA; attention goes through the packed
ops (``kernels/tri_attn/ops.py``). Decode writes the new token's k/v into
the cache IN PLACE (the reference returns a new cache): a cache row at or
beyond a slot's current position is never read before the step that owns
that position rewrites it, so repeated or abandoned writes are harmless.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.tri_attn import ops as attn_ops
from repro_torch.kernels.tri_attn import ref as attn_ref


def rms_norm(x, scale, eps=1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """Half-split RoPE. x: (..., S, n_heads, head_dim); positions: (S,)
    or (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.split(x.float(), hd // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attention(params, x, cfg, *, positions, attn_impl: str, packed=None,
              block: int = 64):
    """Full-sequence attention (training and prefill). x: (B, S, d).

    Without ``packed`` each row of the batch is one causal (banded under
    cfg.sliding_window) sequence through ``triangular_attention`` at tile
    edge ``block`` (halved until it divides S), differentiable. With
    ``packed`` (a PackedTriSched) S is the concatenation of a request
    batch, positions restart per request, and attention is block-diagonal
    per request. Returns (out (B, S, d), k, v) with k/v (B, S, Hkv, hd)
    rotated, ready to seed a decode cache."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, hkv, hd)
    v = (x @ params["wv"]).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if packed is not None:
        ot = attn_ops.packed_prefill_attention(qt, kt, vt, packed,
                                               impl=attn_impl)
    else:
        blk = block
        while s % blk:
            blk //= 2
        # a single tile goes to the oracle, as in the reference, except on
        # the kernel path, which runs the kernel even for one tile
        impl = "ref" if attn_impl == "torch" and s <= blk else attn_impl
        ot = attn_ops.triangular_attention(qt, kt, vt,
                                           window=cfg.sliding_window,
                                           impl=impl, block=blk)
    ctx = ot.transpose(1, 2).reshape(b, s, h * hd)
    return ctx @ params["wo"], k, v


def _decode_qkv(params, x, cfg, cache_k, cache_v, pos):
    """Project and rotate the new token and write its k/v into each
    slot's cache row pos % S_cache (in place). Returns (q (B, 1, H, hd),
    cache_k, cache_v, pos (B,))."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_cache = cache_k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(b)
    q = (x @ params["wq"]).reshape(b, 1, h, hd)
    k = (x @ params["wk"]).reshape(b, 1, hkv, hd)
    v = (x @ params["wv"]).reshape(b, 1, hkv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    slot = (pos % s_cache).long()
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    return q, cache_k, cache_v, pos


def decode_attention(params, x, cfg, *, cache_k, cache_v, pos):
    """Lockstep single-token decode against the full cache (the plain
    decode_mode="lockstep" and the sequential prefill). x: (B, 1, d); cache_k/v: (B, S_cache, Hkv, hd);
    pos: scalar or (B,). Returns (out (B, 1, d), cache_k, cache_v)."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_cache = cache_k.shape[1]
    q, cache_k, cache_v, pos = _decode_qkv(params, x, cfg, cache_k, cache_v,
                                           pos)
    slots = torch.arange(s_cache, device=x.device)
    if cfg.sliding_window is not None:
        slot_pos = pos[:, None] - torch.remainder(pos[:, None] - slots,
                                                  s_cache)
        valid = slot_pos >= 0
    else:
        valid = slots[None, :] <= pos[:, None]
    g = h // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          cache_k.float()) / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         attn_ref.NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, cache_v.float())
    out = o.reshape(b, 1, h * hd).to(x.dtype) @ params["wo"]
    return out, cache_k, cache_v


def packed_decode_attention(params, x, cfg, *, cache_k, cache_v, pos,
                            decode_tbl, decode_spec):
    """Packed mixed-position decode: the projections and cache write of
    decode_attention, attention over each live slot's own valid KV prefix
    in one launch (decode_tbl the round's (5, R) table on the device,
    decode_spec its static half). Slots without a live member get zero
    attention output."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q, cache_k, cache_v, _ = _decode_qkv(params, x, cfg, cache_k, cache_v,
                                         pos)
    ot = attn_ops.packed_decode_attention(q[:, 0].contiguous(), cache_k,
                                          cache_v, decode_tbl, decode_spec)
    out = ot.reshape(b, 1, h * hd).to(x.dtype) @ params["wo"]
    return out, cache_k, cache_v


def fused_attention(params, x_pack, x_dec, cfg, *, pack_positions, packed,
                    cache_k, cache_v, pos, fused_tbl, fused_spec):
    """Fused continuous-batching attention: ONE launch covers the round's
    admitted prompts (x_pack (1, S_pack, d), packed block-diagonal
    self-attention as in ``attention``) and every live decode slot (x_dec
    (B, 1, d), each over its own valid KV prefix as in
    ``packed_decode_attention``, with the same projections and in-place
    cache write). Returns (out_pack (1, S_pack, d), out_dec (B, 1, d),
    k_pack, v_pack (1, S_pack, Hkv, hd) rotated for the admit splice,
    cache_k, cache_v)."""
    b = x_dec.shape[0]
    s = x_pack.shape[1]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x_pack @ params["wq"]).reshape(1, s, h, hd)
    k = (x_pack @ params["wk"]).reshape(1, s, hkv, hd)
    v = (x_pack @ params["wv"]).reshape(1, s, hkv, hd)
    q = apply_rope(q, pack_positions, cfg.rope_theta)
    k = apply_rope(k, pack_positions, cfg.rope_theta)
    q_dec, cache_k, cache_v, _ = _decode_qkv(params, x_dec, cfg, cache_k,
                                             cache_v, pos)
    op, od = attn_ops.fused_step_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), q_dec[:, 0].contiguous(), cache_k,
        cache_v, fused_tbl, packed, fused_spec)
    out_pack = op.transpose(1, 2).reshape(1, s, h * hd) @ params["wo"]
    out_dec = od.reshape(b, 1, h * hd).to(x_dec.dtype) @ params["wo"]
    return out_pack, out_dec, k, v, cache_k, cache_v


def mlp(params, x, cfg):
    if cfg.mlp_activation != "swiglu":
        raise NotImplementedError(
            f"mlp_activation={cfg.mlp_activation!r}: only swiglu is ported "
            "(ROADMAP queue A, models)")
    return (_silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]


def _silu(x):
    """x * (1 / (1 + exp(-x))), one rounding per op: the reference's XLA
    lowering of jax.nn.silu, so bfloat16 activations round alike."""
    return x * torch.reciprocal(1 + torch.exp(-x))
