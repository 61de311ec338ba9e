"""Layer assembly (port of ``repro/models/transformer.py``: the dense
attention and the RWKV-6 layers).

Each layer is pre-norm residual:
  attn : x += Attn(RMS(x));    x += MLP(RMS(x))
  rwkv : x += TimeMix(RMS(x)); x += ChannelMix(RMS(x))
Mamba mixers and MoE FFNs raise ``NotImplementedError`` naming ROADMAP
queue A item 4. Parameters and caches keep the reference's layout: every
leaf stacked on a leading superlayer axis, so ``layer_params(stack, l)``
views layer l. Decode writes every cache leaf IN PLACE (the reference
returns a new cache).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RW


def check_supported(cfg):
    """Raise for the architectures the port does not carry yet."""
    for idx, kind in enumerate(cfg.layer_pattern):
        if kind not in ("attn", "rwkv"):
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} mixers are not ported yet (ROADMAP "
                "queue A item 4, models: mamba)")
        if cfg.is_moe_layer(idx):
            raise NotImplementedError(
                f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP queue A "
                "item 4, models: moe)")


def layer_params(tree, l: int):
    """View of superlayer ``l`` of a stacked parameter or cache tree (a
    leaf may also be a list of per-layer tensors, as training holds it)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def layer_fwd(p, x, cfg, kind: str, *, positions, attn_impl: str, packed,
              collect_state: bool, block: int = 64):
    """One layer over a full sequence (packed prefill batch or training
    rows). Returns (x, state): with collect_state an attention layer's
    rotated {"k", "v"}, an rwkv layer's {"shift", "s", "shift_c"}."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "rwkv":
        out, st = RW.rwkv_time_mix(p["mixer"], h, cfg, impl=attn_impl)
        x = x + out
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        out2, shift_c = RW.rwkv_channel_mix(p["mixer"], h2, cfg)
        return x + out2, (dict(st, shift_c=shift_c) if collect_state
                          else None)
    out, k, v = L.attention(p["mixer"], h, cfg, positions=positions,
                            attn_impl=attn_impl, packed=packed, block=block)
    x = x + out
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + L.mlp(p["ffn"], h2, cfg)
    return x, ({"k": k, "v": v} if collect_state else None)


def layer_decode(p, x, cfg, kind: str, cache, pos, decode_tbl=None,
                 decode_spec=None, attn_impl: str = "cuda"):
    """x: (B, 1, d); cache: this layer's leaves (written in place).
    decode_spec selects the packed mixed-position attention decode;
    attn_impl picks the rwkv layer's WKV impl."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "rwkv":
        out, st = RW.rwkv_time_mix(
            p["mixer"], h, cfg, state={"shift": cache["shift"],
                                       "s": cache["s"]}, impl=attn_impl)
        x = x + out
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        out2, shift_c = RW.rwkv_channel_mix(p["mixer"], h2, cfg,
                                            state=cache["shift_c"])
        for name, new in dict(st, shift_c=shift_c).items():
            if new is not cache[name]:
                cache[name].copy_(new)
        return x + out2
    if decode_spec is not None:
        out, _, _ = L.packed_decode_attention(
            p["mixer"], h, cfg, cache_k=cache["k"], cache_v=cache["v"],
            pos=pos, decode_tbl=decode_tbl, decode_spec=decode_spec)
    else:
        out, _, _ = L.decode_attention(p["mixer"], h, cfg,
                                       cache_k=cache["k"],
                                       cache_v=cache["v"], pos=pos)
    x = x + out
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp(p["ffn"], h2, cfg)


def layer_fused(p, x_pack, x_dec, cfg, cache, pos, *, pack_positions,
                packed, fused_tbl, fused_spec):
    """One layer of the fused step: both streams share the layer's
    weights, the attention makes ONE fused launch, and the MLP runs on
    each stream separately. Returns (x_pack, x_dec, {"k", "v"} pack
    states); the decode half writes its token's k/v into ``cache`` in
    place."""
    h_p = L.rms_norm(x_pack, p["norm1"], cfg.norm_eps)
    h_d = L.rms_norm(x_dec, p["norm1"], cfg.norm_eps)
    out_p, out_d, k, v, _, _ = L.fused_attention(
        p["mixer"], h_p, h_d, cfg, pack_positions=pack_positions,
        packed=packed, cache_k=cache["k"], cache_v=cache["v"], pos=pos,
        fused_tbl=fused_tbl, fused_spec=fused_spec)
    x_pack = x_pack + out_p
    x_dec = x_dec + out_d
    h2_p = L.rms_norm(x_pack, p["norm2"], cfg.norm_eps)
    h2_d = L.rms_norm(x_dec, p["norm2"], cfg.norm_eps)
    x_pack = x_pack + L.mlp(p["ffn"], h2_p, cfg)
    x_dec = x_dec + L.mlp(p["ffn"], h2_d, cfg)
    return x_pack, x_dec, {"k": k, "v": v}


def init_cache(cfg, batch: int, max_len: int, dtype, device):
    """Per pattern slot, stacked on the superlayer axis: an attention
    layer's k/v (n_superlayers, B, S, Hkv, hd), an rwkv layer's shift,
    s (f32) and shift_c."""
    check_supported(cfg)
    n = cfg.n_superlayers
    cache = {}
    for p, kind in enumerate(cfg.layer_pattern):
        if kind == "rwkv":
            cache[f"l{p}"] = {
                name: leaf.new_zeros((n,) + tuple(leaf.shape))
                for name, leaf in RW.init_rwkv_state(cfg, batch, dtype,
                                                     device).items()}
            continue
        s = max_len if cfg.sliding_window is None \
            else min(cfg.sliding_window, max_len)
        shape = (n, batch, s, cfg.n_kv_heads, cfg.head_dim)
        cache[f"l{p}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache
