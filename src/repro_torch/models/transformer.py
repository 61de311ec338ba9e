"""Layer assembly (port of ``repro/models/transformer.py``: the
attention, Mamba and RWKV-6 layers).

Each layer is pre-norm residual:
  attn : x += Attn(RMS(x));    x += FFN_or_MoE(RMS(x))
  mamba: x += Mamba(RMS(x));   x += FFN_or_MoE(RMS(x))   (jamba style)
  rwkv : x += TimeMix(RMS(x)); x += ChannelMix(RMS(x))
MoE placement follows ``cfg.is_moe_layer(pattern index)``. Parameters
and caches keep the reference's layout: every leaf stacked on a leading
superlayer axis, so ``layer_params(stack, l)`` views layer l. Decode
writes every cache leaf IN PLACE (the reference returns a new cache) and
runs MoE drop-free, as the reference's does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.tri_attn import kernel as attn_kernel
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RW

KINDS = ("attn", "mamba", "rwkv")


def check_supported(cfg):
    """Raise for the architectures the port does not carry."""
    for kind in cfg.layer_pattern:
        if kind not in KINDS:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} mixers are not ported (known: "
                f"{KINDS})")


def check_kernel_head_dim(cfg, impl: str):
    """Refuse, before anything is built or launched, an architecture
    whose attention head dim the kernels have no body for: impl "cuda"
    only, attention layers only. Every attention body, forward and
    backward, takes the same head dims (``kernel.HEAD_DIMS``, nemotron-4's
    192 among them), so serving and training ask the same question."""
    if impl != "cuda" or "attn" not in cfg.layer_pattern:
        return
    if cfg.head_dim not in attn_kernel.HEAD_DIMS:
        raise NotImplementedError(
            f"{cfg.name}: head dim {cfg.head_dim} has no attention kernel "
            f"body (the kernels take head dims {attn_kernel.HEAD_DIMS}); run "
            f"impl='torch' (the plain versions)")


def layer_params(tree, l: int):
    """View of superlayer ``l`` of a stacked parameter or cache tree (a
    leaf may also be a list of per-layer tensors, as training holds it)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def _ffn(p, x, cfg, p_idx: int, full_capacity: bool):
    """The layer's FFN: (out, aux), MoE where ``cfg.is_moe_layer``."""
    if cfg.is_moe_layer(p_idx):
        return MOE.moe_mlp(p["ffn"], x, cfg, full_capacity=full_capacity)
    return L.mlp(p["ffn"], x, cfg), None


def layer_fwd(p, x, cfg, kind: str, p_idx: int, *, positions,
              attn_impl: str, packed, collect_state: bool, block: int = 64,
              full_capacity: bool = False, prefix: int = 0,
              scan_impl: str | None = None):
    """One layer over a full sequence (packed prefill batch or training
    rows). Returns (x, aux, state): aux the MoE load-balance loss (None
    without MoE); with collect_state an attention layer's rotated {"k",
    "v"}, a mamba layer's {"h", "conv"}, an rwkv layer's {"shift", "s",
    "shift_c"}. full_capacity: drop-free MoE (serving semantics: a
    prefill that drops tokens diverges from the decode it seeds).
    prefix: the prefix-causal rows of a non-packed attention (a vision
    prefix). scan_impl: the rwkv and mamba layers' scan impl, attn_impl
    unless given."""
    scan_impl = scan_impl or attn_impl
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "rwkv":
        out, st = RW.rwkv_time_mix(p["mixer"], h, cfg, impl=scan_impl)
        x = x + out
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        out2, shift_c = RW.rwkv_channel_mix(p["mixer"], h2, cfg)
        return x + out2, None, (dict(st, shift_c=shift_c) if collect_state
                                else None)
    if kind == "mamba":
        out, st = MB.mamba_mix(p["mixer"], h, cfg, impl=scan_impl)
    else:
        out, k, v = L.attention(p["mixer"], h, cfg, positions=positions,
                                attn_impl=attn_impl, packed=packed,
                                block=block, prefix=prefix)
        st = {"k": k, "v": v}
    x = x + out
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    out2, aux = _ffn(p, h2, cfg, p_idx, full_capacity)
    return x + out2, aux, (st if collect_state else None)


def layer_decode(p, x, cfg, kind: str, p_idx: int, cache, pos,
                 decode_tbl=None, decode_spec=None, attn_impl: str = "cuda"):
    """x: (B, 1, d); cache: this layer's leaves (written in place).
    decode_spec selects the packed mixed-position attention decode;
    attn_impl picks the rwkv and mamba layers' scan impl."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "rwkv":
        out, st = RW.rwkv_time_mix(
            p["mixer"], h, cfg, state={"shift": cache["shift"],
                                       "s": cache["s"]}, impl=attn_impl)
        x = x + out
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        out2, shift_c = RW.rwkv_channel_mix(p["mixer"], h2, cfg,
                                            state=cache["shift_c"])
        _write_state(cache, dict(st, shift_c=shift_c))
        return x + out2
    if kind == "mamba":
        out, st = MB.mamba_mix(p["mixer"], h, cfg, state=cache,
                               impl=attn_impl)
        _write_state(cache, st)
    elif decode_spec is not None:
        out, _, _ = L.packed_decode_attention(
            p["mixer"], h, cfg, cache_k=cache["k"], cache_v=cache["v"],
            pos=pos, decode_tbl=decode_tbl, decode_spec=decode_spec)
    else:
        out, _, _ = L.decode_attention(p["mixer"], h, cfg,
                                       cache_k=cache["k"],
                                       cache_v=cache["v"], pos=pos)
    x = x + out
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h2, cfg, p_idx, full_capacity=True)[0]


def _write_state(cache, new):
    """Copy a recurrent layer's new state into its cache leaves (a leaf
    the kernel already updated in place is skipped)."""
    for name, t in new.items():
        if t is not cache[name]:
            cache[name].copy_(t)


def layer_fused(p, x_pack, x_dec, cfg, p_idx: int, cache, pos, *,
                pack_positions, packed, fused_tbl, fused_spec):
    """One layer of the fused step: both streams share the layer's
    weights, the attention makes ONE fused launch, and the FFN runs on
    each stream separately (MoE drop-free on both). Returns (x_pack,
    x_dec, {"k", "v"} pack states); the decode half writes its token's
    k/v into ``cache`` in place."""
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
    x_pack = x_pack + _ffn(p, h2_p, cfg, p_idx, full_capacity=True)[0]
    x_dec = x_dec + _ffn(p, h2_d, cfg, p_idx, full_capacity=True)[0]
    return x_pack, x_dec, {"k": k, "v": v}


def init_cache(cfg, batch: int, max_len: int, dtype, device):
    """Per pattern slot, stacked on the superlayer axis: an attention
    layer's k/v (n_superlayers, B, S, Hkv, hd), a mamba layer's h (f32)
    and conv carry, an rwkv layer's shift, s (f32) and shift_c."""
    check_supported(cfg)
    n = cfg.n_superlayers
    cache = {}
    for p, kind in enumerate(cfg.layer_pattern):
        if kind in ("rwkv", "mamba"):
            init = RW.init_rwkv_state if kind == "rwkv" else \
                MB.init_mamba_state
            cache[f"l{p}"] = {
                name: leaf.new_zeros((n,) + tuple(leaf.shape))
                for name, leaf in init(cfg, batch, dtype, device).items()}
            continue
        s = max_len if cfg.sliding_window is None \
            else min(cfg.sliding_window, max_len)
        shape = (n, batch, s, cfg.n_kv_heads, cfg.head_dim)
        cache[f"l{p}"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache
