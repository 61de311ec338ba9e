"""Top-level model: embedding -> layers -> norm -> LM head.

Port of ``repro/models/model.py`` for every architecture of the registry
(dense and MoE attention, RWKV-6, the Mamba/attention hybrid, and the
audio and vision stub frontends):
  init_params(cfg, seed, device)             -> params
  params_from_jax(np_params, cfg, device)    -> params (reference weights)
  embed_inputs(params, cfg, batch)           -> (B, S, d) embeddings
  forward(params, cfg, batch, ...)           -> (hidden, aux, states)
  logits_from_hidden(params, cfg, hidden)    -> (B, S, padded_vocab) f32
  loss_fn(params, cfg, batch, ...)           -> (loss, {"ce", "aux"})
  init_cache(cfg, batch, max_len, dtype, device)
  decode_step(params, cfg, cache, tok, pos)  -> (logits, cache)
  prefill_cache(params, cfg, batch, max_len) -> (hidden, cache)
  fused_step(params, cfg, cache, ...)        -> (logits_admit, logits_dec,
                                                 cache, states)
A batch holds "tokens" (B, S_tok) and/or "embeds" (B, P, d) (the stub
frontends' precomputed audio frames, alone, or vision patches, placed
before the tokens), "labels" (B, S) and an optional "mask" (B, S) of
loss weights. A vision prefix (cfg.n_patches) makes the non-packed
attention prefix-causal over the first n_patches rows.
Params keep the reference pytree layout (``layers`` stacked on a leading
superlayer axis), so reference weights carry over leaf for leaf. Training
hands ``forward`` each stacked leaf as a list of per-layer tensors instead
(``train.train_step.trainable``), so autograd keeps one gradient per layer
rather than zero-filling the whole stack for every layer it indexes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as DEV
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RW
from repro_torch.models import transformer as T

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def init_params(cfg, seed: int = 0, device=DEV.DEFAULT_DEVICE):
    """Random weights from a seeded ``torch.Generator`` on ``device``.
    They are not the reference's draws: tests carry reference weights
    over with ``params_from_jax``. On ``"meta"`` (the dry-run's params
    specs) the leaves hold shapes and dtypes only and nothing is drawn: a
    meta device has no generator."""
    T.check_supported(cfg)
    dev = DEV.resolve(device)
    dtype = param_dtype(cfg)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    d, vp, n = cfg.d_model, cfg.padded_vocab, cfg.n_superlayers
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=dev)
    dense = lambda shape, fan_in: L.dense_init(gen, shape, fan_in, dtype,
                                               dev, n)
    layers = {}
    for p, kind in enumerate(cfg.layer_pattern):
        if kind == "rwkv":  # the channel mix lives in the mixer dict
            layers[f"l{p}"] = {"norm1": ones(n, d),
                               "mixer": RW.init_rwkv(gen, cfg, dtype, dev, n),
                               "norm2": ones(n, d)}
            continue
        if kind == "mamba":
            mixer = MB.init_mamba(gen, cfg, dtype, dev, n)
        else:
            mixer = {
                "wq": dense((d, h * hd), d),
                "wk": dense((d, hkv * hd), d),
                "wv": dense((d, hkv * hd), d),
                "wo": dense((h * hd, d), h * hd),
            }
        ffn = MOE.init_moe(gen, cfg, dtype, dev, n) if cfg.is_moe_layer(p) \
            else L.init_mlp(gen, cfg, dtype, dev, n)
        layers[f"l{p}"] = {"norm1": ones(n, d), "mixer": mixer,
                           "norm2": ones(n, d), "ffn": ffn}
    params = {
        "embed": torch.randn((vp, d), generator=gen, device=dev)
                 .mul_(0.02).to(dtype),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, vp), d, dtype, dev)
    return params


def params_from_jax(np_params, cfg, device=DEV.DEFAULT_DEVICE):
    """Reference params (the JAX pytree as numpy arrays: ``embed``,
    ``layers`` stacked on the superlayer axis, ``final_norm``,
    ``lm_head``) -> the port's params on ``device``. Each leaf keeps its
    reference dtype (bfloat16 leaves go through exact float32)."""
    T.check_supported(cfg)
    dev = DEV.resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        dtype = torch.bfloat16 if str(x.dtype) == "bfloat16" else \
            torch.float32
        return torch.as_tensor(np.array(x, np.float32),
                               device=dev).to(dtype)

    return conv(dict(np_params))


def embed_inputs(params, cfg, batch):
    """Token embeddings, after the stub frontend's "embeds" (cast to the
    params' dtype) when the batch has them."""
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(param_dtype(cfg)))
    if batch.get("tokens") is not None:
        # F.embedding, not indexing: its backward sums each row's grads in
        # a fixed order (indexing's accumulates them in thread order on
        # the CPU)
        parts.append(torch.nn.functional.embedding(batch["tokens"],
                                                   params["embed"]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def forward(params, cfg, batch, *, attn_impl: str = "cuda",
            collect_state: bool = False, positions=None, packed=None,
            remat: bool = False, block: int = 64,
            full_capacity: bool = False, scan_impl: str | None = None):
    """Returns (hidden (B, S, d), aux, states_or_None); aux sums the MoE
    layers' load-balance losses; states stack each layer's state leaves
    (an attention layer's rotated k/v, a mamba layer's h and conv carry,
    an rwkv layer's shifts and WKV state) on a leading superlayer axis,
    as the reference's scan does; ``attn_impl`` also picks the WKV and
    selective-scan impl unless ``scan_impl`` is given; ``full_capacity`` keeps every MoE slot, no
    token dropped at the capacity factor (serving semantics).
    Serving prefill passes the packed schedule and positions restarting
    per request. ``remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` with ``nothing_saveable``): only the
    layer inputs are kept. ``block`` is the attention tile edge of the
    non-packed path; the reference's training default is 512, which the
    kernels do not take, so the port's is 64 (the serving tile)."""
    x = embed_inputs(params, cfg, batch)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    prefix = cfg.n_patches if cfg.frontend == "vision_patches" else 0
    per_layer = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_superlayers):
        lp = T.layer_params(params["layers"], l)

        def superlayer(x, aux, lp=lp):
            states = {}
            for p, kind in enumerate(cfg.layer_pattern):
                x, a, states[f"l{p}"] = T.layer_fwd(
                    lp[f"l{p}"], x, cfg, kind, p, positions=positions,
                    attn_impl=attn_impl, packed=packed,
                    collect_state=collect_state, block=block,
                    full_capacity=full_capacity, prefix=prefix,
                    scan_impl=scan_impl)
                if a is not None:
                    aux = aux + a
            return x, aux, states

        if remat:
            x, aux, states = checkpoint(superlayer, x, aux,
                                        use_reentrant=False)
        else:
            x, aux, states = superlayer(x, aux)
        per_layer.append(states)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_state:
        return x, aux, None
    return x, aux, _stack_states(per_layer)


def _stack_states(per_layer):
    """[{pattern slot: {leaf: tensor}}] per superlayer -> each leaf stacked
    on a leading superlayer axis."""
    return {slot: {name: torch.stack([st[slot][name] for st in per_layer])
                   for name in leaves}
            for slot, leaves in per_layer[0].items()}


def logits_from_hidden(params, cfg, hidden):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (hidden @ head).float()


def cross_entropy(logits, labels, mask, vocab_size: int):
    """Mean cross entropy over masked positions. logits f32 (B, S, Vp);
    labels (B, S). Padded-vocab logits are masked to the f32 minimum so
    they absorb no probability mass."""
    vp = logits.shape[-1]
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, float(np.finfo(np.float32).min))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg, batch, *, attn_impl: str = "cuda",
            remat: bool = True, aux_weight: float = 0.01, block: int = 64,
            packed=None, scan_impl: str | None = None):
    """Next-token loss of a batch ("tokens" and/or "embeds", "labels"
    (B, S), an optional "mask" of loss weights, 0 on a vision prefix).
    Returns (loss, {"ce", "aux"}).

    ``packed`` (a PackedTriSched) trains on bin-packed documents
    (train/data.PackedDocsLM): tokens are then (B, S_total), the
    documents concatenated, attention is block-diagonal per document
    (packed dq and dk/dv in the backward), ``batch["positions"]`` (B,
    S_total) restarts per document and ``batch["mask"]`` is 0 on the pad
    rows."""
    hidden, aux, _ = forward(params, cfg, batch, attn_impl=attn_impl,
                             remat=remat, block=block,
                             positions=batch.get("positions"),
                             packed=packed, scan_impl=scan_impl)
    logits = logits_from_hidden(params, cfg, hidden)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce = cross_entropy(logits, labels, mask, cfg.vocab_size)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=DEV.DEFAULT_DEVICE):
    return T.init_cache(cfg, batch, max_len, dtype, DEV.resolve(device))


def decode_step(params, cfg, cache, tokens, pos, decode_tbl=None,
                decode_spec=None, *, attn_impl: str = "cuda"):
    """One decode step. tokens: (B, 1) int; pos: scalar or (B,) absolute
    position of each new token. Returns (logits (B, 1, Vp) f32, cache);
    the cache is written in place (see models/transformer.py).

    decode_tbl + decode_spec switch attention to the packed mixed-position
    decode; every layer shares the round's table. ``attn_impl`` picks the
    rwkv and mamba layers' scan impl (the kernels at L = 1 on the card);
    MoE layers run drop-free."""
    x = params["embed"][tokens]
    for l in range(cfg.n_superlayers):
        lp = T.layer_params(params["layers"], l)
        lc = T.layer_params(cache, l)
        for p, kind in enumerate(cfg.layer_pattern):
            x = T.layer_decode(lp[f"l{p}"], x, cfg, kind, p, lc[f"l{p}"],
                               pos,
                               decode_tbl=decode_tbl,
                               decode_spec=decode_spec, attn_impl=attn_impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, cfg, x), cache


def fused_step(params, cfg, cache, pack_tokens, pack_positions, dec_tokens,
               pos, psched, fused_tbl, fused_spec, admit_rows):
    """One fused continuous-batching step: the admitted prompts and the
    live decode slots go through the layers together, ONE attention launch
    per layer.

    pack_tokens: (1, S_pack) packed prompts; pack_positions: (S_pack,)
    restarting per request; dec_tokens: (B, 1); pos: (B,) decode
    positions; admit_rows: (A,) pack rows of each prompt's last real
    token. Returns (logits_admit (1, A, Vp) f32, logits_dec (B, 1, Vp)
    f32, cache (decode k/v written in place), states: each layer's pack
    k/v stacked on a leading superlayer axis, for the admit splice)."""
    x_pack = params["embed"][pack_tokens]
    x_dec = params["embed"][dec_tokens]
    per_layer = []
    for l in range(cfg.n_superlayers):
        lp = T.layer_params(params["layers"], l)
        lc = T.layer_params(cache, l)
        states = {}
        for p in range(cfg.superlayer):
            x_pack, x_dec, states[f"l{p}"] = T.layer_fused(
                lp[f"l{p}"], x_pack, x_dec, cfg, p, lc[f"l{p}"], pos,
                pack_positions=pack_positions, packed=psched,
                fused_tbl=fused_tbl, fused_spec=fused_spec)
        per_layer.append(states)
    x_pack = L.rms_norm(x_pack, params["final_norm"], cfg.norm_eps)
    x_dec = L.rms_norm(x_dec, params["final_norm"], cfg.norm_eps)
    return (logits_from_hidden(params, cfg, x_pack[:, admit_rows]),
            logits_from_hidden(params, cfg, x_dec), cache,
            _stack_states(per_layer))


def prefill_cache(params, cfg, batch, max_len: int, *,
                  attn_impl: str = "cuda", block: int = 64,
                  cache_dtype=torch.bfloat16):
    """Run the full-sequence forward, collect each layer's states and
    assemble a decode cache covering positions [0, S). Returns (hidden,
    cache). KV rows land in their slots (the last window of a rolling
    cache, in decode's row order); recurrent states replace the cache
    leaves wholesale.

    The forward runs MoE drop-free (``full_capacity``), as every decode
    step does. The reference's prefill_cache drops tokens at the
    capacity factor here, so its cache diverges from the decode it seeds
    (ROADMAP C); the port does not copy that."""
    hidden, _, states = forward(params, cfg, batch, attn_impl=attn_impl,
                                collect_state=True, block=block,
                                full_capacity=True)
    b, s = hidden.shape[0], hidden.shape[1]
    cache = init_cache(cfg, b, max_len, cache_dtype, hidden.device)
    for slot, leaves in cache.items():
        for name, c in leaves.items():
            st = states[slot][name]
            if name not in ("k", "v"):
                c.copy_(st)
                continue
            s_slots = c.shape[2]
            if cfg.sliding_window is not None and s > s_slots:
                take = st[:, :, s - s_slots:]
                c.copy_(take.roll((s - s_slots) % s_slots, 2))
            else:
                c[:, :, :min(s, s_slots)] = st[:, :, :s_slots]
    return hidden, cache
