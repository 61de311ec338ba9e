"""Top-level model: embedding -> layers -> norm -> LM head.

Port of ``repro/models/model.py`` for the dense attention path:
  init_params(cfg, seed, device)             -> params
  params_from_jax(np_params, cfg, device)    -> params (reference weights)
  forward(params, cfg, batch, ...)           -> (hidden, aux, states)
  logits_from_hidden(params, cfg, hidden)    -> (B, S, padded_vocab) f32
  loss_fn(params, cfg, batch, ...)           -> (loss, {"ce", "aux"})
  init_cache(cfg, batch, max_len, dtype, device)
  decode_step(params, cfg, cache, tok, pos)  -> (logits, cache)
  fused_step(params, cfg, cache, ...)        -> (logits_admit, logits_dec,
                                                 cache, states)
Params keep the reference pytree layout (``layers`` stacked on a leading
superlayer axis), so reference weights carry over leaf for leaf. Training
hands ``forward`` each stacked leaf as a list of per-layer tensors instead
(``train.train_step.trainable``), so autograd keeps one gradient per layer
rather than zero-filling the whole stack for every layer it indexes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as DEV
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _dense(gen, shape, fan_in, dtype, device, stack: int = 0):
    """N(0, 1/fan_in) weights; a stacked leaf is drawn one layer at a time
    so the f32 draw never holds more than one layer."""
    if not stack:
        w = torch.randn(shape, generator=gen, device=device)
        return (w / math.sqrt(fan_in)).to(dtype)
    out = torch.empty((stack,) + tuple(shape), dtype=dtype, device=device)
    for l in range(stack):
        w = torch.randn(shape, generator=gen, device=device)
        out[l] = (w / math.sqrt(fan_in)).to(dtype)
    return out


def init_params(cfg, seed: int = 0, device=DEV.DEFAULT_DEVICE):
    """Random weights from a seeded ``torch.Generator`` on ``device``.
    They are not the reference's draws: tests carry reference weights
    over with ``params_from_jax``."""
    T.check_supported(cfg)
    dev = DEV.resolve(device)
    dtype = param_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, vp, n = cfg.d_model, cfg.padded_vocab, cfg.n_superlayers
    h, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=dev)
    layers = {}
    for p in range(cfg.superlayer):
        layers[f"l{p}"] = {
            "norm1": ones(n, d),
            "mixer": {
                "wq": _dense(gen, (d, h * hd), d, dtype, dev, n),
                "wk": _dense(gen, (d, hkv * hd), d, dtype, dev, n),
                "wv": _dense(gen, (d, hkv * hd), d, dtype, dev, n),
                "wo": _dense(gen, (h * hd, d), h * hd, dtype, dev, n),
            },
            "norm2": ones(n, d),
            "ffn": {
                "wi": _dense(gen, (d, f), d, dtype, dev, n),
                "wg": _dense(gen, (d, f), d, dtype, dev, n),
                "wo": _dense(gen, (f, d), f, dtype, dev, n),
            },
        }
    params = {
        "embed": (torch.randn((vp, d), generator=gen, device=dev)
                  * 0.02).to(dtype),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, (d, vp), d, dtype, dev)
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


def forward(params, cfg, batch, *, attn_impl: str = "cuda",
            collect_state: bool = False, positions=None, packed=None,
            remat: bool = False, block: int = 64):
    """Returns (hidden (B, S, d), aux, states_or_None); states stack each
    layer's rotated k/v on a leading superlayer axis, as the reference's
    scan does. Serving prefill passes the packed schedule and positions
    restarting per request. ``remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``, the counterpart of the
    reference's ``jax.checkpoint`` with ``nothing_saveable``): only the
    layer inputs are kept. ``block`` is the attention tile edge of the
    non-packed path; the reference's training default is 512, which the
    kernels do not take, so the port's is 64 (the serving tile)."""
    tokens = batch["tokens"]
    # F.embedding, not indexing: its backward sums each row's grads in a
    # fixed order (indexing's accumulates them in thread order on the CPU)
    x = torch.nn.functional.embedding(tokens, params["embed"])
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    per_layer = []
    for l in range(cfg.n_superlayers):
        lp = T.layer_params(params["layers"], l)

        def superlayer(x, lp=lp):
            states = {}
            for p in range(cfg.superlayer):
                x, states[f"l{p}"] = T.layer_fwd(
                    lp[f"l{p}"], x, cfg, positions=positions,
                    attn_impl=attn_impl, packed=packed,
                    collect_state=collect_state, block=block)
            return x, states

        if remat:
            x, states = checkpoint(superlayer, x, use_reentrant=False)
        else:
            x, states = superlayer(x)
        per_layer.append(states)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_state:
        return x, aux, None
    stacked = {f"l{p}": {kv: torch.stack([st[f"l{p}"][kv]
                                          for st in per_layer])
                         for kv in ("k", "v")}
               for p in range(cfg.superlayer)}
    return x, aux, stacked


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
            packed=None):
    """Next-token loss of a batch ({"tokens", "labels"} (B, S), an
    optional "mask"). Returns (loss, {"ce", "aux"}).

    ``packed`` (a PackedTriSched) trains on bin-packed documents
    (train/data.PackedDocsLM): tokens are then (B, S_total), the
    documents concatenated, attention is block-diagonal per document
    (packed dq and dk/dv in the backward), ``batch["positions"]`` (B,
    S_total) restarts per document and ``batch["mask"]`` is 0 on the pad
    rows."""
    hidden, aux, _ = forward(params, cfg, batch, attn_impl=attn_impl,
                             remat=remat, block=block,
                             positions=batch.get("positions"),
                             packed=packed)
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
                decode_spec=None):
    """One decode step. tokens: (B, 1) int; pos: scalar or (B,) absolute
    position of each new token. Returns (logits (B, 1, Vp) f32, cache);
    the cache is written in place (see models/layers.py).

    decode_tbl + decode_spec switch attention to the packed mixed-position
    decode; every layer shares the round's table."""
    x = params["embed"][tokens]
    for l in range(cfg.n_superlayers):
        lp = T.layer_params(params["layers"], l)
        lc = T.layer_params(cache, l)
        for p in range(cfg.superlayer):
            x = T.layer_decode(lp[f"l{p}"], x, cfg, lc[f"l{p}"], pos,
                               decode_tbl=decode_tbl,
                               decode_spec=decode_spec)
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
                lp[f"l{p}"], x_pack, x_dec, cfg, lc[f"l{p}"], pos,
                pack_positions=pack_positions, packed=psched,
                fused_tbl=fused_tbl, fused_spec=fused_spec)
        per_layer.append(states)
    x_pack = L.rms_norm(x_pack, params["final_norm"], cfg.norm_eps)
    x_dec = L.rms_norm(x_dec, params["final_norm"], cfg.norm_eps)
    stacked = {f"l{p}": {kv: torch.stack([st[f"l{p}"][kv]
                                          for st in per_layer])
                         for kv in ("k", "v")}
               for p in range(cfg.superlayer)}
    return (logits_from_hidden(params, cfg, x_pack[:, admit_rows]),
            logits_from_hidden(params, cfg, x_dec), cache, stacked)
