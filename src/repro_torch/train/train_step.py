"""The training step: loss -> grads -> AdamW or Adafactor, with gradient
accumulation
over microbatches (port of ``repro/train/train_step.py``; the int8 grad
compression and the activation sharding wait with ``parallel/``, ROADMAP
queue A).

Autograd runs through the model's ops: on the card the attention of every
layer is the tri_attn forward kernel (twice under remat) and its dq and
dk/dv kernels, or, for a packed document batch, the packed forward and
the packed dq and dk/dv kernels. The parameters are updated IN PLACE (the reference returns
a new state): the returned state shares its tensors with the one passed
in, which the caller must not reuse.

``make_prefill_step`` and ``make_serve_step`` are the offline serving
entry points (no autograd).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as DEV
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as MET
from repro_torch.obs import trace as TR
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass
class TrainState:
    params: dict     # the reference layout: layers stacked
    opt_state: dict  # float32: {"m", "v"} (AdamW) or {"vr", "vc"}
    step: int


def init_state(cfg, opt: OPT.OptConfig, *, seed: int = 0,
               device=DEV.DEFAULT_DEVICE) -> TrainState:
    params = MD.init_params(cfg, seed, device)
    return TrainState(params=params,
                      opt_state=OPT.init_opt_state(params, opt), step=0)


def state_from_jax(np_state, cfg, device=DEV.DEFAULT_DEVICE) -> TrainState:
    """A reference TrainState whose leaves are numpy arrays (params, the
    optimizer's state: AdamW's "m"/"v" or Adafactor's "vr"/"vc", step) ->
    the port's, on ``device``."""
    dev = DEV.resolve(device)

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return torch.as_tensor(np.array(t, np.float32), device=dev)

    opt = np_state.opt_state
    return TrainState(params=MD.params_from_jax(np_state.params, cfg, dev),
                      opt_state={k: f32(dict(opt[k])) for k in opt},
                      step=int(np.asarray(np_state.step)))


def trainable(params):
    """Leaves that autograd differentiates, sharing storage with
    ``params``: each stacked layer leaf becomes a list of per-layer views,
    so every layer gets a gradient of its own size (indexing the stack
    under autograd would zero-fill a stack-sized gradient per layer)."""
    def conv(t, stacked):
        if isinstance(t, dict):
            return {k: conv(v, stacked) for k, v in t.items()}
        if stacked:
            return [t[l].detach().requires_grad_() for l in range(len(t))]
        return t.detach().requires_grad_()

    return {k: conv(v, k == "layers") for k, v in params.items()}


def _map(f, *trees):
    """f over the leaves of trees of dicts and per-layer lists."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(f, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [_map(f, *ts) for ts in zip(*trees)]
    return f(*trees)


def _grad(view):
    if view.grad is None:
        raise RuntimeError("a trainable leaf received no gradient")
    return view.grad


def grads_of(views):
    """The .grad tree of ``trainable`` views (lists stay per layer)."""
    return _map(_grad, views)


def _take_f32_grad(view):
    g = _grad(view).float()
    view.grad = None
    return g


def make_train_step(cfg, opt: OPT.OptConfig, *, microbatches: int = 1,
                    attn_impl: str = "cuda", remat: bool = True,
                    aux_weight: float = 0.01, block: int = 64, packed=None,
                    scan_impl: str | None = None):
    """Returns train_step(state, batch) -> (state, metrics).

    microbatches M > 1 splits the batch's leading dim into M sequential
    backward passes whose grads are summed in float32 and divided by M,
    as the reference does. ``packed`` (a PackedTriSched) trains on
    bin-packed documents (train/data.PackedDocsLM batches, which carry
    "positions" and "mask"): one static schedule serves every step.
    Batches may carry "embeds" (the stub frontends). The optimizer is
    ``opt.kind`` (the state must be of that kind: ``init_state``). On the
    kernels an arch whose head dim no attention body takes is refused
    here (``transformer.check_kernel_head_dim``). The rwkv and mamba
    layers' scans take ``attn_impl`` unless ``scan_impl`` is given: their
    kernels have no backward, so these archs train with scan_impl
    "torch", the plain chunked scans."""
    if packed is not None and microbatches != 1:
        raise ValueError(f"a packed batch is one row (B = 1) of bin-packed "
                         f"documents, so it does not split into "
                         f"{microbatches} microbatches: pass microbatches=1")
    T.check_kernel_head_dim(cfg, attn_impl)
    labels = {"impl": attn_impl, "packed": "0" if packed is None else "1"}

    def train_step(state: TrainState, batch):
        MET.counter_inc("train_step_calls", 1, labels)
        MET.counter_inc("train_microbatches", microbatches, labels)
        views = trainable(state.params)
        rows = batch["labels"].shape[0]
        if rows % microbatches:
            raise ValueError(f"batch {rows} does not split into "
                             f"{microbatches} microbatches")
        mbs = [dict(zip(batch, parts)) for parts in zip(
            *(torch.chunk(x, microbatches) for x in batch.values()))]
        loss, mets, acc = 0.0, [], None
        for mb in mbs:
            l, met = MD.loss_fn(views, cfg, mb, attn_impl=attn_impl,
                                remat=remat, aux_weight=aux_weight,
                                block=block, packed=packed,
                                scan_impl=scan_impl)
            l.backward()
            if views["embed"].grad is None:
                # an "embeds"-only batch (audio frames) reads no token
                # row: the reference's gradient there is zero
                views["embed"].grad = torch.zeros_like(views["embed"])
            loss = loss + l.detach()
            mets.append(met)
            if microbatches > 1:
                g = _map(_take_f32_grad, views)
                acc = g if acc is None else _map(torch.Tensor.add_, acc, g)
        if microbatches == 1:
            grads = grads_of(views)
        else:
            grads = _map(lambda a: a / microbatches, acc)
            loss = loss / microbatches
        metrics = {k: sum(m[k].detach() for m in mets) / microbatches
                   for k in mets[0]}
        opt_metrics = OPT.apply_updates(opt, views, grads,
                                        state.opt_state, state.step)
        new_state = TrainState(params=state.params,
                               opt_state=state.opt_state,
                               step=state.step + 1)
        return new_state, dict(metrics, loss=loss, **opt_metrics)

    def instrumented_step(state: TrainState, batch):
        with TR.span("train.step", **labels) as sp:
            new_state, metrics = train_step(state, batch)
            sp.attach(metrics["loss"])
        return new_state, metrics

    return instrumented_step


# ---------------------------------------------------------------------------
# Serving steps (the offline entry points)
# ---------------------------------------------------------------------------


def make_serve_step(cfg, *, attn_impl: str = "cuda"):
    """serve_step(params, cache, tokens, pos) -> (next-token logits (B,
    Vp), cache): one new token per sequence against its cache or
    recurrent state (written in place)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = MD.decode_step(params, cfg, cache, tokens, pos,
                                       attn_impl=attn_impl)
        return logits[:, -1], cache

    return serve_step


def make_prefill_step(cfg, *, attn_impl: str = "cuda", block: int = 64,
                      cache_dtype=torch.bfloat16, max_len: int = 0):
    """prefill_step(params, batch) -> (last-position logits (B, Vp),
    decode cache of max(S, max_len) positions, [0, S) filled), S the
    batch's tokens plus its "embeds" rows.
    The reference sizes the cache at S, so a decode step past it wraps
    onto row 0 of an attention layer's k/v; ``max_len`` leaves room for
    the tokens a caller decodes next. On the card an rwkv model's WKV
    region, and each of a jamba model's Mamba layers, is one kernel
    launch over all B x S streams."""

    T.check_kernel_head_dim(cfg, attn_impl)

    @torch.no_grad()
    def prefill_step(params, batch):
        MET.counter_inc("prefill_step_calls", 1, {"impl": attn_impl})
        s_total = sum(batch[k].shape[1] for k in ("tokens", "embeds")
                      if batch.get(k) is not None)
        hidden, cache = MD.prefill_cache(
            params, cfg, batch, max(s_total, max_len),
            attn_impl=attn_impl, block=block, cache_dtype=cache_dtype)
        return MD.logits_from_hidden(params, cfg, hidden[:, -1:])[:, 0], \
            cache

    return prefill_step
