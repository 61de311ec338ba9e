"""The training step: loss -> grads -> AdamW or Adafactor, with gradient
accumulation over microbatches, optional int8 error-feedback grad
compression (``parallel/compression.py``) and data parallelism over a
``torch.distributed`` group (port of ``repro/train/train_step.py``).

Data parallelism: each rank of the default process group
(``launch/mesh.init_data_group``) steps on its own shard of the batch.
In a group of more than one rank each rank's loss and float32 grads are
weighted by its share of the loss tokens (the mask's sum), so that their
mean over the group is the loss and grads of the whole batch, as the
reference's partitioner gives them. With a ``compressed_allreduce`` hook
the weighted grads go through the hook, which reduces them; without one,
they are all-reduced to their mean in float32, the counterpart of the
all-reduce the reference's partitioner emits over the data axis. An MoE
model is refused there: its load-balance loss and expert capacity are
taken over the batch a rank holds, not over the whole batch.

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
from repro_torch.parallel import compression as C
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass
class TrainState:
    params: dict     # the reference layout: layers stacked
    opt_state: dict  # float32: {"m", "v"} (AdamW) or {"vr", "vc"}
    step: int
    # float32 error feedback of the int8 grad compression, in the params'
    # layout (None without compression)
    err_state: dict | None = None


def init_state(cfg, opt: OPT.OptConfig, *, seed: int = 0,
               device=DEV.DEFAULT_DEVICE,
               compression: bool = False) -> TrainState:
    params = MD.init_params(cfg, seed, device)
    return TrainState(
        params=params, opt_state=OPT.init_opt_state(params, opt), step=0,
        err_state=C.init_error_state(params) if compression else None)


def state_from_jax(np_state, cfg, device=DEV.DEFAULT_DEVICE) -> TrainState:
    """A reference TrainState whose leaves are numpy arrays (params, the
    optimizer's state: AdamW's "m"/"v" or Adafactor's "vr"/"vc", step,
    and the compression's err_state where it has one) -> the port's, on
    ``device``."""
    dev = DEV.resolve(device)

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return torch.as_tensor(np.array(t, np.float32), device=dev)

    opt = np_state.opt_state
    err = getattr(np_state, "err_state", None)
    return TrainState(params=MD.params_from_jax(np_state.params, cfg, dev),
                      opt_state={k: f32(dict(opt[k])) for k in opt},
                      step=int(np.asarray(np_state.step)),
                      err_state=None if err is None else f32(dict(err)))


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


def _data_world() -> int:
    """Ranks of the default process group (1 when none is up)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _allreduce_mean(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t)
    return t.div_(float(dist.get_world_size()))


def _token_weights(mbs, world: int) -> list:
    """Each microbatch's weight on this rank in a group of ``world`` > 1
    ranks: its loss denominator (``models/model.cross_entropy``'s
    max(mask sum, 1)) times world over the whole group's. The mean over
    the group of the weighted losses (and grads) is then the loss of the
    union of the ranks' microbatches."""
    import torch.distributed as dist

    sums = torch.stack([
        mb["mask"].double().sum() if mb.get("mask") is not None else
        torch.tensor(float(mb["labels"].numel()), dtype=torch.float64,
                     device=mb["labels"].device) for mb in mbs])
    total = sums.clone()
    dist.all_reduce(total)
    return (torch.clamp(sums, min=1.0) * world
            / torch.clamp(total, min=1.0)).tolist()


def make_train_step(cfg, opt: OPT.OptConfig, *, microbatches: int = 1,
                    attn_impl: str = "cuda", remat: bool = True,
                    aux_weight: float = 0.01, block: int = 64, packed=None,
                    scan_impl: str | None = None,
                    compressed_allreduce=None):
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
    "torch", the plain chunked scans.

    ``compressed_allreduce``: a (grads, err) -> (grads, err) hook
    (``parallel/compression.make_compressed_allreduce``) run on the
    float32 grads before the optimizer when the state has an
    ``err_state`` (updated in place). Without it, a default process
    group of more than one rank all-reduces the float32 grads to their
    mean (each rank's weighted by its loss tokens: see the module's
    docstring)."""
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
        world = _data_world()
        err = state.err_state
        compress = compressed_allreduce is not None and err is not None
        if world > 1 and cfg.n_experts:
            raise ValueError(
                f"{cfg.name} has MoE layers: their load-balance loss and "
                f"expert capacity are taken over the batch one rank holds, "
                f"so a data-parallel group of {world} ranks would not give "
                f"the whole batch's step")
        rows = batch["labels"].shape[0]
        if rows % microbatches:
            raise ValueError(f"batch {rows} does not split into "
                             f"{microbatches} microbatches")
        mbs = [dict(zip(batch, parts)) for parts in zip(
            *(torch.chunk(x, microbatches) for x in batch.values()))]
        weights = (_token_weights(mbs, world) if world > 1
                   else [1.0] * microbatches)
        loss, mets, acc = 0.0, [], None
        for mb, w in zip(mbs, weights):
            l, met = MD.loss_fn(views, cfg, mb, attn_impl=attn_impl,
                                remat=remat, aux_weight=aux_weight,
                                block=block, packed=packed,
                                scan_impl=scan_impl)
            l.backward()
            if views["embed"].grad is None:
                # an "embeds"-only batch (audio frames) reads no token
                # row: the reference's gradient there is zero
                views["embed"].grad = torch.zeros_like(views["embed"])
            loss = loss + w * l.detach()
            mets.append({k: w * v.detach() for k, v in met.items()})
            if microbatches > 1 or compress or world > 1:
                # the grads leave the views as float32, each bf16 grad
                # freed as its float32 copy is made
                g = _map(_take_f32_grad, views)
                if w != 1.0:
                    g = _map(lambda t: t.mul_(w), g)
                acc = g if acc is None else _map(torch.Tensor.add_, acc, g)
        if microbatches > 1:
            grads = _map(lambda a: a / microbatches, acc)
            loss = loss / microbatches
        else:
            grads = grads_of(views) if acc is None else acc
        metrics = {k: sum(m[k] for m in mets) / microbatches
                   for k in mets[0]}
        if compress:
            grads, err = compressed_allreduce(grads, err)
        elif world > 1:
            grads = _map(_allreduce_mean, grads)
        if world > 1:
            means = _allreduce_mean(torch.stack(
                [loss, *metrics.values()]).float())
            loss, metrics = means[0], dict(zip(metrics, means[1:]))
        opt_metrics = OPT.apply_updates(opt, views, grads,
                                        state.opt_state, state.step)
        new_state = TrainState(params=state.params,
                               opt_state=state.opt_state,
                               step=state.step + 1, err_state=err)
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
