"""The training step: loss -> grads -> AdamW, with gradient accumulation
over microbatches (port of ``repro/train/train_step.py``; the int8 grad
compression and the activation sharding wait with ``parallel/``, ROADMAP
queue A).

Autograd runs through the model's ops: on the card the attention of every
layer is the tri_attn forward kernel (twice under remat) and its dq and
dk/dv kernels, or, for a packed document batch, the packed forward and
the packed dq and dk/dv kernels. The parameters are updated IN PLACE (the reference returns
a new state): the returned state shares its tensors with the one passed
in, which the caller must not reuse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as DEV
from repro_torch.models import model as MD
from repro_torch.obs import metrics as MET
from repro_torch.obs import trace as TR
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass
class TrainState:
    params: dict     # the reference layout: layers stacked
    opt_state: dict  # {"m", "v"} float32 in the params' layout
    step: int


def init_state(cfg, opt: OPT.OptConfig, *, seed: int = 0,
               device=DEV.DEFAULT_DEVICE) -> TrainState:
    params = MD.init_params(cfg, seed, device)
    return TrainState(params=params, opt_state=OPT.init_opt_state(params),
                      step=0)


def state_from_jax(np_state, cfg, device=DEV.DEFAULT_DEVICE) -> TrainState:
    """A reference TrainState whose leaves are numpy arrays (params, AdamW
    "m"/"v", step) -> the port's, on ``device``."""
    dev = DEV.resolve(device)

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        return torch.as_tensor(np.array(t, np.float32), device=dev)

    opt = np_state.opt_state
    return TrainState(params=MD.params_from_jax(np_state.params, cfg, dev),
                      opt_state={"m": f32(dict(opt["m"])),
                                 "v": f32(dict(opt["v"]))},
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
                    aux_weight: float = 0.01, block: int = 64, packed=None):
    """Returns train_step(state, batch) -> (state, metrics).

    microbatches M > 1 splits the batch's leading dim into M sequential
    backward passes whose grads are summed in float32 and divided by M,
    as the reference does. ``packed`` (a PackedTriSched) trains on
    bin-packed documents (train/data.PackedDocsLM batches, which carry
    "positions" and "mask"): one static schedule serves every step."""
    if packed is not None and microbatches != 1:
        raise ValueError(f"a packed batch is one row (B = 1) of bin-packed "
                         f"documents, so it does not split into "
                         f"{microbatches} microbatches: pass microbatches=1")
    labels = {"impl": attn_impl, "packed": "0" if packed is None else "1"}

    def train_step(state: TrainState, batch):
        MET.counter_inc("train_step_calls", 1, labels)
        MET.counter_inc("train_microbatches", microbatches, labels)
        views = trainable(state.params)
        if batch["tokens"].shape[0] % microbatches:
            raise ValueError(f"batch {batch['tokens'].shape[0]} does not "
                             f"split into {microbatches} microbatches")
        mbs = [dict(zip(batch, parts)) for parts in zip(
            *(torch.chunk(x, microbatches) for x in batch.values()))]
        loss, mets, acc = 0.0, [], None
        for mb in mbs:
            l, met = MD.loss_fn(views, cfg, mb, attn_impl=attn_impl,
                                remat=remat, aux_weight=aux_weight,
                                block=block, packed=packed)
            l.backward()
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
