"""AdamW over the port's parameter trees (port of
``repro/train/optimizer.py``, AdamW only: Adafactor waits for the
architectures that select it, ROADMAP queue A).

The reference computes a new tree for every step and clips a float32 copy
of the whole gradient tree. At yi-9b's width that copy alone is 4 bytes a
parameter, so the port reads the gradients leaf by leaf instead: the
global norm is a sum of per-leaf squares, and the update runs in place on
each leaf, a stacked leaf one layer slice at a time, so no float32
temporary is larger than one layer's leaf. The arithmetic is the
reference's, up to float32 rounding of the sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(opt: OptConfig, step: int) -> float:
    """Linear warmup, then cosine decay to min_lr_frac, in float32 as the
    reference computes it. Uses step + 1 so the first update has a
    non-zero learning rate."""
    f32 = np.float32
    stepf = f32(step) + f32(1.0)
    warm = stepf / f32(max(opt.warmup_steps, 1))
    t = (stepf - f32(opt.warmup_steps)) / f32(
        max(opt.total_steps - opt.warmup_steps, 1))
    t = np.clip(t, f32(0.0), f32(1.0))
    cos = f32(opt.min_lr_frac) + f32(1 - opt.min_lr_frac) * f32(0.5) * (
        f32(1.0) + np.cos(f32(np.pi) * t))
    return float(f32(opt.lr) * (warm if stepf < opt.warmup_steps else cos))


def _decay(name: str) -> bool:
    """Weight decay only on >= 2-D matmul weights (not norms or biases),
    by the leaf's key as the reference's ``_decay_mask``."""
    return not (name.startswith("norm") or name in
                ("final_norm", "dt_bias", "d_skip", "w0", "u", "ln_x_scale",
                 "ln_x_bias"))


def init_opt_state(params):
    """{"m", "v"}: float32 zeros in the params' layout."""
    zeros = lambda t: {k: zeros(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.zeros(t.shape, dtype=torch.float32,
                                                device=t.device)
    return {"m": zeros(params), "v": zeros(params)}


def _leaf_slices(params, grads, m, v, name: str = ""):
    """Yield (name, param, grad, m, v) for every leaf; a leaf whose grads
    come as a list of per-layer tensors yields one tuple per layer, with
    the matching slices of the stacked param, m and v."""
    if isinstance(params, dict):
        for key in params:
            yield from _leaf_slices(params[key], grads[key], m[key],
                                    v[key], key)
    elif isinstance(grads, (list, tuple)):
        for l, g in enumerate(grads):
            yield name, params[l], g, m[l], v[l]
    else:
        yield name, params, grads, m, v


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every grad's squares, one leaf (slice) at a
    time in float32."""
    total = None
    for g in grads:
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(scale, norm): the factor that brings the global norm of ``grads``
    to at most ``max_norm``; the caller multiplies each float32 grad by
    it."""
    g = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0), g


@torch.no_grad()
def apply_updates(opt: OptConfig, params, grads, opt_state, step: int):
    """One AdamW step IN PLACE on ``params`` and ``opt_state``; grads any
    float dtype, in the params' layout or per layer (see
    ``_leaf_slices``). Returns {"lr", "grad_norm"}."""
    slices = list(_leaf_slices(params, grads, opt_state["m"],
                              opt_state["v"]))
    scale, gnorm = clip_by_global_norm((s[2] for s in slices),
                                       opt.grad_clip)
    lr = schedule(opt, step)
    f32 = np.float32
    stepf = f32(step) + f32(1.0)
    bc1 = float(f32(1.0) - f32(opt.b1) ** stepf)
    bc2 = float(f32(1.0) - f32(opt.b2) ** stepf)
    for name, p, g, m, v in slices:
        g = g.float() * scale
        m.mul_(opt.b1).add_((1 - opt.b1) * g)
        v.mul_(opt.b2).add_((1 - opt.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
        if _decay(name):
            u = u + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return {"lr": lr, "grad_norm": gnorm}
