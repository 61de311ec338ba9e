"""AdamW and Adafactor (factored second moment) over the port's parameter
trees (port of ``repro/train/optimizer.py``).

Adafactor is what the reference's dry-run picks for the largest
architectures: AdamW's two float32 moments are 8 bytes a parameter, the
factored second moment O(rows + cols) a matrix. The state mirrors the
params' layout as the reference's does: {"m", "v"} for AdamW, {"vr",
"vc"} for Adafactor.

The reference computes a new tree for every step and clips a float32 copy
of the whole gradient tree. At nemotron-4's width one leaf (the 256000 x
18432 embedding) is 18.9 GB in float32, so the port reads the gradients
leaf by leaf and each leaf in chunks of at most ``CHUNK`` elements: the
global norm is a sum of per-chunk squares, and the update runs in place
on each leaf, a chunk of rows at a time, so no float32 temporary is larger
than a chunk. AdamW is elementwise: at a given clip scale its update
gives the same bits at any chunk, but the norm of a leaf over ``CHUNK``
elements is a sum of chunks, so where the clip binds its update agrees
with the whole-leaf one at the float32 tolerance, not bitwise.
Adafactor's row means, column means and RMS clip are taken
over the whole (stacked) leaf as the reference's are, with the column
sums and the sum of squares accumulated chunk by chunk: they round
differently from the reference's one-shot sums, so they agree with it at
the float32 tolerance, not bitwise (two runs of the port are bitwise
equal). A leaf no larger than a chunk is read whole, as before.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# elements of the largest float32 temporary of the norm and the updates
# (256 MB)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # adafactor
    decay_exp: float = 0.8  # beta2_t = 1 - t^-0.8
    clip_threshold: float = 1.0


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


def _factored(shape) -> bool:
    """The reference's test, on the whole (stacked) leaf's shape."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _map_leaves(f, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(f, v) for k, v in tree.items()}
    return f(tree)


def init_opt_state(params, opt: OptConfig | None = None):
    """float32 zeros: {"m", "v"} in the params' layout for AdamW (the
    default), {"vr", "vc"} for Adafactor (a factored leaf's row and
    column statistics, an unfactored leaf's second moment and a (1,)
    placeholder)."""
    kind = "adamw" if opt is None else opt.kind

    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    if kind == "adamw":
        z = lambda t: zeros(t.shape, t)
        return {"m": _map_leaves(z, params), "v": _map_leaves(z, params)}
    if kind == "adafactor":
        def vrow(t):
            return zeros(t.shape[:-1] if _factored(t.shape) else t.shape, t)

        def vcol(t):
            return zeros(t.shape[:-2] + t.shape[-1:] if _factored(t.shape)
                         else (1,), t)

        return {"vr": _map_leaves(vrow, params),
                "vc": _map_leaves(vcol, params)}
    raise ValueError(f"unknown optimizer kind {kind!r}")


@dataclasses.dataclass
class _Leaf:
    """One leaf of the tree: its key, its stacked shape (the reference's),
    its params and grads as parts (one a layer where the grads come per
    layer, else the one whole tensor) and its state tensors."""

    name: str
    shape: tuple
    params: list
    grads: list
    state: tuple
    stacked: bool


def _leaves(params, grads, state: tuple, name: str = ""):
    """_Leaf for every leaf; a leaf whose grads come as a list of
    per-layer tensors (``train_step.trainable``) has one part a layer,
    taken from the stacked param (or its per-layer views)."""
    if isinstance(params, dict):
        for key in params:
            yield from _leaves(params[key], grads[key],
                               tuple(s[key] for s in state), key)
    elif isinstance(grads, (list, tuple)):
        yield _Leaf(name, (len(grads),) + tuple(grads[0].shape),
                    [params[l] for l in range(len(grads))], list(grads),
                    state, True)
    else:
        yield _Leaf(name, tuple(grads.shape), [params], [grads], state,
                    False)


def _flat_chunks(*ts, chunk: int):
    """Aligned chunks of the flattened tensors ts (views where a tensor
    is contiguous)."""
    flat = [t.reshape(-1) for t in ts]
    n = flat[0].numel()
    for at in range(0, n, chunk):
        yield tuple(f[at:at + chunk] for f in flat)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every grad's squares in float32, a grad (or a
    chunk of one past ``CHUNK`` elements) at a time."""
    total = None
    for g in grads:
        parts = [g] if g.numel() <= CHUNK else \
            [c for (c,) in _flat_chunks(g, chunk=CHUNK)]
        for part in parts:
            sq = torch.sum(torch.square(part.float()))
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
    """One AdamW or Adafactor step (``opt.kind``) IN PLACE on ``params``
    and ``opt_state``; grads any float dtype, in the params' layout or per
    layer (see ``_leaves``). No float32 temporary exceeds ``CHUNK``
    elements. Returns {"lr", "grad_norm"}."""
    chunk = CHUNK
    keys = {"adamw": ("m", "v"), "adafactor": ("vr", "vc")}.get(opt.kind)
    if keys is None:
        raise ValueError(f"unknown optimizer kind {opt.kind!r}")
    leaves = list(_leaves(params, grads, tuple(opt_state[k] for k in keys)))
    scale, gnorm = clip_by_global_norm(
        (g for leaf in leaves for g in leaf.grads), opt.grad_clip)
    lr = schedule(opt, step)
    f32 = np.float32
    stepf = f32(step) + f32(1.0)
    if opt.kind == "adamw":
        bc1 = float(f32(1.0) - f32(opt.b1) ** stepf)
        bc2 = float(f32(1.0) - f32(opt.b2) ** stepf)
        for leaf in leaves:
            _adamw(opt, leaf, scale, lr, bc1, bc2, chunk)
    else:
        b2t = f32(1.0) - stepf ** f32(-opt.decay_exp)
        for leaf in leaves:
            _adafactor(opt, leaf, scale, lr, b2t, chunk)
    return {"lr": lr, "grad_norm": gnorm}


def _adamw(opt, leaf: _Leaf, scale, lr, bc1, bc2, chunk):
    m_all, v_all = leaf.state
    for l, (p, g) in enumerate(zip(leaf.params, leaf.grads)):
        m, v = (m_all[l], v_all[l]) if leaf.stacked else (m_all, v_all)
        for pc, gc, mc, vc in _flat_chunks(p, g, m, v, chunk=chunk):
            gc = gc.float() * scale
            mc.mul_(opt.b1).add_((1 - opt.b1) * gc)
            vc.mul_(opt.b2).add_((1 - opt.b2) * gc * gc)
            u = (mc / bc1) / (torch.sqrt(vc / bc2) + opt.eps)
            if _decay(leaf.name):
                u = u + opt.weight_decay * pc.float()
            pc.copy_(pc.float() - lr * u)


def _write(opt, name, p, u, div, lr):
    """p <- p - lr (u / div + weight decay p), in p's dtype."""
    u = u / div
    if _decay(name):
        u = u + opt.weight_decay * p.float()
    p.copy_(p.float() - lr * u)


def _adafactor(opt, leaf: _Leaf, scale, lr, b2t, chunk):
    """The reference's Adafactor update of one leaf. Factoring follows the
    stacked shape: a stacked (L, d) norm is factored across its layers
    when L > 1 (row statistics a layer, column statistics over layers),
    whose per-layer parts are gathered whole (a norm is small); a stacked
    matrix is factored within each layer. The RMS clip is over the whole
    leaf: a pass sums u^2 before the pass that writes it."""
    b2 = float(b2t)
    nb2 = float(np.float32(1.0) - b2t)
    vr_all, vc_all = leaf.state
    numel = math.prod(leaf.shape)
    if leaf.stacked and len(leaf.shape) == 2:
        # rows are the layers: the parts gathered into one (L, d) leaf, as
        # the reference holds it
        whole = torch.stack(list(leaf.params))
        _adafactor(opt, _Leaf(leaf.name, leaf.shape, [whole],
                              [torch.stack(list(leaf.grads))], leaf.state,
                              False), scale, lr, b2t, chunk)
        for l, part in enumerate(leaf.params):
            part.copy_(whole[l])
        return
    # each part's (param, grad, vr, vc): an unfactored leaf's vc is a (1,)
    # placeholder, not stacked
    factored = _factored(leaf.shape)
    parts = [(p, g, vr_all[l] if leaf.stacked else vr_all,
              (vc_all[l] if leaf.stacked else vc_all) if factored else None)
             for l, (p, g) in enumerate(zip(leaf.params, leaf.grads))]
    sumsq = None

    def add(x):
        nonlocal sumsq
        s = torch.sum(x * x)
        sumsq = s if sumsq is None else sumsq + s

    if not factored:
        for p, g, vr, _ in parts:
            for gc, vrc in _flat_chunks(g, vr, chunk=chunk):
                gc = gc.float() * scale
                vrc.mul_(b2).add_(nb2 * (gc * gc + 1e-30))
                add(gc / (torch.sqrt(vrc) + 1e-30))
        div = torch.clamp(torch.sqrt(sumsq / numel + 1e-30)
                          / opt.clip_threshold, min=1.0)
        for p, g, vr, _ in parts:
            for pc, gc, vrc in _flat_chunks(p, g, vr, chunk=chunk):
                u = gc.float() * scale / (torch.sqrt(vrc) + 1e-30)
                _write(opt, leaf.name, pc, u, div, lr)
        return
    r, c = leaf.shape[-2:]
    rfacs = []
    for p, g, vr, vc in parts:
        a = g.numel() // (r * c)
        g3, vr2, vc2 = g.reshape(a, r, c), vr.reshape(a, r), vc.reshape(a, c)
        cols = torch.zeros((a, c), dtype=torch.float32, device=g.device)
        for ai, ri in _row_blocks(a, r, c, chunk):
            gc = g3[ai, ri].float() * scale
            g2 = gc * gc + 1e-30
            vr2[ai, ri] = b2 * vr2[ai, ri] + nb2 * torch.mean(g2, dim=-1)
            cols[ai] += torch.sum(g2, dim=-2)
        vc2.copy_(b2 * vc2 + nb2 * (cols / r))
        rfac = vr2 / torch.mean(vr2, dim=-1, keepdim=True)
        rfacs.append(rfac)
        for ai, ri in _row_blocks(a, r, c, chunk):
            add(_factored_u(g3[ai, ri], scale, rfac[ai, ri], vc2[ai]))
    div = torch.clamp(torch.sqrt(sumsq / numel + 1e-30)
                      / opt.clip_threshold, min=1.0)
    for (p, g, _, vc), rfac in zip(parts, rfacs):
        a = g.numel() // (r * c)
        g3, p3, vc2 = g.reshape(a, r, c), p.reshape(a, r, c), \
            vc.reshape(a, c)
        for ai, ri in _row_blocks(a, r, c, chunk):
            u = _factored_u(g3[ai, ri], scale, rfac[ai, ri], vc2[ai])
            _write(opt, leaf.name, p3[ai, ri], u, div, lr)


def _row_blocks(a: int, r: int, c: int, chunk: int):
    """Blocks (slice of the leading a, slice of the r rows) of an (a, r,
    c) leaf holding at most ``chunk`` elements (a row at least): whole
    matrices where one fits, else a chunk of one matrix's rows."""
    rows = max(1, chunk // c)
    if rows >= r:
        step = max(1, rows // r)
        for a0 in range(0, a, step):
            yield slice(a0, min(a, a0 + step)), slice(0, r)
    else:
        for ai in range(a):
            for r0 in range(0, r, rows):
                yield slice(ai, ai + 1), slice(r0, min(r, r0 + rows))


def _factored_u(g, scale, rfac, vc):
    """u = g / (sqrt(rfac) sqrt(vc) + 1e-30) of a block: g (a, rows, c),
    rfac (a, rows), vc (a, c)."""
    return g.float() * scale / (torch.sqrt(rfac)[..., None]
                                * torch.sqrt(vc)[..., None, :] + 1e-30)

