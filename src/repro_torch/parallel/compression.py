"""Gradient compression: int8-quantized all-reduce with error feedback
(port of ``repro/parallel/compression.py``).

Error feedback (Seide et al. / EF-SGD) carries each step's quantization
residual into the next step's gradient, so the compression is unbiased
over time. The codec is the reference's, bit for bit on the same float32
inputs: a symmetric per-tensor scale ``max(max|x|, 1e-30) / 127``, x
divided by it (not multiplied by its reciprocal), rounded half to even
and clamped to +-127.

"Per tensor" is per leaf of the reference's tree, whose ``layers`` leaves
are stacked (L, ...). The port's trainer hands the grads of a stacked
leaf as a list of per-layer tensors (``train.train_step.trainable``), so
a leaf's scale is taken over all of its parts, and its error state stays
stacked, each part updated through its layer's view. At full width one
stacked leaf's float32 ``g + err`` is over 1 GB, so each leaf is coded
in chunks of ``optimizer.CHUNK`` elements in two passes: the first takes
max |g + err| over every chunk without keeping the sum, the second
recomputes ``g + err`` and writes the dequantized value over the float32
grad and the new error over the error state. A max is exact, so the
chunked code equals the one-shot one bit for bit.

``compressed_psum`` all-reduces each rank's dequantized float32
contribution and divides by the group's size, as the reference's code
does (its docstring speaks of summing the int8 payload; its code sums
float32, and so does the port's). Without a group it is the mean over one
rank: the dequantized grads themselves. Each rank codes its own grads
with its own error. The reference's hook takes its leaves replicated
(in_specs ``P()``), so under ``jit`` its partitioner first reduces the
grads and every device codes that one mean with one shared error; on one
rank the two are the same step (ROADMAP queue C).
"""

from __future__ import annotations

import torch

from repro_torch.train import optimizer as OPT


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q int8, scale float32 0-d)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-30) / 127.0
    return _quantize(xf, scale), scale


def _quantize(xf, scale):
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback step: compress (g + err); returns (q, scale,
    new_err)."""
    target = g.float() + err
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def init_error_state(params):
    """Float32 zeros in the params' layout (``layers`` stacked)."""
    if isinstance(params, dict):
        return {k: init_error_state(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def _chunks(g, e, chunk):
    """Aligned chunks of the flattened (contiguous) g and e."""
    gf, ef = g.view(-1), e.view(-1)
    for at in range(0, gf.numel(), chunk):
        yield gf[at:at + chunk], ef[at:at + chunk]


def ef_compress_parts(gs, es) -> torch.Tensor:
    """The error-feedback code of one leaf given as parts (a stacked
    leaf's layers, or the one tensor), IN PLACE: each float32 grad part
    becomes its dequantized value, each error part the new error. One
    scale over all the parts (returned, 0-d float32)."""
    chunk = OPT.CHUNK
    amax = None
    for g, e in zip(gs, es):
        for gc, ec in _chunks(g, e, chunk):
            m = torch.max(torch.abs(gc + ec))
            amax = m if amax is None else torch.maximum(amax, m)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    for g, e in zip(gs, es):
        for gc, ec in _chunks(g, e, chunk):
            target = gc + ec
            deq = dequantize_int8(_quantize(target, scale), scale)
            ec.copy_(target - deq)
            gc.copy_(deq)
    return scale


@torch.no_grad()
def compressed_psum(grads, err_state, group=None, *, _key: str = ""):
    """All-reduce ``grads`` over ``group`` in int8 with error feedback.
    Returns (mean grads float32, err_state).

    grads: a tree of dicts whose leaves are tensors or lists of per-layer
    tensors (a stacked leaf's parts); err_state: the float32 tree in the
    params' layout (stacked leaves whole), updated IN PLACE. A float32
    contiguous grad is overwritten with its mean (others are copied to
    float32 first). group: a ``torch.distributed`` process group, or None
    for one rank."""
    if isinstance(grads, dict):
        out = {}
        for k in grads:
            out[k], _ = compressed_psum(
                grads[k], err_state[k], group,
                _key=f"{_key}.{k}" if _key else k)
        return out, err_state
    stacked = isinstance(grads, (list, tuple))
    gs = [g.float().contiguous() for g in (grads if stacked else [grads])]
    es = [err_state[l] for l in range(len(gs))] if stacked else [err_state]
    if not all(e.is_contiguous() for e in es):
        raise ValueError(f"error state of {_key} is not contiguous")
    ef_compress_parts(gs, es)
    if group is not None:
        import torch.distributed as dist

        n = dist.get_world_size(group)
        for g in gs:
            dist.all_reduce(g, group=group)
            if n > 1:  # the sum over one rank is already its mean
                g.div_(float(n))
    return (gs if stacked else gs[0]), err_state


def make_compressed_allreduce(group=None):
    """(grads, err) -> (mean grads, err) over ``group`` (None: one rank):
    the hook ``train.train_step.make_train_step(compressed_allreduce=)``
    runs in place of the plain float32 all-reduce of the data-parallel
    grads."""

    def allreduce(grads, err):
        return compressed_psum(grads, err, group)

    return allreduce
