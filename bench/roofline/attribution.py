"""Device kernels of a ``torch.profiler`` window by name, by the program's
module that launched them, and the window's busy time.

The grouping by the launching module is the logic of the port's
``roofline/attribution.py`` (``_launchers``, ``_port_module``), copied so
that the program can change without moving the yardstick: a kernel is
credited to the innermost aten op above the CPU event that launched it and
to the innermost frame of the program's package in that op's Python stack.
"""

from __future__ import annotations

import re
from typing import List, Tuple

PORT = "repro_torch/"

# the port's attention kernels (``__global__`` names in its csrc)
ATTN_KERNEL_RE = re.compile(
    r"\b(tri_fwd|tri_bwd_dq|tri_bwd_dkv|packed_fwd|packed_bwd_dq|"
    r"packed_bwd_dkv|packed_decode|fused_step)(_tc|_f32)?_kernel")


def is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def kernels(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device kernel, memset and copy of
    the window, by start."""
    out = []
    for ev in prof.events():
        if not is_device(ev):
            continue
        tr = ev.time_range
        out.append((ev.name, float(tr.start), float(tr.end)))
    return sorted(out, key=lambda k: k[1])


def busy_us(spans) -> float:
    """Time in which at least one of ``spans`` ((name, start, end)) runs."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(spans, key=lambda k: k[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _frame(frame: str) -> str:
    """``.../repro_torch/train/optimizer.py(215): _adamw`` as
    ``train/optimizer.py:_adamw``."""
    path, _, rest = frame.partition("(")
    return path.split(PORT, 1)[1] + ":" + (rest.partition(": ")[2] or "?")


def _port_module(op) -> str:
    for frame in getattr(op, "stack", None) or ():
        if PORT in frame:
            return _frame(frame)
    ev = op.cpu_parent
    while ev is not None:
        if PORT in ev.name:
            return _frame(ev.name)
        ev = ev.cpu_parent
    return "outside the port"


def launchers(prof) -> List[Tuple[str, float, str, str]]:
    """(kernel name, device us, aten op, port module frame) of each device
    kernel the profiler linked to the CPU event that launched it; each is
    taken once, from the innermost aten op that lists it."""
    own, under = {}, {}
    for ev in prof.events():
        ks = [] if is_device(ev) else list(getattr(ev, "kernels", ()) or ())
        if not ks:
            continue
        op = ev
        while op is not None and not op.name.startswith("aten::"):
            op = op.cpu_parent
        op = op or ev
        side = own if op is ev else under
        side.setdefault(id(op), (op, []))[1].extend(ks)
    outer = set()
    for op, _ in own.values():
        up = op.cpu_parent
        while up is not None:
            outer.add(id(up))
            up = up.cpu_parent
    out = []
    for key, (op, ks) in {**under, **own}.items():
        if key in outer:
            continue
        module = _port_module(op)
        out += [(k.name, float(k.duration), op.name, module) for k in ks]
    return out
