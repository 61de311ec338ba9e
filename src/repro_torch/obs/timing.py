"""The one timing code path for the port's measurements (port of
``repro/obs/timing.py``).

``median_of_k``: ``warmup`` untimed calls (the first pays any kernel
build), then ``reps`` timed calls, each synchronized with
``torch.cuda.synchronize()`` where its result holds a CUDA tensor (CUDA
work is asynchronous: without it the clock reads the enqueue), reported
as the median. ``best_of`` is the minimum instead. Every timed call also
lands in the ``bench_seconds`` histogram, labelled by ``name``, so a
metrics document carries the numbers a table prints.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.obs import metrics as MET


def _holds_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_holds_cuda(v) for v in value)
    return False


def _call_synced(fn, args):
    out = fn(*args)
    if _holds_cuda(out):
        torch.cuda.synchronize()
    return out


def _times(fn, args, reps: int, warmup: int, name: Optional[str]):
    for _ in range(max(warmup, 0)):
        _call_synced(fn, args)
    out = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        _call_synced(fn, args)
        dt = time.perf_counter() - t0
        out.append(dt)
        if name is not None:
            MET.histogram_observe("bench_seconds", dt, labels={"name": name})
    return out


def median_of_k(fn, *args, reps: int = 5, warmup: int = 1,
                name: Optional[str] = None) -> float:
    """Median wall-clock seconds of fn(*args) over ``reps`` synchronized
    calls, after ``warmup`` discarded ones."""
    ts = sorted(_times(fn, args, reps, warmup, name))
    mid = len(ts) // 2
    return ts[mid] if len(ts) % 2 else 0.5 * (ts[mid - 1] + ts[mid])


def best_of(fn, *args, reps: int = 3, warmup: int = 1,
            name: Optional[str] = None) -> float:
    """Best-of-``reps`` wall clock of synchronized calls."""
    return min(_times(fn, args, reps, warmup, name))
