"""Instrumented launch wrapper: every kernel launch is a counted event.

Port of ``repro/obs/launch.py``. ``instrumented_launch`` is the port's
ONLY kernel-launch site: the CUDA wrappers in ``kernels/`` build a
``LaunchMeta`` from their schedule and call their C entry point through
it, and the plain PyTorch versions record the same geometry with
``record_launch``. Each launch adds to the counters ``launches_total``,
``tiles_launched_total``, ``tiles_domain_total``, ``tiles_wasted_total``,
``tiles_bb_total`` and ``launch_bytes_total``, labelled ``{name, impl}``
exactly as the reference names them, so the two packages' counts can be
diffed kernel by kernel; ``kernel_summary`` sums them per kernel with
the paper's utilization and structural I. A pre-launch hook
(``set_launch_hook``) runs at the top of ``record_launch``: before every
kernel launch and every plain version's run, and may raise to abort it
(the fault-injection surface of ``resilience.faults.install_launch_hook``).
``capture`` collects every launch recorded inside a block, with its
operands' dtypes (what ``analysis/launch_lint.py`` reads).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

from repro_torch.obs import metrics as MET
from repro_torch.obs import sinks as SK

_LAUNCH_HOOK = None
_CAPTURES: list = []


def set_launch_hook(hook):
    """Install ``hook(meta)``, run before every recorded launch; returns
    the previous hook (None when there was none) so callers can restore
    it."""
    global _LAUNCH_HOOK
    prev, _LAUNCH_HOOK = _LAUNCH_HOOK, hook
    return prev


@dataclasses.dataclass(frozen=True)
class LaunchMeta:
    """Static description of one launch's block-space geometry.

    ``tiles_launched`` counts the tile steps ONE grid cell walks (one
    (batch, head) pair for attention); ``cells`` is the number of such
    cells. ``tiles_domain`` is the useful-tile count from the schedule,
    ``tiles_bb`` the bounding-box bound the paper compares against."""

    name: str
    family: str
    impl: str
    kind: str
    grid: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    tiles_launched: int
    tiles_domain: Optional[int] = None
    tiles_bb: Optional[int] = None
    cells: int = 1
    extra: tuple = ()

    @property
    def tiles_wasted(self) -> Optional[int]:
        if self.tiles_domain is None:
            return None
        return self.tiles_launched - self.tiles_domain

    def as_event(self, *, bytes_moved: int) -> dict:
        ev = {"type": "launch", "name": self.name, "family": self.family,
              "impl": self.impl, "kind": self.kind, "phase": "eager",
              "grid": list(self.grid), "cells": self.cells,
              "block_shape": list(self.block_shape),
              "tiles_launched": self.tiles_launched,
              "tiles_domain": self.tiles_domain,
              "tiles_bb": self.tiles_bb,
              "tiles_wasted": self.tiles_wasted,
              "bytes_moved": bytes_moved}
        if self.extra:
            ev["extra"] = {str(k): v for k, v in self.extra}
        return ev


def meta_from_trisched(name: str, sched, *, impl: str, cells: int = 1,
                       grid=None) -> LaunchMeta:
    """From a TriSched: launched == domain == sched.rm_steps per cell (the
    column-major dk/dv walk covers the same domain); the BB bound is the
    n x n dense grid the paper's baseline would launch."""
    if grid is None:
        grid = (cells, sched.rm_steps) if cells > 1 else (sched.rm_steps,)
    return LaunchMeta(
        name=name, family="tri_attn", impl=impl, kind=sched.kind,
        grid=tuple(grid), block_shape=(sched.bq, sched.bk),
        tiles_launched=sched.rm_steps, tiles_domain=sched.rm_steps,
        tiles_bb=sched.n * sched.n, cells=cells)


def meta_from_packed(name: str, psched, *, impl: str, cells: int = 1,
                     grid=None) -> LaunchMeta:
    """From a PackedTriSched: launched == domain == psched.steps per
    cell; the BB bound is the R * n_max^2 pad-to-max batch."""
    r = len(psched.members)
    n_max = max(m.n for m in psched.members)
    if grid is None:
        grid = (cells, psched.steps) if cells > 1 else (psched.steps,)
    return LaunchMeta(
        name=name, family="tri_attn", impl=impl, kind="packed",
        grid=tuple(grid), block_shape=(psched.blk, psched.blk),
        tiles_launched=psched.steps, tiles_domain=psched.steps,
        tiles_bb=r * n_max * n_max, cells=cells,
        extra=(("members", r),))


def meta_dense(name: str, family: str, *, impl: str, grid, block_shape,
               tiles_domain: Optional[int] = None, kind: str = "bb",
               cells: int = 1) -> LaunchMeta:
    """Bounding-box grids (kind "bb", "bb3" for the 3-D cube): launched is
    the grid product over the lambda dims (``grid``); the BB bound equals
    launched."""
    launched = 1
    for g in grid:
        launched *= int(g)
    return LaunchMeta(
        name=name, family=family, impl=impl, kind=kind, grid=tuple(grid),
        block_shape=tuple(block_shape), tiles_launched=launched,
        tiles_domain=tiles_domain, tiles_bb=launched, cells=cells)


def meta_exact(name: str, family: str, *, impl: str, kind: str, steps: int,
               block_shape, bb_bound: Optional[int], cells: int = 1,
               grid=None, extra: tuple = ()) -> LaunchMeta:
    """Exact 1-D schedules (decode rounds): launched == domain == steps."""
    return LaunchMeta(
        name=name, family=family, impl=impl, kind=kind,
        grid=tuple(grid) if grid is not None else (steps,),
        block_shape=tuple(block_shape), tiles_launched=steps,
        tiles_domain=steps, tiles_bb=bb_bound, cells=cells, extra=extra)


def _operand_bytes(operands) -> int:
    total = 0
    for x in operands:
        numel = getattr(x, "numel", None)
        itemsize = getattr(x, "element_size", None)
        if numel is None or itemsize is None:
            continue
        total += int(numel()) * int(itemsize())
    return total


@contextlib.contextmanager
def capture():
    """Collect (meta, operand dtypes) of every launch recorded in the
    block, in order (nestable)."""
    got: list = []
    _CAPTURES.append(got)
    try:
        yield got
    finally:
        _CAPTURES.remove(got)


def record_launch(meta: LaunchMeta, operands=()):
    """Run the pre-launch hook, then emit one launch's counters and trace
    event."""
    if _LAUNCH_HOOK is not None:
        _LAUNCH_HOOK(meta)
    if _CAPTURES:
        dtypes = tuple(x.dtype for x in operands if hasattr(x, "dtype"))
        for got in _CAPTURES:
            got.append((meta, dtypes))
    labels = {"name": meta.name, "impl": meta.impl}
    MET.counter_inc("launches_total", 1, labels)
    MET.counter_inc("tiles_launched_total",
                    meta.tiles_launched * meta.cells, labels)
    if meta.tiles_domain is not None:
        MET.counter_inc("tiles_domain_total",
                        meta.tiles_domain * meta.cells, labels)
        MET.counter_inc("tiles_wasted_total",
                        meta.tiles_wasted * meta.cells, labels)
    if meta.tiles_bb is not None:
        MET.counter_inc("tiles_bb_total", meta.tiles_bb * meta.cells,
                        labels)
    bytes_moved = _operand_bytes(operands)
    MET.counter_inc("launch_bytes_total", bytes_moved, labels)
    if SK.trace_enabled():
        SK.emit_event(meta.as_event(bytes_moved=bytes_moved))


_SUMMARY_FIELDS = {
    "launches_total": "launches",
    "tiles_launched_total": "tiles_launched",
    "tiles_domain_total": "tiles_domain",
    "tiles_wasted_total": "tiles_wasted",
    "tiles_bb_total": "tiles_bb",
    "launch_bytes_total": "bytes_moved",
}


def kernel_summary(registry=None) -> dict:
    """Per-kernel sums of the launch counters, keyed by launch name, over
    every impl label: {name: {launches, tiles_launched, tiles_domain,
    tiles_wasted, tiles_bb, bytes_moved, utilization, improvement_vs_bb,
    impls}}. utilization = domain / launched and improvement_vs_bb =
    bb / launched (the paper's structural I) are taken from the sums."""
    reg = registry or MET.global_registry()
    out: dict = {}
    for key, value in reg.counter_items():
        field = _SUMMARY_FIELDS.get(key[0])
        labels = dict(key[1:])
        if field is None or "name" not in labels:
            continue
        d = out.setdefault(labels["name"],
                           {f: 0 for f in _SUMMARY_FIELDS.values()})
        d[field] += int(value)
        impls = d.setdefault("impls", [])
        if "impl" in labels and labels["impl"] not in impls:
            impls.append(labels["impl"])
    for d in out.values():
        launched = d["tiles_launched"]
        d["utilization"] = d["tiles_domain"] / launched if launched else 0.0
        d["improvement_vs_bb"] = d["tiles_bb"] / launched if launched \
            else 0.0
        d["impls"].sort()
    return out


def instrumented_launch(meta: LaunchMeta, c_fn, operands, *args) -> None:
    """The port's single kernel-launch site: record the launch, call the
    C entry point ``c_fn(*args)`` and raise if it returns a non-zero
    ``cudaGetLastError()`` code (a refused launch never runs, and a later
    synchronize would not report it)."""
    record_launch(meta, operands)
    err = c_fn(*args)
    if err != 0:
        raise RuntimeError(
            f"{meta.name}: CUDA launch failed with cudaError {err} "
            f"(grid={meta.grid}, block_shape={meta.block_shape})")
