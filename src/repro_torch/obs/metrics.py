"""Metrics registry: label-aware counters, gauges and histograms.

Port of the parts of ``repro/obs/metrics.py`` the port emits (pure
Python, no torch). A ``Registry`` holds instrument values keyed by
(name, sorted labels); ``snapshot`` aggregates them for a metrics
document. Emissions through ``counter_inc`` /
``histogram_observe`` land in the process-global registry and in every
registry opened with ``scope``. ``RingLog`` is the bounded per-round log
the engine keeps.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# powers of two from sub-millisecond clocks to large tile counts
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    float(2 ** e) for e in range(-10, 21))


def _key(name: str, labels: Optional[dict]) -> Tuple:
    if not labels:
        return (name,)
    return (name,) + tuple(sorted(labels.items()))


class Registry:
    """One collection of instrument values (thread-safe, one lock)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, float] = {}
        self._gauges: Dict[Tuple, float] = {}
        self._hists: Dict[Tuple, dict] = {}
        self._hist_bounds: Dict[str, Tuple[float, ...]] = {}

    def counter_inc(self, name: str, value: float = 1.0,
                    labels: Optional[dict] = None):
        if value < 0:
            raise ValueError(f"counter {name} must be monotone (got {value})")
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def histogram_observe(self, name: str, value: float,
                          labels: Optional[dict] = None,
                          buckets: Optional[Sequence[float]] = None):
        bounds = tuple(buckets) if buckets else \
            self._hist_bounds.get(name, DEFAULT_BUCKETS)
        k = _key(name, labels)
        with self._lock:
            self._hist_bounds.setdefault(name, bounds)
            h = self._hists.get(k)
            if h is None:
                h = {"count": 0, "sum": 0.0, "min": float("inf"),
                     "max": float("-inf"),
                     "bucket_counts": [0] * (len(bounds) + 1)}
                self._hists[k] = h
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            for b_i, bound in enumerate(bounds):
                if value <= bound:
                    h["bucket_counts"][b_i] += 1
                    break
            else:
                h["bucket_counts"][-1] += 1

    def gauge_set(self, name: str, value: float,
                  labels: Optional[dict] = None):
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def counter_value(self, name: str, labels: Optional[dict] = None):
        return self._counters.get(_key(name, labels), 0)

    def counter_items(self) -> List[Tuple[Tuple, float]]:
        """Every counter as ((name, (label, value), ...), value)."""
        with self._lock:
            return list(self._counters.items())

    def counter_total(self, name: str):
        """Sum of a counter over all its label sets."""
        return sum(v for k, v in self._counters.items() if k[0] == name)

    def gauge_value(self, name: str, labels: Optional[dict] = None,
                    default=None):
        return self._gauges.get(_key(name, labels), default)

    def histogram_value(self, name: str, labels: Optional[dict] = None):
        return self._hists.get(_key(name, labels))

    @staticmethod
    def _fmt(k: Tuple) -> str:
        if len(k) == 1:
            return k[0]
        inner = ",".join(f"{lk}={lv}" for lk, lv in k[1:])
        return f"{k[0]}{{{inner}}}"

    def snapshot(self) -> dict:
        """Every instrument, aggregated: the body of a metrics document
        (``sinks.flush_metrics``; its format in ``obs/schema.py``)."""
        with self._lock:
            hists = {}
            for k, h in self._hists.items():
                hists[self._fmt(k)] = {
                    "count": h["count"], "sum": h["sum"],
                    "min": h["min"], "max": h["max"],
                    "mean": h["sum"] / max(h["count"], 1),
                    "buckets": list(self._hist_bounds[k[0]]),
                    "bucket_counts": list(h["bucket_counts"]),
                }
            return {
                "counters": {self._fmt(k): v
                             for k, v in sorted(self._counters.items())},
                "gauges": {self._fmt(k): v
                           for k, v in sorted(self._gauges.items())},
                "histograms": hists,
            }


_GLOBAL = Registry("global")
_SCOPES: List[Registry] = []
_scope_lock = threading.Lock()


def global_registry() -> Registry:
    return _GLOBAL


def active_registries() -> List[Registry]:
    """Every registry an emission lands in: global + open scopes."""
    with _scope_lock:
        return [_GLOBAL] + list(_SCOPES)


@contextlib.contextmanager
def scope(registry: Registry):
    """Route emissions inside the block to ``registry`` too (nestable)."""
    with _scope_lock:
        _SCOPES.append(registry)
    try:
        yield registry
    finally:
        with _scope_lock:
            _SCOPES.remove(registry)


def counter_inc(name: str, value: float = 1.0,
                labels: Optional[dict] = None):
    for reg in active_registries():
        reg.counter_inc(name, value, labels)


def gauge_set(name: str, value: float, labels: Optional[dict] = None):
    for reg in active_registries():
        reg.gauge_set(name, value, labels)


def histogram_observe(name: str, value: float,
                      labels: Optional[dict] = None,
                      buckets: Optional[Sequence[float]] = None):
    for reg in active_registries():
        reg.histogram_observe(name, value, labels, buckets)


class RingLog:
    """Bounded append-only log: keeps the last ``maxlen`` entries plus the
    total number of appends, so totals stay exact at O(maxlen) memory."""

    def __init__(self, maxlen: int = 1024):
        if maxlen < 1:
            raise ValueError(f"RingLog maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self._dq = deque(maxlen=maxlen)
        self.total_appended = 0

    def append(self, item):
        self._dq.append(item)
        self.total_appended += 1

    @property
    def dropped(self) -> int:
        return self.total_appended - len(self._dq)

    def items(self) -> list:
        return list(self._dq)
