"""Nestable wall-clock spans with device-sync semantics.

Port of ``repro/obs/trace.py``'s ``span``. CUDA work is asynchronous, so
a span around a launch measures the enqueue unless a result is attached:
``sp.attach(t)`` makes the close synchronize the device before the end
timestamp is taken. Each span closes into a ``span_ms`` histogram
(labelled by name) and a ``span`` trace event.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

from repro_torch.obs import metrics as MET
from repro_torch.obs import sinks as SK

_tls = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One open trace region; use via ``span(...)``."""

    def __init__(self, name: str, attrs: Optional[dict] = None):
        st = _stack()
        parent = st[-1] if st else None
        self.name = name
        self.attrs = dict(attrs or {})
        self.parent = parent.name if parent else None
        self.depth = parent.depth + 1 if parent else 0
        self.path = (parent.path + "/" + name) if parent else name
        self.error: Optional[str] = None
        self._sync_cuda = False
        self.t0 = self.t1 = None

    def attach(self, *values):
        """Synchronize the device before the span closes if any attached
        tensor lives on it."""
        for v in values:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                self._sync_cuda = True
        return values[0] if len(values) == 1 else values

    @property
    def duration_ms(self) -> float:
        if self.t0 is None or self.t1 is None:
            return 0.0
        return (self.t1 - self.t0) * 1e3

    def as_event(self) -> dict:
        ev = {"type": "span", "name": self.name, "path": self.path,
              "parent": self.parent, "depth": self.depth,
              "duration_ms": self.duration_ms}
        if self.attrs:
            ev["attrs"] = {str(k): v for k, v in self.attrs.items()}
        if self.error is not None:
            ev["error"] = self.error
        return ev


class _SpanCM:
    def __init__(self, name: str, attrs: dict):
        self._span = Span(name, attrs)

    def __enter__(self) -> Span:
        _stack().append(self._span)
        self._span.t0 = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        if exc is not None:
            sp.error = f"{exc_type.__name__}: {exc}"
        elif sp._sync_cuda:
            torch.cuda.synchronize()
        sp.t1 = time.perf_counter()
        st = _stack()
        if st and st[-1] is sp:
            st.pop()
        MET.histogram_observe("span_ms", sp.duration_ms,
                              labels={"name": sp.name})
        SK.emit_event(sp.as_event())
        return False


def span(name: str, **attrs) -> _SpanCM:
    """Open a nested wall-clock span (context manager yielding the Span)."""
    return _SpanCM(name, attrs)
