"""Scoped, optional layout hints for model internals (port of
``repro/parallel/hints.py``).

A pass sets hints inside a context; model code reads them with ``get``
and applies layout constraints with ``constrain``. The port runs on one
device, where a layout constraint has nothing to place: ``constrain`` is
the identity. The hint the port's models read is ``moe_groups``, the
dispatch-group count of the MoE ranking (models/moe.py).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict

_HINTS: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "sharding_hints", default={})


@contextlib.contextmanager
def hints(**kw):
    merged = dict(_HINTS.get())
    merged.update({k: v for k, v in kw.items() if v is not None})
    token = _HINTS.set(merged)
    try:
        yield
    finally:
        _HINTS.reset(token)


def get(name: str, default=None):
    return _HINTS.get().get(name, default)


def constrain(x, name: str):
    """The identity: one device has no layout to constrain."""
    return x
