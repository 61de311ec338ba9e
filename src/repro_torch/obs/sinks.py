"""Event sinks: a JSONL trace stream, off by default.

Port of the parts of ``repro/obs/sinks.py`` the engine touches:
``enable`` opens ``<trace_dir>/trace-<run_id>.jsonl``, ``emit_event``
appends one JSON object per line (a single boolean check while the sink
is off), ``disable`` closes it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from repro_torch.obs import metrics as MET

SCHEMA_VERSION = "repro.obs/v1"

_lock = threading.Lock()
_trace_fh = None
_seq = 0
_run_id: Optional[str] = None


def enable(trace_dir: str = "artifacts/trace",
           run_id: Optional[str] = None) -> str:
    """Open the trace sink; returns the trace file path."""
    global _trace_fh, _seq, _run_id
    with _lock:
        if _trace_fh is not None:
            _trace_fh.close()
        _seq = 0
        _run_id = run_id or time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace-{_run_id}.jsonl")
        _trace_fh = open(path, "a", encoding="utf-8")
        return path


def disable():
    global _trace_fh
    with _lock:
        if _trace_fh is not None:
            _trace_fh.close()
        _trace_fh = None


def trace_enabled() -> bool:
    return _trace_fh is not None


def emit_event(event: dict):
    """Append one event line to the trace sink (no-op when disabled)."""
    global _seq
    if _trace_fh is None:
        return
    with _lock:
        if _trace_fh is None:
            return
        _seq += 1
        record = {"schema": SCHEMA_VERSION, "seq": _seq,
                  "ts_unix": time.time(), "run_id": _run_id}
        record.update(event)
        _trace_fh.write(json.dumps(record) + "\n")
        _trace_fh.flush()
        MET.global_registry().counter_inc("obs_events_written", 1)
