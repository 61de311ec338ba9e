"""Event sinks: a JSONL trace stream and a metrics document, both off by
default (port of ``repro/obs/sinks.py``).

``enable`` opens ``<trace_dir>/trace-<run_id>.jsonl`` (unless
``trace_dir`` is None) and sets the metrics path; ``emit_event`` appends
one JSON object per line (a single boolean check while the sink is off);
``flush_metrics`` writes the global registry's snapshot as a
schema-versioned document; ``disable`` closes both.
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
_metrics_path: Optional[str] = None
_seq = 0
_run_id: Optional[str] = None


def enable(trace_dir: Optional[str] = "artifacts/trace",
           run_id: Optional[str] = None,
           metrics_path: Optional[str] = None) -> Optional[str]:
    """Open the trace sink (none when ``trace_dir`` is None) and set the
    metrics path; returns the trace file path."""
    global _trace_fh, _metrics_path, _seq, _run_id
    with _lock:
        if _trace_fh is not None:
            _trace_fh.close()
            _trace_fh = None
        _seq = 0
        _metrics_path = metrics_path
        _run_id = run_id or time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
        if trace_dir is None:
            return None
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace-{_run_id}.jsonl")
        _trace_fh = open(path, "a", encoding="utf-8")
        return path


def disable():
    """Close the trace sink and forget the metrics path."""
    global _trace_fh, _metrics_path
    with _lock:
        if _trace_fh is not None:
            _trace_fh.close()
        _trace_fh = None
        _metrics_path = None


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


def flush_metrics(path: Optional[str] = None,
                  registry: Optional[MET.Registry] = None) -> Optional[str]:
    """Write ``registry``'s (the global one's) snapshot as a metrics
    document to ``path``, or to the path ``enable`` set; None when neither
    is set."""
    target = path or _metrics_path
    if target is None:
        return None
    reg = registry or MET.global_registry()
    doc = {"schema": SCHEMA_VERSION, "kind": "metrics",
           "created_unix": time.time(), "run_id": _run_id,
           "registry": reg.name, **reg.snapshot()}
    parent = os.path.dirname(target)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = target + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, target)
    return target
