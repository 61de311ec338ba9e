"""Counter vocabulary and the validators of the obs artifacts: trace
events, metrics documents and trajectories (port of
``repro/obs/schema.py``). Each validator returns a list of problems; an
empty list means valid. ``obs/validate.py`` is their CLI."""

from __future__ import annotations

from typing import List

from repro_torch.obs.sinks import SCHEMA_VERSION

EVENT_TYPES = ("launch", "span", "degrade", "quarantine",
               "failover", "engine_quarantine", "rebalance")

# Stages of the degradation ladders (resilience.faults.LADDERS); degrade
# events may only move between these.
DEGRADE_STAGES = ("packed", "packed_scan", "sequential", "lockstep",
                  "traced", "host", "fused", "split", "requested",
                  "rebucketed", "active", "quarantined", "restored",
                  "primary", "failover")

# Engine counters (per-engine registry, mirrored globally as engine_*).
# The fused_* ones count fused rounds, their single launches, their
# fused -> split fallbacks and the live tiles their launches walked.
ENGINE_COUNTERS = (
    "prefill_launches", "prefill_requests", "prefill_tokens",
    "admit_rounds", "decode_rounds", "decode_packed_launches",
    "decode_lockstep_launches", "decode_tiles_packed",
    "decode_tiles_padded", "fused_rounds", "fused_launches",
    "fused_fallbacks", "fused_tiles",
)

# Resilience counters, emitted under these exact names in the per-engine
# registry and the process-global one; counts of discrete events (the
# reference's seven, in its order).
RESILIENCE_COUNTERS = (
    "requests_retried_total", "deadline_misses_total",
    "launches_degraded_total", "requests_shed_total",
    "slots_quarantined_total", "requests_failed_total",
    "rounds_straggler_total",
)

# Fleet counters (labelled by replica) and the quarantine-set gauge.
FLEET_COUNTERS = (
    "fleet_failovers_total", "fleet_requests_migrated_total",
    "fleet_engine_restores_total", "fleet_rounds_straggler_total",
    "fleet_requests_routed_total", "fleet_routed_tiles_total",
    "fleet_requests_shed_total",
)
FLEET_GAUGES = ("engines_quarantined",)

# Required fields per event type (beyond the sink's envelope), and the
# ones that must be non-negative (>= 1 where the value is a count of
# strikes or rounds).
_FIELDS = {
    "degrade": {"phase": str, "from": str, "to": str, "round": int,
                "reason": str},
    "quarantine": {"slot": int, "uid": int, "round": int, "reason": str},
    "failover": {"engine": int, "target": int, "round": int,
                 "migrated": int, "reason": str},
    "engine_quarantine": {"engine": int, "round": int, "consecutive": int,
                          "probation_rounds": int, "reason": str},
    "rebalance": {"engine": int, "round": int, "reason": str},
}
_NON_NEGATIVE = {
    "degrade": ("round",), "quarantine": ("slot", "round"),
    "failover": ("engine", "target", "round", "migrated"),
    "engine_quarantine": ("engine", "round"), "rebalance": ("engine", "round"),
}
_POSITIVE = {"engine_quarantine": ("consecutive", "probation_rounds")}
_LAUNCH_FIELDS = {
    "name": str, "family": str, "impl": str, "kind": str, "phase": str,
    "grid": list, "cells": int, "block_shape": list,
    "tiles_launched": int, "bytes_moved": int,
}
_LAUNCH_OPTIONAL_INT = ("tiles_domain", "tiles_bb", "tiles_wasted")
_SPAN_FIELDS = {"name": str, "path": str, "depth": int,
                "duration_ms": (int, float)}


def _launch_errors(ev: dict) -> List[str]:
    errors = [f"launch.{f} missing or not {t.__name__}: {ev.get(f)!r}"
              for f, t in _LAUNCH_FIELDS.items()
              if not isinstance(ev.get(f), t)]
    errors += [f"launch.{f} must be int or null: {ev.get(f)!r}"
               for f in _LAUNCH_OPTIONAL_INT
               if not (ev.get(f) is None or isinstance(ev.get(f), int))]
    if errors:
        return errors
    if ev["tiles_domain"] is not None and \
            ev["tiles_wasted"] != ev["tiles_launched"] - ev["tiles_domain"]:
        errors.append("tiles_wasted != tiles_launched - tiles_domain")
    if ev["phase"] != "eager":
        errors.append(f"launch.phase must be eager: {ev['phase']!r}")
    return errors


def _span_errors(ev: dict) -> List[str]:
    return [f"span.{f} missing or not {t}: {ev.get(f)!r}"
            for f, t in _SPAN_FIELDS.items() if not isinstance(ev.get(f), t)]


def validate_event(ev: dict, *, envelope: bool = True) -> List[str]:
    """Validate one trace event; ``envelope`` also requires the sink's
    schema/seq/ts_unix fields of a persisted line."""
    if not isinstance(ev, dict):
        return [f"event is not an object: {type(ev).__name__}"]
    errors: List[str] = []
    if envelope:
        if ev.get("schema") != SCHEMA_VERSION:
            errors.append(f"schema != {SCHEMA_VERSION}: {ev.get('schema')!r}")
        if not (isinstance(ev.get("seq"), int) and ev["seq"] >= 1):
            errors.append(f"seq must be int >= 1: {ev.get('seq')!r}")
        if not isinstance(ev.get("ts_unix"), (int, float)):
            errors.append("ts_unix missing or non-numeric")
    etype = ev.get("type")
    if etype not in EVENT_TYPES:
        return errors + [f"unknown event type {etype!r}"]
    if etype == "launch":
        return errors + _launch_errors(ev)
    if etype == "span":
        return errors + _span_errors(ev)
    fields = _FIELDS[etype]
    for field, ftype in fields.items():
        if not isinstance(ev.get(field), ftype):
            errors.append(f"{etype}.{field} missing or not {ftype.__name__}: "
                          f"{ev.get(field)!r}")
    if errors:
        return errors
    for field in _NON_NEGATIVE.get(etype, ()):
        if ev[field] < 0:
            errors.append(f"{etype}.{field} must be >= 0: {ev[field]!r}")
    for field in _POSITIVE.get(etype, ()):
        if ev[field] < 1:
            errors.append(f"{etype}.{field} must be >= 1: {ev[field]!r}")
    if etype == "degrade":
        for field in ("from", "to"):
            if ev[field] not in DEGRADE_STAGES:
                errors.append(f"degrade.{field} not a registered stage: "
                              f"{ev[field]!r}")
        if ev["from"] == ev["to"]:
            errors.append("degrade.from == degrade.to (not a transition)")
    return errors


def _integral(v) -> bool:
    return isinstance(v, (int, float)) and float(v) == int(v)


def validate_metrics(doc: dict) -> List[str]:
    """Validate a metrics document (``sinks.flush_metrics``)."""
    if not isinstance(doc, dict):
        return [f"metrics doc is not an object: {type(doc).__name__}"]
    errors: List[str] = []
    if doc.get("schema") != SCHEMA_VERSION:
        errors.append(f"schema != {SCHEMA_VERSION}: {doc.get('schema')!r}")
    if doc.get("kind") != "metrics":
        errors.append(f"kind != 'metrics': {doc.get('kind')!r}")
    if not isinstance(doc.get("created_unix"), (int, float)):
        errors.append("created_unix missing or non-numeric")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            errors.append(f"{section} missing or not an object")
    if errors:
        return errors
    for name, v in doc["counters"].items():
        if not (isinstance(v, (int, float)) and v >= 0):
            errors.append(f"counter {name} must be a non-negative number: "
                          f"{v!r}")
            continue
        base = name.split("{", 1)[0]
        if (base in RESILIENCE_COUNTERS or base in FLEET_COUNTERS
                or base.removeprefix("engine_") in RESILIENCE_COUNTERS) \
                and not _integral(v):
            errors.append(f"counter {name} counts discrete events and must "
                          f"be integral: {v!r}")
    for name, v in doc["gauges"].items():
        if name.split("{", 1)[0] in FLEET_GAUGES and \
                not (_integral(v) and v >= 0):
            errors.append(f"fleet gauge {name} must be integral >= 0: "
                          f"{v!r}")
    for name, h in doc["histograms"].items():
        if not isinstance(h, dict):
            errors.append(f"histogram {name} is not an object")
            continue
        missing = [f for f in ("count", "sum", "min", "max", "mean",
                               "buckets", "bucket_counts") if f not in h]
        if missing:
            errors.append(f"histogram {name} missing {missing}")
            continue
        if len(h["bucket_counts"]) != len(h["buckets"]) + 1:
            errors.append(f"histogram {name}: bucket_counts must have "
                          "len(buckets) + 1 entries")
        if sum(h["bucket_counts"]) != h["count"]:
            errors.append(f"histogram {name}: bucket_counts do not sum to "
                          "count")
    return errors


def validate_trajectory(records: list) -> List[str]:
    """Validate a trajectory: a JSON array of run records, each with a
    timestamp and per-kernel block-space geometry (``launch.
    kernel_summary``)."""
    if not isinstance(records, list):
        return [f"trajectory is not an array: {type(records).__name__}"]
    errors: List[str] = [] if records else ["trajectory is empty"]
    for r_i, rec in enumerate(records):
        where = f"trajectory[{r_i}]"
        if not isinstance(rec, dict):
            errors.append(f"{where} is not an object")
            continue
        if rec.get("schema") != SCHEMA_VERSION:
            errors.append(f"{where}.schema != {SCHEMA_VERSION}")
        if not isinstance(rec.get("created_unix"), (int, float)):
            errors.append(f"{where}.created_unix missing")
        kernels = rec.get("kernels")
        if not isinstance(kernels, dict) or not kernels:
            errors.append(f"{where}.kernels missing or empty")
            continue
        for kname, k in kernels.items():
            kw = f"{where}.kernels[{kname}]"
            if not isinstance(k, dict):
                errors.append(f"{kw} is not an object")
                continue
            lau, util = k.get("tiles_launched"), k.get("utilization")
            if "tiles_bb" not in k:
                errors.append(f"{kw} missing tiles_bb")
            if not (isinstance(lau, int) and lau >= 0):
                errors.append(f"{kw}.tiles_launched must be int >= 0: "
                              f"{lau!r}")
            if not (isinstance(util, (int, float))
                    and 0.0 <= util <= 1.0 + 1e-9):
                errors.append(f"{kw}.utilization out of [0, 1]: {util!r}")
    return errors
