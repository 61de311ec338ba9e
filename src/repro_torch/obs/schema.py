"""Counter vocabulary and trace-event validators shared by the engine, the
fleet and their readers (port of the parts of ``repro/obs/schema.py`` the
serving path touches). Each validator returns a list of problems; an
empty list means valid."""

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
# registry and the process-global one; counts of discrete events.
RESILIENCE_COUNTERS = (
    "requests_retried_total", "launches_degraded_total",
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


def validate_event(ev: dict, *, envelope: bool = True) -> List[str]:
    """Validate one serving trace event; ``envelope`` also requires the
    sink's schema/seq/ts_unix fields of a persisted line. Launch and span
    events are checked for their type only."""
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
    fields = _FIELDS.get(etype, {})
    for field, ftype in fields.items():
        if not isinstance(ev.get(field), ftype):
            errors.append(f"{etype}.{field} missing or not {ftype.__name__}: "
                          f"{ev.get(field)!r}")
    if errors or not fields:
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
