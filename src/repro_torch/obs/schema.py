"""Counter vocabulary shared by the engine and its readers (port of the
part of ``repro/obs/schema.py`` the engine touches)."""

# Resilience counters, emitted under these exact names in the per-engine
# registry and the process-global one; counts of discrete events.
RESILIENCE_COUNTERS = (
    "requests_retried_total", "launches_degraded_total",
    "slots_quarantined_total", "requests_failed_total",
    "rounds_straggler_total",
)
