"""Fault injection, retry, degradation-ladder registry, liveness and
straggler watch, and crash-safe engine snapshots (ports of
``repro/resilience``)."""
