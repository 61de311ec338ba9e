"""Retry, degradation-ladder registry and straggler watch (ports of the
parts of ``repro/resilience`` the engine uses)."""
