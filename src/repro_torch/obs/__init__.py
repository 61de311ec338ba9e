"""Telemetry: metrics registry, the single kernel-launch site, spans and
trace sinks (ports of ``repro/obs``)."""
