"""admit_ms: median of the program's span ``engine.admit_batch`` over the
window (one packed prefill of an admit round, synchronised at its end)."""

from bench.core import stats


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    ms = [d for n, d in ctx["spans"] if n == "engine.admit_batch"]
    return stats.median(ms) if ms else None
