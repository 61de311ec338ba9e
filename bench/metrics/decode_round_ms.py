"""decode_round_ms: median of the program's span ``engine.decode_round``
over the window (one decode round, synchronised at its end)."""

from bench.core import stats


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    ms = [d for n, d in ctx["spans"] if n == "engine.decode_round"]
    return stats.median(ms) if ms else None
