"""gen_lag_p95_ms: 95th percentile over the requests due in the window of
their submit time minus their due time. The engine is synchronous, so a
request that comes due during a round is submitted after it."""

from bench.core import stats


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["open"]:
        return None
    lags = stats.gen_lag_samples(ctx["requests"], ctx["t0"], ctx["t1"])
    if not lags:
        return None
    return 1e3 * stats.percentile(lags, 95)
