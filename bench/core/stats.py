"""Window, rate and percentile arithmetic of the benchmark.

Every tail is taken over all samples of the window (never a median of
chunks), and every rate over all the work and all the time of the window.
Times are host seconds (``time.perf_counter``).
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, linearly interpolated
    between the two nearest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Iterable[float]) -> float:
    return percentile(values, 50.0)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``), the bound's yardstick."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


class Request:
    """One served request as the load generator saw it: when it was due,
    when it was submitted, and when each of its tokens reached the host."""

    __slots__ = ("uid", "due", "submitted", "token_times", "status",
                 "prompt_len", "max_new")

    def __init__(self, uid: int, due: float, prompt_len: int, max_new: int):
        self.uid, self.due = uid, due
        self.prompt_len, self.max_new = prompt_len, max_new
        self.submitted: float | None = None
        self.token_times: List[float] = []
        self.status = "pending"


def due_in(reqs: Iterable[Request], t0: float, t1: float) -> List[Request]:
    return [r for r in reqs if t0 <= r.due < t1]


def ttft_samples(reqs: Iterable[Request], t0: float, t1: float
                 ) -> List[float]:
    """Seconds from due to first token of every request due in [t0, t1).
    A request with no token by t1 (still waiting, or shed or failed) enters
    with its wait up to t1."""
    out = []
    for r in due_in(reqs, t0, t1):
        first = r.token_times[0] if r.token_times else None
        out.append((first if first is not None and first <= t1 else t1)
                   - r.due)
    return out


def failed_in(reqs: Iterable[Request], t0: float, t1: float) -> int:
    """Requests due in [t0, t1) that were shed or failed."""
    return sum(r.status in ("shed", "failed", "deadline_miss")
               for r in due_in(reqs, t0, t1))


def itl_samples(reqs: Iterable[Request], t0: float, t1: float
                ) -> List[float]:
    """Every gap between consecutive tokens of every request, for the gaps
    that end in [t0, t1]."""
    out = []
    for r in reqs:
        tt = r.token_times
        out += [b - a for a, b in zip(tt, tt[1:]) if t0 <= b <= t1]
    return out


def tokens_in(reqs: Iterable[Request], t0: float, t1: float) -> int:
    """Tokens that reached the host in [t0, t1]."""
    return sum(sum(t0 <= t <= t1 for t in r.token_times) for r in reqs)


def gen_lag_samples(reqs: Iterable[Request], t0: float, t1: float
                    ) -> List[float]:
    """Submit time minus due time of the requests due in [t0, t1) that were
    submitted by t1."""
    return [r.submitted - r.due for r in due_in(reqs, t0, t1)
            if r.submitted is not None and r.submitted <= t1]
