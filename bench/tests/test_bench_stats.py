"""Window, rate and percentile arithmetic: over all samples, and a stalled
window moves the tail."""

import numpy as np
import pytest

from bench.core import stats


def test_percentile_is_numpys_linear_rule_over_all_samples():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(size=1001)
    for q in (0, 50, 90, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def _req(uid, due, times, status="done"):
    r = stats.Request(uid, due, 10, len(times))
    r.submitted, r.token_times, r.status = due, list(times), status
    return r


def test_ttft_counts_every_request_due_in_the_window():
    reqs = [_req(i, 1.0 + 0.1 * i, [1.05 + 0.1 * i, 1.2 + 0.1 * i])
            for i in range(20)]
    base = stats.percentile(stats.ttft_samples(reqs, 1.0, 3.0), 95)
    assert base == pytest.approx(0.05)
    # a request due at 1.5 with no token by the window's end enters with
    # its wait so far
    tail = stats.ttft_samples(reqs + [_req(99, 1.5, [])], 1.0, 3.0)
    assert max(tail) == pytest.approx(1.5)
    # a stall: no first token before 2.05, so the requests due from 1.0
    # to 2.0 wait for it
    stalled = [_req(r.uid, r.due, [max(r.token_times[0], 2.05)])
               for r in reqs]
    assert stats.percentile(stats.ttft_samples(stalled, 1.0, 3.0), 95) \
        == pytest.approx(0.955)
    # due before the window: not counted
    assert len(stats.ttft_samples(reqs + [_req(98, 0.5, [5.0])], 1.0,
                                  3.0)) == 20


def test_failed_requests_enter_the_tail_and_the_count():
    reqs = [_req(0, 1.0, [1.1]), _req(1, 1.2, [], status="shed")]
    assert stats.ttft_samples(reqs, 1.0, 2.0)[1] == pytest.approx(0.8)
    assert stats.failed_in(reqs, 1.0, 2.0) == 1


def test_gaps_and_tokens_that_end_in_the_window():
    r = _req(0, 0.0, [0.5, 1.5, 1.6, 2.5, 3.5])
    assert stats.itl_samples([r], 1.0, 3.0) == pytest.approx([1.0, 0.1, 0.9])
    assert stats.tokens_in([r], 1.0, 3.0) == 3
    # a stall of 0.5 s in every stream moves the gap tail
    steady = [_req(i, 0.0, np.arange(0, 3, 0.1)) for i in range(5)]
    assert stats.percentile(stats.itl_samples(steady, 1.0, 3.0), 95) == \
        pytest.approx(0.1)
    stalled = [_req(i, 0.0, [t + 0.5 * (t > 2.0) for t in np.arange(0, 3,
                                                                    0.1)])
               for i in range(5)]
    gaps = stats.itl_samples(stalled, 1.0, 3.0)
    assert max(gaps) == pytest.approx(0.6)
    assert stats.percentile(gaps, 95) == pytest.approx(0.6)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_gen_lag():
    r = _req(0, 1.0, [1.3])
    r.submitted = 1.2
    assert stats.gen_lag_samples([r], 0.0, 2.0) == pytest.approx([0.2])
