"""The traffic generator repeats exactly from a seed, every seed gets the
same sizes and arrivals, and each arrival law keeps its rate and spread."""

import numpy as np
import pytest

from bench.core import traffic
from bench.tests.util import TINY_MIX


def _mix(name):
    m = traffic.load(name)
    m.update(TINY_MIX[m["kind"]])
    return m


@pytest.mark.parametrize("name", ["packed-docs", "dense-4k"])
def test_train_rows_repeat_and_share_geometry(name):
    mix = _mix(name)
    a = traffic.train_rows(mix, 2**31 + 7, 512)
    b = traffic.train_rows(mix, 2**31 + 7, 512)
    c = traffic.train_rows(mix, 5, 512)
    for x, y in zip(a, b):
        for f in ("tokens", "labels", "mask", "positions"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert sorted(map(tuple, (r.doc_lens for r in a))) == \
        sorted(map(tuple, (r.doc_lens for r in c)))
    assert any((x.tokens != y.tokens).any() for x, y in zip(a, c))
    for r in a:
        assert len(r.tokens) <= mix["row_tokens"]
        assert r.loss_tokens == sum(r.doc_lens)


def test_packed_rows_follow_first_fit_decreasing():
    import sys

    sys.path.insert(0, "src")
    from repro_torch.train import data

    lens = [700, 40, 3000, 129, 64, 2048, 1, 900, 4096, 63]
    assert traffic.pack_ffd(lens, 4096, 64) == \
        data.pack_documents(lens, 4096, block=64)


def test_full_size_packed_pool():
    mix = traffic.load("packed-docs")
    rows, blk = traffic.kind(mix).geometry(mix)
    assert len(rows) == 16 and blk == 64
    for r in rows:
        assert sum(-(-n // 64) * 64 for n in r) <= 4096
        assert all(64 <= n <= 4096 for n in r)


@pytest.mark.parametrize("law", [{"law": "poisson"},
                                 {"law": "gamma", "cv": 3.0}],
                         ids=["poisson", "gamma"])
def test_open_loop_repeats(law):
    mix = dict(_mix("chat"), arrivals=law)
    kind = traffic.kind(mix)
    a = kind.schedule(mix, 123, 512)
    b = kind.schedule(mix, 123, 512)
    c = kind.schedule(mix, 2**33 + 1, 512)
    assert [(q.due, q.max_new) for q in a] == [(q.due, q.max_new) for q in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))
    # one schedule for every seed: the same arrivals and sizes in order
    assert [(q.due, len(q.prompt), q.max_new) for q in a] == \
        [(q.due, len(q.prompt), q.max_new) for q in c]
    assert any((x.prompt != y.prompt).any() for x, y in zip(a, c))
    assert all(x.due <= y.due for x, y in zip(a, a[1:]))
    assert len(a) == int(np.ceil(mix["rate_per_s"] * mix["horizon_s"]))


@pytest.mark.parametrize("law,cv", [({"law": "poisson"}, 1.0),
                                    ({"law": "gamma", "cv": 3.0}, 3.0)],
                         ids=["poisson", "gamma"])
def test_arrival_laws_keep_rate_and_spread(law, cv):
    g = traffic.arrivals(law).gaps(np.random.default_rng(5), 4.0, 400_000,
                                   law)
    assert g.mean() == pytest.approx(0.25, rel=0.02)
    assert g.std() / g.mean() == pytest.approx(cv, rel=0.05)


def test_closed_loop_prompts_repeat():
    mix = _mix("batch-waves")
    prompt = traffic.kind(mix).prompt
    p = prompt(mix, 9, 512, 3, 2)
    assert (p == prompt(mix, 9, 512, 3, 2)).all()
    assert len(p) == mix["prompt_len"]
    assert (p != prompt(mix, 9, 512, 3, 3)).any()
