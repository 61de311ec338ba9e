"""The port's request lifecycle == the reference engine's, uid for uid.

Deadlines, overload shedding, fifo admission and the quarantine, guard
and ring-log knobs, each held against the reference ``Engine`` on the
same ``VirtualClock`` plan (the reference tests' settings: the smoke
yi-9b, 2 slots, prefill_block 4, greedy, the reference with prefill_impl
"scan" and the port with "torch", float32 weights carried across): the
same terminal status per uid, counters, admit order log, tokens and
partial outputs. Then the refusal of a max_len past the traced map
envelope, the resilience counter vocabulary and the constructor's
keywords.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro.obs import schema as JSCH
from repro.resilience import faults as JF
from repro.serve import engine as JE
from repro_torch.configs import registry as REG
from repro_torch.core import mapping as M
from repro_torch.models import model as MD
from repro_torch.obs import schema as SCH
from repro_torch.resilience import faults as F
from repro_torch.serve import decode as D
from repro_torch.serve import engine as E

torch.set_num_threads(2)

PORT = dict(prefill_impl="torch", decode_impl="torch", device="cpu")
REF = dict(prefill_impl="scan", decode_impl="scan")
SMALL = dict(slots=2, max_len=32, temperature=0.0, prefill_block=4)
# the reference resilience tests' prompts (tests/test_resilience.py)
PROMPTS = [np.array([3, 1, 4, 1], np.int32),
           np.array([2, 7, 1], np.int32),
           np.array([9, 8, 2, 6, 5], np.int32)]
MAX_NEW = 3
TERMINAL = {"done", "shed", "deadline_miss", "failed"}
COUNTERS = ("prefill_launches", "prefill_requests", "prefill_tokens",
            "admit_rounds", "decode_rounds", "decode_packed_launches",
            "decode_lockstep_launches", "decode_tiles_packed",
            "decode_tiles_padded", "fused_rounds", "fused_launches",
            "fused_fallbacks", "fused_tiles", "admit_rounds_total",
            "admit_log_dropped") + SCH.RESILIENCE_COUNTERS


@pytest.fixture(scope="module")
def pair():
    jcfg = JREG.smoke_config("yi-9b")
    tcfg = REG.smoke_config("yi-9b")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(pair, *, faults=(), prompts=PROMPTS, max_new=MAX_NEW,
             deadlines=None, start=0.0, **kw):
    """(reference, port) engines on their own VirtualClock at ``start``
    and their own FaultPlan of the same ``faults`` (kind, phase, round,
    keywords), with ``prompts`` submitted (``deadlines[uid]`` each)."""
    jcfg, tcfg, jparams, tparams = pair
    kw = dict(SMALL, **kw)
    out = []
    for mod, cfg, params, side in ((JF, jcfg, jparams, REF),
                                   (F, tcfg, tparams, PORT)):
        plan = mod.FaultPlan([mod.Fault(k, ph, r, **fk)
                              for k, ph, r, fk in faults]) if faults else None
        ctor = JE.Engine if mod is JF else E.Engine
        eng = ctor(params, cfg, fault_plan=plan,
                   clock=mod.VirtualClock(start), **side, **kw)
        for uid, p in enumerate(prompts):
            mn = max_new[uid] if isinstance(max_new, (list, tuple)) \
                else max_new
            eng.submit(p, max_new=mn, uid=uid,
                       deadline_s=None if deadlines is None
                       else deadlines[uid])
        out.append(eng)
    return out


def _statuses(eng):
    return {u: r["status"] for u, r in eng.report().items()}


def _same(jeng, teng, jres, tres):
    """The port's run equals the reference's: statuses per uid, tokens
    and partial outputs, counters and the admit order log."""
    assert _statuses(teng) == _statuses(jeng)
    assert all(s in TERMINAL for s in _statuses(teng).values())
    assert tres == jres
    jst, tst = jeng.stats, teng.stats
    for name in COUNTERS:
        assert tst[name] == jst[name], name
    assert tst["admit_order_log"] == [list(r) for r in
                                      jst["admit_order_log"]]
    assert tst["admit_round_tiles"] == list(jst["admit_round_tiles"])
    assert {u: r["replays"] for u, r in teng.report().items()} == \
        {u: r["replays"] for u, r in jeng.report().items()}


def _run(pair, **kw):
    jeng, teng = _engines(pair, **kw)
    jres, tres = jeng.run(max_steps=200), teng.run(max_steps=200)
    _same(jeng, teng, jres, tres)
    return jeng, teng, jres, tres


@pytest.fixture(scope="module")
def baseline(pair):
    return {mode: _run(pair, step_mode=mode)[3] for mode in
            ("split", "fused")}


# ---------------------------------------------------------------------------
# deadlines, shedding, quarantine (tests/test_resilience.py:161-205)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_deadline_miss_is_explicit(pair, baseline, step_mode):
    """A straggler past the TTL retires queued and running requests as
    deadline_miss, with their partial outputs, on both engines alike."""
    jeng, teng, _, tres = _run(
        pair, step_mode=step_mode, deadline_s=0.5,
        faults=[("straggler", "decode", 1, dict(delay_s=2.0))])
    st = _statuses(teng)
    missed = [u for u, s in st.items() if s == "deadline_miss"]
    assert missed and teng.stats["deadline_misses_total"] == len(missed)
    assert all(teng.report()[u]["error"] for u in missed)
    # a missed request kept the tokens it had: a prefix of its full run
    assert any(tres[u] for u in missed)
    assert all(tres[u] == baseline[step_mode][u][:len(tres[u])]
               for u in missed)


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_per_request_deadlines(pair, step_mode):
    """submit(deadline_s=) overrides the engine's; None keeps it (here:
    none). Two stragglers walk the clock past one deadline, then the
    next; the deadline-free request finishes."""
    _, teng, _, _ = _run(
        pair, step_mode=step_mode, deadlines=[None, 1.5, 0.5, None],
        prompts=PROMPTS + [np.array([5, 4, 3, 2, 1, 7], np.int32)],
        max_new=[6, 6, 6, 2],
        faults=[("straggler", "decode", 1, dict(delay_s=1.0)),
                ("straggler", "decode", 3, dict(delay_s=1.0))])
    st = _statuses(teng)
    assert st[0] == "done" and st[1] == st[2] == "deadline_miss"


def test_a_deadline_is_strict(pair):
    """now - submitted_at must pass the deadline, not reach it."""
    _, teng, _, _ = _run(pair, deadline_s=1.0, faults=[
        ("straggler", "decode", 0, dict(delay_s=1.0))])
    assert teng.stats["deadline_misses_total"] == 0


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_overload_shedding_spares_the_head(pair, step_mode):
    """max_queue_tiles sheds the heaviest non-head request at submit; the
    head survives and a shed request returns an empty output."""
    jeng, teng = _engines(pair, step_mode=step_mode, max_queue_tiles=2)
    assert teng.stats["requests_shed_total"] == 1
    assert teng.report()[0]["status"] != "shed"
    jres, tres = jeng.run(), teng.run()
    _same(jeng, teng, jres, tres)
    shed = [u for u, s in _statuses(teng).items() if s == "shed"]
    assert shed == [2] and tres[2] == []


def test_shedding_breaks_ties_by_index(pair):
    """Among equally heavy non-head requests the later one goes first;
    a heavy head is never shed."""
    prompts = [np.arange(1, 13, dtype=np.int32)] + \
        [np.arange(2, 2 + n, dtype=np.int32) for n in (8, 8, 4, 1)]
    jeng, teng = _engines(pair, prompts=prompts, max_queue_tiles=12)
    jres, tres = jeng.run(), teng.run()
    _same(jeng, teng, jres, tres)
    st = _statuses(teng)
    # tiles 6 | 3 3 1 1: the fourth submit passes 12, and of the two
    # 3-tile requests the later, uid 2, goes
    assert [u for u, s in st.items() if s == "shed"] == [2]
    assert st[0] == st[1] == "done"
    for cap in (5, 2):  # a head past the cap alone still stays
        _, teng = _engines(pair, prompts=prompts, max_queue_tiles=cap)
        assert [r.uid for r in teng.queue] == [0]
        assert teng.stats["requests_shed_total"] == 4


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_quarantine_never_deadlocks(pair, baseline, step_mode):
    """Poison every early round on a 1-slot engine held out for 10,000
    rounds: the engine releases a slot rather than spin forever."""
    faults = [("poison", "decode", r, {}) for r in range(3)]
    jeng, teng, _, tres = _run(pair, slots=1, quarantine_rounds=10_000,
                               step_mode=step_mode, faults=faults,
                               prompts=PROMPTS[:1])
    assert _statuses(teng) == {0: "done"}
    assert tres[0] == baseline[step_mode][0]
    # split: rounds 0-2 each poisoned; fused: decode round 0 is the admit
    assert teng.stats["slots_quarantined_total"] == \
        {"split": 3, "fused": 1}[step_mode]


def test_quarantine_rounds_hold_the_slot(pair):
    """A poisoned slot sits out quarantine_rounds rounds: at 2 slots and
    a long hold the replay waits on the other slot."""
    for rounds in (0, 20):
        _run(pair, quarantine_rounds=rounds,
             faults=[("poison", "decode", 1, {})])


# ---------------------------------------------------------------------------
# the traced-map envelope (tests/test_resilience.py:231)
# ---------------------------------------------------------------------------


def _first_len_past_the_envelope(block: int) -> int:
    """The least max_len whose tri(ceil(S / block)) - 1 passes
    LTM_TRACED_MAX_LAM."""
    n = 1
    while M.tri(n) - 1 <= M.LTM_TRACED_MAX_LAM:
        n += 1
    return (n - 1) * block + 1


@pytest.mark.parametrize("step_mode", ["split", "fused"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_max_len_past_the_envelope_is_refused(pair, impl, step_mode):
    """The reference's rung traced -> host (its host-map prefill) is not
    ported: a max_len whose admit round could pass the envelope is
    refused at construction on either impl, before any cache is made;
    one token less is inside it."""
    _, tcfg, _, tparams = pair
    past = _first_len_past_the_envelope(16)
    assert not D.traced_prefill_ok([past], 16)
    assert D.traced_prefill_ok([past - 1], 16)
    kw = dict(SMALL, prefill_block=16, decode_block=16, prefill_impl=impl,
              decode_impl=impl, step_mode=step_mode, device="cpu")
    with pytest.raises(ValueError, match="traced map envelope"):
        E.Engine(tparams, tcfg, **dict(kw, max_len=past))


# ---------------------------------------------------------------------------
# admission order, ring logs (tests/test_serve.py, test_obs.py)
# ---------------------------------------------------------------------------


def test_cost_and_fifo_admission(pair):
    """The reference's lumpy queue (17, 16, 2, 3 tokens): "cost" evens
    the admit rounds, "fifo" keeps arrival order, tokens equal."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 512, size=s).astype(np.int32)
               for s in (17, 16, 2, 3)]
    res = {}
    for order in ("cost", "fifo"):
        _, teng, _, res[order] = _run(pair, prompts=prompts, max_new=4,
                                      max_len=48, admit_order=order)
        res[order + "_tiles"] = teng.stats["admit_round_tiles"]
        res[order + "_log"] = teng.stats["admit_order_log"]
    assert res["cost"] == res["fifo"]
    assert res["fifo_tiles"] == [15 + 10, 1 + 1]
    assert res["cost_tiles"] == [15 + 1, 10 + 1]
    assert res["cost_log"][0] == [(0, 15), (2, 1)]
    assert res["fifo_log"][0] == [(0, 15), (1, 10)]


def test_unknown_admit_order_is_refused(pair):
    _, tcfg, _, tparams = pair
    with pytest.raises(ValueError, match="admit_order"):
        E.Engine(tparams, tcfg, admit_order="lifo", **PORT, **SMALL)


def test_stats_ring_cap(pair):
    """stats_log_rounds=2 caps the admit logs; the totals stay exact
    (tests/test_obs.py:295)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 50, size=4).astype(np.int32)
               for _ in range(6)]
    _, teng, _, _ = _run(pair, prompts=prompts, max_new=2,
                         stats_log_rounds=2)
    st = teng.stats
    assert len(st["admit_round_tiles"]) == len(st["admit_order_log"]) == 2
    assert st["admit_rounds_total"] == st["admit_rounds"] >= 3
    assert st["admit_log_dropped"] == st["admit_rounds_total"] - 2


# ---------------------------------------------------------------------------
# the output guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_guard_off_under_poison(pair, baseline, step_mode, monkeypatch):
    """guard_output=False: an injected decode poison lands on a host copy
    nobody inspects, so nothing is quarantined and the tokens are the
    fault-free ones; the admit and fused state checks never run."""
    def no_call(*a, **k):
        raise AssertionError("the guard ran with guard_output=False")

    jeng, teng = _engines(pair, step_mode=step_mode, guard_output=False,
                          faults=[("poison", "decode", 1, {})])
    monkeypatch.setattr(D, "states_finite", no_call)
    monkeypatch.setattr(D, "poisoned_slots", no_call)
    tres = teng.run()
    monkeypatch.undo()
    _same(jeng, teng, jeng.run(), tres)
    assert tres == baseline[step_mode]
    assert teng.stats["slots_quarantined_total"] == 0
    # the poison's strike was spent on the host copy, as the reference's
    assert teng.fault_plan._fired == {0: 1}


def test_guard_off_makes_no_host_copy(pair, monkeypatch):
    """With the guard off and no fault plan the decode round copies no
    logits to the host for inspection."""
    _, teng = _engines(pair, guard_output=False)
    seen = []
    real = torch.Tensor.numpy

    def spy(t, *a, **k):
        if t.dim() == 2 and t.shape[-1] == teng.cfg.padded_vocab:
            seen.append(tuple(t.shape))
        return real(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "numpy", spy)
    teng.run()
    assert not seen


# ---------------------------------------------------------------------------
# the counter vocabulary, the constructor
# ---------------------------------------------------------------------------


def test_resilience_counters_are_the_references():
    assert SCH.RESILIENCE_COUNTERS == JSCH.RESILIENCE_COUNTERS


# the reference's keywords the port leaves out on purpose (ROADMAP A):
# no caller of the port sets them
LEFT_OUT = {"auto_cost_measure", "prefill_bucket", "traced_max_lam"}


def test_engine_keywords_are_the_references():
    """Every keyword of the reference's Engine but the three left out on
    purpose, plus the device; all of them land in _init_kw but the
    process harness."""
    ref = set(inspect.signature(JE.Engine.__init__).parameters)
    port = set(inspect.signature(E.Engine.__init__).parameters)
    assert LEFT_OUT <= ref
    assert port == (ref - LEFT_OUT) | {"device"}
    harness = {"self", "params", "cfg", "fault_plan", "clock", "retry",
               "escalate_step_errors"}
    jcfg = REG.smoke_config("yi-9b")
    eng = E.Engine(MD.init_params(jcfg, seed=0, device="cpu"), jcfg, **PORT)
    assert set(eng._init_kw) == port - harness
