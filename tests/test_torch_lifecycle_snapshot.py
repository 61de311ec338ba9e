"""Deadlines across a snapshot restore and a fleet failover == the
reference's.

An engine under per-request deadlines and stragglers is cut mid-run,
captured (in memory, and through to_dir / from_dir), restored onto a
VirtualClock started at 100.0 and run out: every uid ends as it does in
the uninterrupted run and in the reference's restore of the same cut
(statuses, tokens, partial outputs), since request ages are rebased onto
the new clock. A snapshot file written in the format from before requests
carried deadlines restores with none and resumes token-identically. A
two-replica fleet
whose replica 0 dies keeps the reference fleet's statuses and streams with
deadlines, and engine-level shedding (inside a replica's submit) and the
fleet's own each count once, every request in exactly one status.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro.resilience import faults as JF
from repro.resilience import snapshot as JSNAP
from repro.serve import engine as JE
from repro.serve import fleet as JFL
from repro_torch.configs import registry as REG
from repro_torch.models import model as MD
from repro_torch.resilience import faults as F
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve import engine as E
from repro_torch.serve import fleet as FL

torch.set_num_threads(2)

PORT = dict(prefill_impl="torch", decode_impl="torch", device="cpu")
REF = dict(prefill_impl="scan", decode_impl="scan")
SMALL = dict(slots=2, max_len=32, temperature=0.0, prefill_block=4)
PROMPTS = [np.array([3, 1, 4, 1], np.int32),
           np.array([2, 7, 1], np.int32),
           np.array([9, 8, 2, 6, 5], np.int32),
           np.array([5, 4, 3, 2, 1, 7], np.int32)]
MAX_NEW = [6, 6, 6, 3]
DEADLINES = [None, 1.5, 0.5, 2.5]
# two 1 s stragglers walk the clock past uid 2's, then uid 1's deadline
FAULTS = [("straggler", "decode", 1, dict(delay_s=1.0)),
          ("straggler", "decode", 3, dict(delay_s=1.0))]
TERMINAL = {"done", "shed", "deadline_miss", "failed"}


@pytest.fixture(scope="module")
def pair():
    jcfg = JREG.smoke_config("yi-9b")
    tcfg = REG.smoke_config("yi-9b")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _plan(mod, faults):
    return mod.FaultPlan([mod.Fault(k, ph, r, **fk)
                          for k, ph, r, fk in faults])


def _engine(pair, side, **kw):
    jcfg, tcfg, jparams, tparams = pair
    mod = JF if side == "ref" else F
    plan = _plan(mod, FAULTS)
    if side == "ref":
        eng = JE.Engine(jparams, jcfg, fault_plan=plan,
                        clock=mod.VirtualClock(), **REF, **SMALL, **kw)
    else:
        eng = E.Engine(tparams, tcfg, fault_plan=plan,
                       clock=mod.VirtualClock(), **PORT, **SMALL, **kw)
    for uid, (p, mn, dl) in enumerate(zip(PROMPTS, MAX_NEW, DEADLINES)):
        eng.submit(p, max_new=mn, uid=uid, deadline_s=dl)
    return eng


def _outcome(eng, res):
    rep = eng.report()
    assert all(r["status"] in TERMINAL for r in rep.values())
    return {u: (r["status"], res[u]) for u, r in rep.items()}


@pytest.fixture(scope="module")
def uninterrupted(pair):
    out = {}
    for step_mode in ("split", "fused"):
        want = {}
        for side in ("ref", "port"):
            eng = _engine(pair, side, step_mode=step_mode)
            want[side] = _outcome(eng, eng.run())
        assert want["port"] == want["ref"]
        statuses = {u: s for u, (s, _) in want["port"].items()}
        assert statuses[0] == "done" and statuses[2] == "deadline_miss"
        out[step_mode] = want["port"]
    return out


@pytest.mark.parametrize("cut", [2, 3])
@pytest.mark.parametrize("via", ["memory", "file"])
@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_restore_onto_a_later_clock_keeps_the_misses(pair, uninterrupted,
                                                     tmp_path, step_mode,
                                                     via, cut):
    got = {}
    for side in ("ref", "port"):
        mod, snap_mod, ctor = ((JF, JSNAP, JE.Engine) if side == "ref"
                               else (F, SNAP, E.Engine))
        eng = _engine(pair, side, step_mode=step_mode)
        for _ in range(cut):
            eng.round()
        snap = snap_mod.snapshot(eng)
        if via == "file":
            path = str(tmp_path / f"{side}_snap")
            snap = snap_mod.from_dir(snap_mod.to_dir(snap, path))
        clock = mod.VirtualClock(100.0)
        new = ctor.restore(snap, fault_plan=eng.fault_plan, clock=clock)
        ages = {r.uid: clock() - r.submitted_at for r in
                new.queue + [r for r in new.slot_req if r is not None]}
        assert ages == {r.uid: eng.clock() - r.submitted_at for r in
                        eng.queue + [r for r in eng.slot_req
                                     if r is not None]}
        got[side] = _outcome(new, new.run())
    assert got["port"] == got["ref"] == uninterrupted[step_mode]


def test_snapshot_carries_deadlines(pair, tmp_path):
    eng = _engine(pair, "port", step_mode="fused")
    eng.round()
    snap = SNAP.from_dir(SNAP.to_dir(SNAP.snapshot(eng), str(tmp_path / "s")))
    assert [(d["deadline_s"], d["submitted_at"]) for d in snap.queue] == \
        [(r.deadline_s, r.submitted_at) for r in eng.queue]
    assert snap.init_kw["deadline_s"] is None


# the request dict and constructor keywords a snapshot file held before
# requests carried deadlines
OLD_REQ_KEYS = {"uid", "prompt", "max_new", "out", "done", "status",
                "replays", "error"}
OLD_INIT_KW = {"slots", "max_len", "cache_dtype", "temperature", "seed",
               "prefill_mode", "prefill_block", "prefill_impl",
               "decode_mode", "decode_block", "decode_impl", "step_mode",
               "device"}


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_a_file_of_the_older_format_restores(pair, tmp_path, step_mode):
    """A file whose requests have no deadline_s / submitted_at and whose
    constructor keywords predate the lifecycle options restores: every
    request without a deadline, its age counted from the capture, and
    the run resumes token-identically to the uninterrupted one."""
    _, tcfg, _, tparams = pair

    def engine():
        eng = E.Engine(tparams, tcfg, fault_plan=_plan(F, FAULTS),
                       clock=F.VirtualClock(), step_mode=step_mode,
                       **PORT, **SMALL)
        for uid, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
            eng.submit(p, max_new=mn, uid=uid)
        return eng

    want = engine().run()
    eng = engine()
    for _ in range(2):
        eng.round()
    path = SNAP.to_dir(SNAP.snapshot(eng), str(tmp_path / "old"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    reqs = [d for d in meta["slot_req"] if d is not None] + \
        meta["queue"] + meta["finished"]
    assert reqs
    for d in reqs:
        del d["deadline_s"], d["submitted_at"]
        assert set(d) == OLD_REQ_KEYS
    meta["init_kw"] = {k: v for k, v in meta["init_kw"].items()
                       if k in OLD_INIT_KW}
    assert set(meta["init_kw"]) == OLD_INIT_KW
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    clock = F.VirtualClock(100.0)
    new = E.Engine.restore(SNAP.from_dir(path), fault_plan=eng.fault_plan,
                           clock=clock)
    live = new.queue + [r for r in new.slot_req if r is not None]
    assert live
    assert all(r.deadline_s is None and r.submitted_at == 100.0
               for r in live)
    assert new.run() == want
    assert all(r["status"] == "done" for r in new.report().values())


def _fleets(pair, step_mode, faults, engine_kw=(), prompts=PROMPTS,
            max_new=MAX_NEW, deadlines=DEADLINES, **fleet_kw):
    jcfg, tcfg, jparams, tparams = pair
    out = []
    for mod, fleet_mod, params, cfg, side in (
            (JF, JFL, jparams, jcfg, REF), (F, FL, tparams, tcfg, PORT)):
        fleet = fleet_mod.Fleet(
            params, cfg, engines=2, fault_plan=_plan(mod, faults),
            engine_kw=dict(SMALL, step_mode=step_mode, **side,
                           **dict(engine_kw)),
            heartbeat_timeout_s=5.0, snapshot_every=2, **fleet_kw)
        for uid, (p, mn, dl) in enumerate(zip(prompts, max_new, deadlines)):
            fleet.submit(p, max_new=mn, uid=uid, deadline_s=dl)
        out.append(fleet)
    return out


def _fleet_outcome(fleet, n=len(PROMPTS)):
    res = fleet.run(max_steps=200)
    rep = fleet.report()
    assert sorted(rep) == list(range(n))
    assert all(r["status"] in TERMINAL for r in rep.values())
    return {u: (r["status"], res[u]) for u, r in rep.items()}


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_fleet_failover_keeps_the_references_deadlines(pair, step_mode):
    """Replica 0 dies at its decode round 1; its requests migrate with
    their ages, and replica 1's stragglers expire them as the
    reference's fleet does."""
    faults = [("launch_error", "decode", 1, dict(times=99, engine=0)),
              ("straggler", "decode", 1, dict(delay_s=1.0, engine=1)),
              ("straggler", "decode", 3, dict(delay_s=1.0, engine=1))]
    jfleet, tfleet = _fleets(pair, step_mode, faults)
    want, got = _fleet_outcome(jfleet), _fleet_outcome(tfleet)
    assert got == want
    assert tfleet.stats["fleet_failovers_total"] >= 1
    assert "deadline_miss" in {s for s, _ in got.values()}
    assert "done" in {s for s, _ in got.values()}


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_engine_and_fleet_shedding_each_count_once(pair, step_mode):
    """A replica's own max_queue_tiles sheds inside its submit, before the
    fleet's max_fleet_tiles pass: both counters tick, and every request
    ends in exactly one status, as in the reference fleet."""
    # tiles 1, 1, 3, 3, 6: uid 3 passes the fleet's 5 (the later of two
    # 3-tile non-heads), uid 4 its replica's 4
    prompts = PROMPTS + [np.arange(1, 13, dtype=np.int32)]
    jfleet, tfleet = _fleets(pair, step_mode, [],
                             engine_kw=dict(max_queue_tiles=4),
                             max_fleet_tiles=5, prompts=prompts,
                             max_new=[3] * 5, deadlines=[None] * 5)
    t_engine_shed = sum(e.stats["requests_shed_total"]
                        for e in tfleet.engines)
    j_engine_shed = sum(e.stats["requests_shed_total"]
                        for e in jfleet.engines)
    want, got = _fleet_outcome(jfleet, 5), _fleet_outcome(tfleet, 5)
    assert got == want
    shed = [u for u, (s, _) in got.items() if s == "shed"]
    assert shed == [3, 4]
    assert t_engine_shed == j_engine_shed >= 1
    assert tfleet.stats["fleet_requests_shed_total"] == \
        jfleet.stats["fleet_requests_shed_total"] >= 1
    assert len(shed) == t_engine_shed + \
        tfleet.stats["fleet_requests_shed_total"]
    assert all(got[u][1] == [] for u in shed)
