"""repro_torch Fleet: tile-cost routing and deterministic failover.

A fleet whose replica 0 is killed by an injected fault (a launch error, an
OOM admission, a poisoned round, a straggler past the heartbeat budget)
emits the token streams of one fault-free engine of the port, in both step
modes, and every request ends in exactly one terminal status. Routing
keeps per-replica tiles within one maximal request, the circuit breaker
stretches probation, a fleet whose every replica died restores one, its
events pass the ported validators, and an exception that no fault plan
injected propagates out of Fleet.run.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.models import model as MD
from repro_torch.obs import schema as SCH
from repro_torch.obs import sinks as SK
from repro_torch.resilience import faults as F
from repro_torch.serve.engine import Engine, EngineStepError
from repro_torch.serve.fleet import Fleet

torch.set_num_threads(2)

TERMINAL = {"done", "shed", "failed"}
PROMPTS = [np.array([3, 1, 4, 1], np.int32),
           np.array([2, 7, 1], np.int32),
           np.array([9, 8, 2, 6, 5], np.int32),
           np.array([5, 5, 2], np.int32)]
MAX_NEW = 3
ENGINE_KW = dict(slots=2, max_len=32, prefill_block=4, decode_block=8,
                 prefill_impl="torch", decode_impl="torch", device="cpu")

# each fault kind as a killer of replica 0
KILLS = {
    "launch_error": F.Fault("launch_error", "decode", 1, times=99,
                            engine=0),
    "admit_oom": F.Fault("admit_oom", "admit", 0, times=99, engine=0),
    "poison": F.Fault("poison", "decode", 1, times=1, engine=0),
    "straggler": F.Fault("straggler", "decode", 1, times=1, delay_s=10.0,
                         engine=0),
}


@pytest.fixture(scope="module")
def ctx():
    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device="cpu")
    eng = Engine(params, cfg, **ENGINE_KW)
    for uid, p in enumerate(PROMPTS):
        eng.submit(p, max_new=MAX_NEW, uid=uid)
    baseline = eng.run()

    def make(plan=None, submit=True, step_mode="split", **kw):
        kw.setdefault("heartbeat_timeout_s", 5.0)
        fleet = Fleet(params, cfg, engines=2, fault_plan=plan,
                      engine_kw=dict(ENGINE_KW, step_mode=step_mode), **kw)
        if submit:
            for uid, p in enumerate(PROMPTS):
                fleet.submit(p, max_new=MAX_NEW, uid=uid)
        return fleet

    return {"make": make, "baseline": baseline}


def _check_contract(fleet, res, baseline, uids):
    """Every request reported once, in a terminal status, and a done
    request's tokens equal the fault-free engine's."""
    rep = fleet.report()
    assert set(rep) == set(uids), "request lost or double-reported"
    assert all(r["status"] in TERMINAL for r in rep.values()), rep
    for uid in uids:
        if rep[uid]["status"] == "done":
            assert res[uid] == baseline[uid % len(PROMPTS)], uid
    return rep


@pytest.mark.parametrize("kind", sorted(KILLS))
@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_failover_token_identity(ctx, kind, step_mode):
    fleet = ctx["make"](plan=F.FaultPlan([KILLS[kind]]),
                        step_mode=step_mode)
    res = fleet.run(max_steps=200)
    rep = _check_contract(fleet, res, ctx["baseline"], range(len(PROMPTS)))
    assert all(r["status"] == "done" for r in rep.values()), rep
    st = fleet.stats
    assert st["fleet_failovers_total"] >= 1, st
    assert st["fleet_requests_migrated_total"] >= 1, st
    assert st["fleet_engine_restores_total"] >= 1, st
    assert st["engines_quarantined"] == 0  # probation drained


def test_routing_balances_by_tiles(ctx):
    fleet = ctx["make"](submit=False)
    long = np.arange(1, 17, dtype=np.int32)  # tri(4) = 10 tiles
    prompts = [long if i % 4 == 0 else PROMPTS[i % len(PROMPTS)]
               for i in range(8)]
    for uid, p in enumerate(prompts):
        fleet.submit(p, max_new=MAX_NEW, uid=uid)
    tiles = [fleet.registry.counter_value("fleet_routed_tiles_total",
                                          {"engine": str(e)})
             for e in range(2)]
    routed = [fleet.registry.counter_value("fleet_requests_routed_total",
                                           {"engine": str(e)})
              for e in range(2)]
    assert min(routed) >= 1, routed
    max_item = max(fleet.engines[0]._prefill_tiles(r)
                   for eng in fleet.engines for r in eng.queue)
    assert abs(tiles[0] - tiles[1]) <= max_item, (tiles, max_item)
    res = fleet.run()
    rep = fleet.report()
    assert set(rep) == set(range(8))
    assert all(r["status"] == "done" for r in rep.values()), rep
    for uid in range(8):
        if uid % 4:  # the long prompt has no baseline
            assert res[uid] == ctx["baseline"][uid % len(PROMPTS)], uid
        assert len(res[uid]) == MAX_NEW


def test_fleet_backpressure_never_sheds_heads(ctx):
    fleet = ctx["make"](submit=False, max_fleet_tiles=4)
    for uid, p in enumerate(PROMPTS * 2):
        fleet.submit(p, max_new=MAX_NEW, uid=uid)
    shed_now = {r.uid for r in fleet._terminal if r.status == "shed"}
    heads = {eng.queue[0].uid for eng in fleet.engines if eng.queue}
    assert shed_now and not shed_now & heads
    res = fleet.run()
    rep = _check_contract(fleet, res, ctx["baseline"], range(8))
    shed = [u for u, r in rep.items() if r["status"] == "shed"]
    assert fleet.stats["fleet_requests_shed_total"] == len(shed) > 0
    assert all(res[u] == [] for u in shed)


def test_circuit_breaker_stretches_probation(ctx):
    """A second consecutive fault trips the breaker: the replica sits out
    the full probation window, then rejoins."""
    plan = F.FaultPlan([
        F.Fault("launch_error", "decode", 1, times=99, engine=0),
        F.Fault("launch_error", "decode", 2, times=99, engine=0)])
    fleet = ctx["make"](plan=plan, breaker_k=2, probation_rounds=6)
    for _ in range(50):  # drive until the first restoration
        fleet.tick()
        if fleet.stats["fleet_engine_restores_total"] >= 1:
            break
    for uid, p in enumerate(PROMPTS, start=len(PROMPTS)):
        fleet.submit(p, max_new=MAX_NEW, uid=uid)
    res = fleet.run(max_steps=300)
    rep = _check_contract(fleet, res, ctx["baseline"], range(8))
    assert all(r["status"] == "done" for r in rep.values()), rep
    st = fleet.stats
    assert st["fleet_failovers_total"] == st["fleet_engine_restores_total"] \
        == 2
    assert [q["probation_rounds"] for q in fleet.quarantine_log] == [1, 6]
    assert [q["consecutive"] for q in fleet.quarantine_log] == [1, 2]
    assert st["engines_quarantined"] == 0


def test_every_replica_dead_self_restores(ctx):
    plan = F.FaultPlan(
        [F.Fault("launch_error", "decode", 1, times=99, engine=-1)])
    fleet = ctx["make"](plan=plan, step_mode="fused")
    res = fleet.run(max_steps=300)
    rep = _check_contract(fleet, res, ctx["baseline"], range(len(PROMPTS)))
    assert all(r["status"] == "done" for r in rep.values()), rep
    assert fleet.stats["fleet_failovers_total"] >= 2


def test_fleet_events_pass_the_validators(ctx, tmp_path):
    path = SK.enable(trace_dir=str(tmp_path), run_id="fleet")
    try:
        fleet = ctx["make"](plan=F.FaultPlan([KILLS["poison"]]),
                            step_mode="fused")
        res = fleet.run(max_steps=200)
    finally:
        SK.disable()
    _check_contract(fleet, res, ctx["baseline"], range(len(PROMPTS)))
    kinds = {"failover": 0, "engine_quarantine": 0, "rebalance": 0}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            ev = json.loads(line)
            assert SCH.validate_event(ev) == [], ev
            if ev["type"] in kinds:
                kinds[ev["type"]] += 1
    assert all(v >= 1 for v in kinds.values()), kinds
    bad = {"type": "failover", "engine": 0, "target": -1, "round": 0,
           "migrated": 1, "reason": "x"}
    assert SCH.validate_event(bad, envelope=False)
    assert SCH.validate_event(dict(bad, target=1), envelope=False) == []


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_real_error_propagates_out_of_the_fleet(ctx, monkeypatch,
                                                step_mode):
    """A replica's exception that no fault plan injected (here the
    decode op raising) is not failed over: Fleet.run raises it."""
    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(SC, "packed_decode_torch", boom)
    fleet = ctx["make"](step_mode=step_mode)
    with pytest.raises(EngineStepError, match="kernel launch failed"):
        fleet.run(max_steps=50)
    assert fleet.stats["fleet_failovers_total"] == 0


@pytest.mark.parametrize("seed", [1, 5])
@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_random_plans_keep_the_contract(ctx, seed, step_mode):
    """Any seeded plan over both replicas: the fleet terminates, every
    request is reported once as done, with the fault-free tokens."""
    plan = F.FaultPlan.random(seed, n_rounds=6, rate=0.4, delay_s=10.0,
                              engines=(0, 1))
    assert plan.faults
    fleet = ctx["make"](plan=plan, step_mode=step_mode)
    res = fleet.run(max_steps=300)
    rep = _check_contract(fleet, res, ctx["baseline"], range(len(PROMPTS)))
    assert all(r["status"] == "done" for r in rep.values()), rep
