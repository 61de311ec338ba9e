"""The port's checker tools on the CPU: the resilience smoke
(repro_torch.resilience.smoke), the artifact validator
(repro_torch.obs.validate), the timing helpers (repro_torch.obs.timing)
and the fleet's periodic snapshots (Fleet(snapshot_every=)).

* both smoke tiers return 0 on the plain versions, and their artifacts
  pass the validator, which refuses a corrupted line;
* the smoke engine's fault-free tokens equal the reference's greedy
  decode, with the reference's weights carried over by params_from_jax;
* median_of_k / best_of call counts and their bench_seconds histogram;
* a fault-free fleet snapshots on the reference fleet's rounds, and a
  failover whose own snapshot fails migrates from the periodic one.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro.resilience import snapshot as JSNAP
from repro.serve.engine import Engine as JEngine
from repro.serve.fleet import Fleet as JFleet
from repro_torch.configs import registry as REG
from repro_torch.models import model as MD
from repro_torch.obs import metrics as MET
from repro_torch.obs import timing as TM
from repro_torch.obs import validate as VAL
from repro_torch.resilience import smoke as SMOKE
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve.fleet import Fleet

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both smoke tiers run once into one directory: (rcs, directory)."""
    art = tmp_path_factory.mktemp("smoke")
    rcs = (SMOKE.main(["--device", "cpu", "--plans", "2", "--artifacts",
                       str(art)]),
           SMOKE.main(["--device", "cpu", "--fleet", "--artifacts",
                       str(art)]))
    return rcs, art


def test_smoke_tiers_return_zero(artifacts):
    (engine_rc, fleet_rc), art = artifacts
    assert (engine_rc, fleet_rc) == (0, 0)
    assert {p.name for p in art.glob("metrics_*.json")} == {
        "metrics_resilience.json", "metrics_fleet.json"}


def test_validator_accepts_the_smoke_artifacts_and_refuses_corruption(
        artifacts, tmp_path, capsys):
    _, art = artifacts
    files = sorted(str(p) for p in art.glob("metrics_*.json")) + \
        sorted(str(p) for p in (art / "trace").glob("*.jsonl"))
    assert len(files) == 4
    assert VAL.main(["-q"] + files) == 0
    trace = sorted((art / "trace").glob("*.jsonl"))[0]
    lines = trace.read_text().splitlines()
    ev = json.loads(lines[0])
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join([json.dumps(dict(ev, seq=0))] + lines[1:]))
    assert VAL.main(["-q", str(bad)]) == 1
    assert "seq must be int >= 1" in capsys.readouterr().err
    doc = json.loads((art / "metrics_fleet.json").read_text())
    doc["counters"]["fleet_failovers_total"] = 1.5
    bad_doc = tmp_path / "bad.json"
    bad_doc.write_text(json.dumps(doc))
    assert VAL.validate_file(str(bad_doc))
    broken = tmp_path / "broken.jsonl"
    broken.write_text(lines[0] + "\n{not json\n")
    assert any("bad JSON" in e for e in VAL.validate_file(str(broken)))


def test_smoke_tokens_equal_the_reference_greedy_decode():
    jcfg = JREG.smoke_config("yi-9b")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    cfg = REG.smoke_config("yi-9b")
    params = MD.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    _, got = SMOKE.run_engine(cfg, params, "cpu")
    kw = SMOKE.engine_kw("cpu")
    jeng = JEngine(jparams, jcfg, slots=kw["slots"], max_len=kw["max_len"],
                   temperature=0.0, prefill_block=kw["prefill_block"],
                   prefill_impl="scan", decode_impl="scan")
    for uid, p in enumerate(SMOKE.PROMPTS):
        jeng.submit(p, max_new=SMOKE.MAX_NEW, uid=uid)
    want = jeng.run()
    assert got == {u: list(map(int, t)) for u, t in want.items()}
    assert all(len(t) == SMOKE.MAX_NEW for t in got.values())


def test_median_of_k_and_best_of():
    calls = []

    def fn(a):
        calls.append(1)
        return a + 1

    assert TM.median_of_k(fn, torch.zeros(()), reps=3, warmup=1) >= 0.0
    assert len(calls) == 4  # 1 warmup + 3 timed
    reg = MET.Registry("bench")
    with MET.scope(reg):
        TM.best_of(fn, torch.zeros(()), reps=2, warmup=0, name="unit")
    assert reg.histogram_value("bench_seconds", {"name": "unit"})["count"] \
        == 2
    assert len(calls) == 6
    assert TM.median_of_k(fn, torch.zeros(()), reps=4, warmup=0) >= 0.0


def _snapshot_rounds(monkeypatch, snap_mod, make):
    """(fleet round, replica) of every periodic snapshot a fault-free
    fleet built by ``make`` takes."""
    taken, holder = [], {}
    real = snap_mod.snapshot

    def spy(eng):
        fleet = holder["fleet"]
        taken.append((fleet._round, fleet.engines.index(eng)))
        return real(eng)

    monkeypatch.setattr(snap_mod, "snapshot", spy)
    holder["fleet"] = fleet = make()
    for uid, p in enumerate(SMOKE.PROMPTS):
        fleet.submit(p, max_new=SMOKE.MAX_NEW, uid=uid)
    res = fleet.run(max_steps=100)
    return taken, {u: list(map(int, t)) for u, t in res.items()}


@pytest.mark.parametrize("every", [1, 2, 3])
def test_fleet_snapshots_on_the_reference_rounds(every, monkeypatch):
    jcfg = JREG.smoke_config("yi-9b")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    cfg = REG.smoke_config("yi-9b")
    params = MD.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    kw = SMOKE.engine_kw("cpu")
    jkw = dict(slots=kw["slots"], max_len=kw["max_len"], temperature=0.0,
               prefill_block=kw["prefill_block"], prefill_impl="scan",
               decode_impl="scan")
    want, want_res = _snapshot_rounds(
        monkeypatch, JSNAP, lambda: JFleet(jparams, jcfg, engines=2,
                                           engine_kw=jkw,
                                           snapshot_every=every))
    got, got_res = _snapshot_rounds(
        monkeypatch, SNAP, lambda: Fleet(params, cfg, engines=2,
                                         engine_kw=kw, snapshot_every=every))
    assert got == want and len(got) >= 2
    assert got_res == want_res
    assert all(rnd % every == 0 for rnd, _ in got)


def test_fleet_salvages_from_its_periodic_snapshot(monkeypatch):
    """When the victim's own snapshot fails at failover, the fleet
    migrates from the periodic one, and greedy tokens stay identical."""
    from repro_torch.resilience import faults as F
    from repro_torch.serve import fleet as FL

    cfg, params = SMOKE.build("cpu")
    _, baseline = SMOKE.run_engine(cfg, params, "cpu")
    real, state = SNAP.snapshot, {"failing": False, "salvaged": 0}

    def snapshot(eng):
        if state["failing"]:
            state["failing"] = False
            state["salvaged"] += 1
            raise RuntimeError("device lost")
        return real(eng)

    on_fault = Fleet._on_engine_fault

    def failing_fault(self, *a):
        state["failing"] = True
        return on_fault(self, *a)

    monkeypatch.setattr(FL.SNAP, "snapshot", snapshot)
    monkeypatch.setattr(Fleet, "_on_engine_fault", failing_fault)
    plan = F.FaultPlan([F.Fault("launch_error", "decode", 2, times=99,
                                engine=0)])
    fleet = Fleet(params, cfg, engines=2, fault_plan=plan,
                  engine_kw=SMOKE.engine_kw("cpu"), snapshot_every=1)
    for uid, p in enumerate(SMOKE.PROMPTS):
        fleet.submit(p, max_new=SMOKE.MAX_NEW, uid=uid)
    res = fleet.run(max_steps=100)
    assert state["salvaged"] >= 1 and fleet.stats["fleet_failovers_total"]
    assert res == baseline
    fleet = Fleet(params, cfg, engines=2, fault_plan=F.FaultPlan(
        [F.Fault("launch_error", "decode", 0, times=99, engine=0)]),
        engine_kw=SMOKE.engine_kw("cpu"), snapshot_every=0)
    for uid, p in enumerate(SMOKE.PROMPTS):
        fleet.submit(p, max_new=SMOKE.MAX_NEW, uid=uid)
    with pytest.raises(RuntimeError, match="device lost"):
        fleet.run(max_steps=100)
