"""Fault-injection smoke tier (port of ``repro/resilience/smoke.py``).

    PYTHONPATH=src python -m repro_torch.resilience.smoke [--plans N] \\
        [--fleet] [--device cuda|cpu] [--artifacts DIR]

Runs the smoke-size yi-9b engine (random seeded weights) under N seeded
random FaultPlans and checks the port's resilience contract end to end:

  * every request reaches exactly one terminal status;
  * every request that completes under faults is token-identical to the
    fault-free run (greedy decode);
  * an injected ``launch_error`` leaves ``Engine.run`` as an
    ``EngineStepError``: the port's engine absorbs only poison
    (``serve/engine.py``), so the random plans draw from the kinds it
    absorbs, poison and straggler;
  * a forced plan makes a degrade and a quarantine fire, tokens
    unchanged: on the CPU an admit poison walks the admit ladder packed
    -> sequential; on the card, whose admit ladder has the one rung
    "packed", a fused round's poison takes the rung fused -> split;
    with a decode poison (quarantine and replay) in both;
  * a snapshot taken mid-run restores and finishes token-identically;
  * the degrade and quarantine events written meanwhile, and the flushed
    metrics document, are schema-valid.

``--fleet`` runs the fleet tier instead: two replicas, replica 0 killed
by a persistent decode launch error, in both step modes; the failed-over
streams equal the fault-free single engine's, every request ends in one
terminal status, the failover / engine_quarantine / rebalance events and
the metrics document are schema-valid.

On the card the engines run the kernels (prefill_block 16); on the CPU
the plain versions at the reference's prefill_block 4. Exit code 0 iff
every check passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch import device as DEV

PROMPTS = (np.array([3, 1, 4, 1, 5], np.int32),
           np.array([2, 7, 1], np.int32),
           np.array([9, 9, 8, 2, 6, 5], np.int32),
           np.array([11, 2, 3, 5, 8, 13, 1], np.int32))
MAX_NEW = 4
TERMINAL = {"done", "shed", "deadline_miss", "failed"}
ABSORBED_KINDS = ("poison", "straggler")


def engine_kw(device) -> dict:
    """The smoke engine's arguments on ``device``: the kernels at
    prefill_block 16 (max_len a multiple of it) on the card, the plain
    versions at the reference's prefill_block 4 on the CPU."""
    dev = DEV.resolve(device)
    if dev.type == "cuda":
        return dict(slots=2, max_len=64, temperature=0.0, prefill_block=16,
                    decode_block=16, prefill_impl="cuda",
                    decode_impl="cuda", device=str(dev))
    return dict(slots=2, max_len=48, temperature=0.0, prefill_block=4,
                decode_block=8, prefill_impl="torch", decode_impl="torch",
                device=str(dev))


def build(device, seed: int = 0):
    """(cfg, params) of the smoke-size yi-9b on ``device``."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD

    cfg = REG.smoke_config("yi-9b")
    return cfg, MD.init_params(cfg, seed=seed, device=device)


def run_engine(cfg, params, device, *, plan=None, step_mode="split",
               prompts=PROMPTS, max_new=MAX_NEW):
    """(engine, {uid: tokens}) of one engine drained under ``plan``."""
    from repro_torch.resilience import faults as F
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, fault_plan=plan, clock=F.VirtualClock(),
                 step_mode=step_mode, **engine_kw(device))
    for uid, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, uid=uid)
    return eng, eng.run()


def forced_plans(device):
    """(label, step mode, plan) of the forced degrade + quarantine runs."""
    from repro_torch.resilience import faults as F

    decode_poison = F.Fault("poison", "decode", 1, times=1)
    plans = [("fused->split", "fused",
              F.FaultPlan([F.Fault("poison", "admit", 0, times=1),
                           decode_poison]))]
    if DEV.resolve(device).type != "cuda":
        # 4 strikes outlast the 3 retries of the packed rung
        plans.insert(0, ("packed->sequential", "split",
                         F.FaultPlan([F.Fault("poison", "admit", 0, times=4),
                                      decode_poison])))
    return plans


def _read_events(path, kinds):
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            ev = json.loads(line)
            if ev.get("type") in kinds:
                out.append(ev)
    return out


def _check_metrics(path, names, check):
    from repro_torch.obs import schema as SCH

    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    errs = SCH.validate_metrics(doc)
    check(not errs, f"metrics doc {path}: {errs or 'schema-valid'}")
    present = [c for c in names
               if any(k.split("{", 1)[0] == c for k in doc["counters"])]
    return present


def engine_tier(args, check) -> None:
    from repro_torch.obs import metrics as MET
    from repro_torch.obs import schema as SCH
    from repro_torch.obs import sinks as SK
    from repro_torch.resilience import faults as F
    from repro_torch.resilience import snapshot as SNAP
    from repro_torch.serve.engine import Engine, EngineStepError

    cfg, params = build(args.device)
    trace_path = SK.enable(
        trace_dir=os.path.join(args.artifacts, "trace"),
        metrics_path=os.path.join(args.artifacts,
                                  "metrics_resilience.json"),
        run_id=f"resilience-smoke-{args.seed}")
    try:
        _, baseline = run_engine(cfg, params, args.device)
        for i in range(args.plans):
            plan = F.FaultPlan.random(args.seed + i, n_rounds=6, rate=0.5,
                                      kinds=ABSORBED_KINDS, delay_s=0.01)
            eng, res = run_engine(cfg, params, args.device, plan=plan)
            rep = eng.report()
            check(set(rep) == set(range(len(PROMPTS)))
                  and all(r["status"] in TERMINAL for r in rep.values()),
                  f"plan {i} ({len(plan.faults)} faults): every request "
                  f"terminal: { {u: r['status'] for u, r in rep.items()} }")
            done = [u for u, r in rep.items() if r["status"] == "done"]
            check(all(res[u] == baseline[u] for u in done),
                  f"plan {i}: {len(done)} completed requests "
                  "token-identical to fault-free")
        plan = F.FaultPlan([F.Fault("launch_error", "decode", 1)])
        try:
            run_engine(cfg, params, args.device, plan=plan)
            raised = None
        except EngineStepError as e:
            raised = e
        check(raised is not None
              and isinstance(raised.cause, F.InjectedLaunchError),
              f"injected launch_error leaves run() as EngineStepError: "
              f"{type(raised).__name__ if raised else 'nothing raised'}")
        for label, step_mode, plan in forced_plans(args.device):
            eng, res = run_engine(cfg, params, args.device, plan=plan,
                                  step_mode=step_mode)
            st = eng.stats
            check(res == baseline and st["launches_degraded_total"] >= 1
                  and st["slots_quarantined_total"] >= 1
                  and st["requests_failed_total"] == 0,
                  f"forced plan {label}: degraded="
                  f"{st['launches_degraded_total']} quarantined="
                  f"{st['slots_quarantined_total']}, tokens identical: "
                  f"{res == baseline}")
        eng = Engine(params, cfg, clock=F.VirtualClock(),
                     **engine_kw(args.device))
        for uid, p in enumerate(PROMPTS):
            eng.submit(p, max_new=MAX_NEW, uid=uid)
        eng.round()
        eng.round()
        # a deadline sweep just before the mid-flight snapshot, as the
        # reference's (each round above sweeps first too)
        eng._expire_deadlines()
        resumed = Engine.restore(SNAP.snapshot(eng)).run()
        check(resumed == baseline,
              "snapshot mid-run -> restore -> run token-identical")
        metrics_path = SK.flush_metrics()
    finally:
        SK.disable()

    events = _read_events(trace_path, ("degrade", "quarantine"))
    for ev in events:
        errs = SCH.validate_event(ev)
        if ev["type"] == "degrade" and not F.is_registered_transition(
                ev["phase"], ev["from"], ev["to"]):
            errs.append(f"unregistered degrade {ev}")
        if errs:
            check(False, f"trace event invalid: {errs}")
    kinds = {ev["type"] for ev in events}
    check(kinds == {"degrade", "quarantine"},
          f"{len(events)} degrade/quarantine events traced and validated")
    present = _check_metrics(metrics_path, SCH.RESILIENCE_COUNTERS, check)
    check(len(present) >= 2,
          f"resilience counters present in the metrics document: {present}")
    check(MET.global_registry().counter_total("engine_decode_rounds") > 0,
          "the global registry carries the engines' engine_* counters")


def fleet_tier(args, check) -> None:
    from repro_torch.obs import schema as SCH
    from repro_torch.obs import sinks as SK
    from repro_torch.resilience import faults as F
    from repro_torch.serve.fleet import Fleet

    cfg, params = build(args.device)
    trace_path = SK.enable(
        trace_dir=os.path.join(args.artifacts, "trace"),
        metrics_path=os.path.join(args.artifacts, "metrics_fleet.json"),
        run_id=f"fleet-smoke-{args.seed}")
    try:
        for step_mode in ("split", "fused"):
            _, baseline = run_engine(cfg, params, args.device,
                                     step_mode=step_mode)
            plan = F.FaultPlan([F.Fault("launch_error", "decode", 1,
                                        times=99, engine=0)])
            fleet = Fleet(params, cfg, engines=2, fault_plan=plan,
                          engine_kw=dict(engine_kw(args.device),
                                         step_mode=step_mode),
                          heartbeat_timeout_s=5.0, snapshot_every=2)
            for uid, p in enumerate(PROMPTS):
                fleet.submit(p, max_new=MAX_NEW, uid=uid)
            res = fleet.run(max_steps=200)
            rep = fleet.report()
            check(set(rep) == set(range(len(PROMPTS)))
                  and all(r["status"] in TERMINAL for r in rep.values()),
                  f"fleet[{step_mode}]: every request terminal: "
                  f"{ {u: r['status'] for u, r in rep.items()} }")
            check(all(res.get(u) == baseline[u] for u in baseline),
                  f"fleet[{step_mode}]: failed-over run token-identical "
                  "to the fault-free single engine")
            st = fleet.stats
            check(st["fleet_failovers_total"] >= 1
                  and st["fleet_requests_migrated_total"] >= 1
                  and st["fleet_engine_restores_total"] >= 1
                  and st["engines_quarantined"] == 0,
                  f"fleet[{step_mode}]: failover fired and drained: "
                  f"failovers={st['fleet_failovers_total']} migrated="
                  f"{st['fleet_requests_migrated_total']} restores="
                  f"{st['fleet_engine_restores_total']}")
        metrics_path = SK.flush_metrics()
    finally:
        SK.disable()

    kinds = {"failover": 0, "engine_quarantine": 0, "rebalance": 0}
    for ev in _read_events(trace_path, tuple(kinds)):
        kinds[ev["type"]] += 1
        errs = SCH.validate_event(ev)
        if errs:
            check(False, f"fleet trace event invalid: {errs}")
    check(all(v >= 1 for v in kinds.values()),
          f"fleet lifecycle events traced and validated: {kinds}")
    present = _check_metrics(metrics_path, SCH.FLEET_COUNTERS, check)
    check(len(present) >= 4,
          f"fleet counters present in the metrics document: {present}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.resilience.smoke",
        description="fault-injection smoke of the port's engine and fleet")
    ap.add_argument("--plans", type=int, default=3,
                    help="seeded random FaultPlans (default 3)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--artifacts", default="artifacts",
                    help="directory of the trace and metrics outputs")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet failover tier instead of the "
                         "engine tier")
    ap.add_argument("--device", default=DEV.DEFAULT_DEVICE,
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    args.device = str(DEV.resolve(args.device))
    failures = []

    def check(ok, what):
        print(("  ok   " if ok else "  FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)

    tier = fleet_tier if args.fleet else engine_tier
    tier(args, check)
    print(f"{'fleet' if args.fleet else 'engine'} resilience smoke on "
          f"{args.device}: {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
