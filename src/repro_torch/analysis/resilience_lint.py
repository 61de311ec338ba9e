"""Resilience-contract lint, pass 5 of the block-space checker (port of
``repro/analysis/resilience_lint.py``, held to the port's contract).

  vocabulary sync   ``faults.LADDERS`` names exactly
                    ``schema.DEGRADE_STAGES``, every registered transition
                    moves strictly down its ladder, and the engine's
                    ``_inc_res("...")`` literals are exactly
                    ``schema.RESILIENCE_COUNTERS``;
  emission coverage an AST walk over src/repro_torch: ``degrade`` and
                    ``quarantine`` events come only from serve/engine.py,
                    the fleet's ``failover`` / ``engine_quarantine`` /
                    ``rebalance`` never as a raw literal (only through
                    serve/fleet.py's ``_transition`` gate, its
                    ``TRANSITION_EVENTS`` mapping); both gates, the
                    engine's ``_degrade`` and the fleet's ``_transition``,
                    check ``is_registered_transition`` before emitting;
                    the fleet's call sites, counters and gauge match the
                    schema both ways;
  dynamic identity  the smoke engine on the requested device, under the
                    port's contract (ROADMAP C: only poison is absorbed):
                    an injected ``launch_error`` and an ``admit_oom`` each
                    leave ``Engine.run`` as ``EngineStepError``; forced
                    plans (``resilience.smoke.forced_plans``: on the CPU
                    an admit poison walking packed -> sequential, on the
                    card a fused round's poison taking fused -> split;
                    each with a decode poison) fire a degrade and a
                    quarantine with tokens equal to the fault-free run;
                    a fleet whose replica 0 dies fails over token-
                    identically.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List

from repro_torch.analysis.contracts import CheckResult

PKG = pathlib.Path(__file__).resolve().parents[1]
_ENGINE_REL = "serve/engine.py"
_FLEET_REL = "serve/fleet.py"
_FLEET_EVENTS = ("failover", "engine_quarantine", "rebalance")


def _res(rule, ok, detail=""):
    return CheckResult(pass_name="resilience", rule=rule, ok=ok,
                       detail=detail)


def lint_vocab_sync() -> List[CheckResult]:
    from repro_torch.obs import schema as SCH
    from repro_torch.resilience import faults as F

    stages = {s for ladder in F.LADDERS.values() for s in ladder}
    out = [_res(
        "resilience.vocab.ladders_match_schema",
        stages == set(SCH.DEGRADE_STAGES),
        f"LADDERS stages {sorted(stages)} vs schema.DEGRADE_STAGES "
        f"{sorted(SCH.DEGRADE_STAGES)}")]
    bad = []
    for phase, frm, to in F.TRANSITIONS:
        ladder = F.LADDERS[phase]
        if not (ladder.index(frm) < ladder.index(to)
                and F.is_registered_transition(phase, frm, to)):
            bad.append((phase, frm, to))
    out.append(_res(
        "resilience.vocab.transitions_strictly_down", not bad,
        f"{len(F.TRANSITIONS)} transitions checked; violations: "
        f"{bad or 'none'}"))
    return out


def _event_types(call: ast.Call) -> List[str]:
    """The literal "type" values of dict arguments of one call."""
    types = []
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Dict):
            types += [str(v.value) for k, v in zip(arg.keys, arg.values)
                      if isinstance(k, ast.Constant) and k.value == "type"
                      and isinstance(v, ast.Constant)]
    return types


def _gated(tree, fn_name: str) -> bool:
    """Whether ``fn_name`` checks is_registered_transition before it
    emits: an assert on it, or an ``if not ...: raise AssertionError``."""
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name == fn_name):
            continue
        for stmt in fn.body:
            test = stmt.test if isinstance(stmt, (ast.Assert, ast.If)) \
                else None
            if test is None:
                continue
            names = {n.attr for n in ast.walk(test)
                     if isinstance(n, ast.Attribute)}
            names |= {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
            raises = isinstance(stmt, ast.Assert) or any(
                isinstance(s, ast.Raise) and isinstance(s.exc, ast.Call)
                and getattr(s.exc.func, "id", "") == "AssertionError"
                for s in stmt.body)
            if "is_registered_transition" in names and raises:
                return True
    return False


def _literal_calls(tree, attr: str) -> set:
    return {str(node.args[0].value) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == attr and node.args
            and isinstance(node.args[0], ast.Constant)}


def lint_emission_coverage(root: pathlib.Path = PKG) -> List[CheckResult]:
    from repro_torch.obs import schema as SCH

    offenders, scanned = [], 0
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        scanned += 1
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "attr",
                                getattr(node.func, "id", "")) ==
                    "emit_event"):
                continue
            for etype in _event_types(node):
                if (etype in ("degrade", "quarantine")
                        and rel != _ENGINE_REL) or etype in _FLEET_EVENTS:
                    offenders.append(f"{rel}:{node.lineno}:{etype}")
    out = [_res(
        "resilience.coverage.events_from_their_gates", not offenders,
        f"{scanned} files scanned; degrade/quarantine emitted outside "
        f"{_ENGINE_REL}, or fleet events as raw literals: "
        f"{offenders or 'none'}")]
    engine = ast.parse((root / _ENGINE_REL).read_text(encoding="utf-8"))
    fleet = ast.parse((root / _FLEET_REL).read_text(encoding="utf-8"))
    for rel, tree, gate in ((_ENGINE_REL, engine, "_degrade"),
                            (_FLEET_REL, fleet, "_transition")):
        ok = _gated(tree, gate)
        out.append(_res(
            f"resilience.coverage.{gate.strip('_')}_guarded", ok,
            f"{rel} {gate} checks is_registered_transition before it "
            f"emits: {ok}"))
    inc_res = _literal_calls(engine, "_inc_res")
    declared = set(SCH.RESILIENCE_COUNTERS)
    out.append(_res(
        "resilience.coverage.counters_declared", inc_res == declared,
        f"engine emits {sorted(inc_res)}; undeclared "
        f"{sorted(inc_res - declared) or 'none'}; never emitted "
        f"{sorted(declared - inc_res) or 'none'}"))
    return out


def lint_fleet_coverage(root: pathlib.Path = PKG) -> List[CheckResult]:
    from repro_torch.obs import schema as SCH
    from repro_torch.resilience import faults as F
    from repro_torch.serve import fleet as FL

    adjacent = {(phase, F.LADDERS[phase][i], F.LADDERS[phase][i + 1])
                for phase in ("engine", "route")
                for i in range(len(F.LADDERS[phase]) - 1)}
    mapped = set(FL.TRANSITION_EVENTS)
    bad_events = [e for e in FL.TRANSITION_EVENTS.values()
                  if e not in SCH.EVENT_TYPES]
    out = [_res(
        "resilience.fleet.transitions_mapped",
        mapped == adjacent and not bad_events,
        f"adjacent fleet transitions {sorted(adjacent)}; mapped "
        f"{sorted(mapped)}; events outside the schema "
        f"{bad_events or 'none'}")]
    tree = ast.parse((root / _FLEET_REL).read_text(encoding="utf-8"))
    calls = {tuple(str(a.value) for a in node.args[:3])
             for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "_transition" and len(node.args) >= 3
             and all(isinstance(a, ast.Constant) for a in node.args[:3])}
    out.append(_res(
        "resilience.fleet.transition_sites_cover_mapping", calls == mapped,
        f"fleet.py _transition call sites {sorted(calls)} vs "
        f"TRANSITION_EVENTS {sorted(mapped)}"))
    incs = _literal_calls(tree, "_inc")
    gauges = _literal_calls(tree, "gauge_set")
    declared = set(SCH.FLEET_COUNTERS)
    out.append(_res(
        "resilience.fleet.counters_declared",
        incs == declared and gauges <= set(SCH.FLEET_GAUGES),
        f"fleet emits {sorted(incs)}; undeclared "
        f"{sorted(incs - declared) or 'none'}; never emitted "
        f"{sorted(declared - incs) or 'none'}; gauges {sorted(gauges)}"))
    return out


def lint_dynamic_identity(device="cpu") -> List[CheckResult]:
    from repro_torch.resilience import faults as F
    from repro_torch.resilience import smoke as SM
    from repro_torch.serve.engine import EngineStepError

    cfg, params = SM.build(device)
    _, baseline = SM.run_engine(cfg, params, device)
    out = []
    for kind, phase, rnd in (("launch_error", "decode", 1),
                             ("admit_oom", "admit", 0)):
        plan = F.FaultPlan([F.Fault(kind, phase, rnd)])
        try:
            SM.run_engine(cfg, params, device, plan=plan)
            cause = None
        except EngineStepError as e:
            cause = e.cause
        want = F.InjectedLaunchError if kind == "launch_error" \
            else F.InjectedOOM
        out.append(_res(
            f"resilience.dynamic.{kind}_raises", isinstance(cause, want),
            f"an injected {kind} leaves Engine.run as EngineStepError "
            f"caused by {type(cause).__name__ if cause else 'nothing'}"))
    for label, step_mode, plan in SM.forced_plans(device):
        eng, res = SM.run_engine(cfg, params, device, plan=plan,
                                 step_mode=step_mode)
        st = eng.stats
        out.append(_res(
            f"resilience.dynamic.token_identity[{label}]",
            res == baseline and st["launches_degraded_total"] >= 1
            and st["slots_quarantined_total"] >= 1
            and st["requests_failed_total"] == 0,
            f"faulted == fault-free: {res == baseline}; degraded="
            f"{st['launches_degraded_total']} quarantined="
            f"{st['slots_quarantined_total']} failed="
            f"{st['requests_failed_total']}"))
    return out


def lint_dynamic_fleet_failover(device="cpu") -> List[CheckResult]:
    from repro_torch.resilience import faults as F
    from repro_torch.resilience import smoke as SM
    from repro_torch.serve.fleet import Fleet

    cfg, params = SM.build(device)
    _, baseline = SM.run_engine(cfg, params, device)
    plan = F.FaultPlan(
        [F.Fault("launch_error", "decode", 1, times=99, engine=0)])
    fleet = Fleet(params, cfg, engines=2, fault_plan=plan,
                  engine_kw=SM.engine_kw(device))
    for uid, p in enumerate(SM.PROMPTS):
        fleet.submit(p, max_new=SM.MAX_NEW, uid=uid)
    res = fleet.run(max_steps=100)
    st = fleet.stats
    identical = all(res.get(u) == baseline[u] for u in baseline)
    return [_res(
        "resilience.fleet.dynamic_failover_identity",
        identical and st["fleet_failovers_total"] >= 1
        and st["fleet_requests_migrated_total"] >= 1,
        f"failed-over fleet == fault-free engine: {identical}; failovers="
        f"{st['fleet_failovers_total']} migrated="
        f"{st['fleet_requests_migrated_total']}")]


def run(device="cpu") -> List[CheckResult]:
    out = []
    for name, rule_fn in (
            ("vocab", lint_vocab_sync),
            ("emission", lambda: lint_emission_coverage()),
            ("fleet", lambda: lint_fleet_coverage()),
            ("dynamic", lambda: lint_dynamic_identity(device)),
            ("failover", lambda: lint_dynamic_fleet_failover(device))):
        try:
            out.extend(rule_fn())
        except Exception as e:  # a crash is a lint failure
            out.append(_res(f"resilience.{name}", False,
                            f"exception: {type(e).__name__}: {e}"))
    return out
