"""Telemetry-coverage lint, pass 4 of the block-space checker (port of
``repro/analysis/obs_lint.py``).

Every kernel launch of the port goes through
``obs.launch.instrumented_launch``, so every grid, tile and wasted block
is counted. Three rule groups keep that true:

  static coverage   an AST walk over src/repro_torch: no call of a ctypes
                    entry point (an attribute of a ``BUILD.load(...)``
                    result) outside obs/launch.py; and in reverse, every
                    ``extern "C"`` ``*_launch`` symbol of csrc/*.cu and
                    every entry of kernels/build.py's SIGNATURES is handed
                    to some ``instrumented_launch`` call, directly or
                    through a module function that forwards it there (the
                    backward's ``_bwd_launch``; ``member_map_probe`` under
                    the name ``core.member_map_probe``);
  counter fidelity  on the CPU, each op of the launch lint under a scoped
                    registry: ``launches_total`` equals the launches
                    recorded and the declared literal; on the card, a
                    torch.profiler window around one call of each op: the
                    device kernels of the port's csrc (every
                    ``__global__`` name, the WKV walk and the probe
                    included) equal the rise in ``launches_total``;
  schema self-check the obs/schema.py validators accept what obs itself
                    writes, and the launch meta agrees with
                    core/analysis's closed forms.
"""

from __future__ import annotations

import ast
import pathlib
import re
import time
from typing import Dict, List, Set

from repro_torch.analysis.contracts import CheckResult

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
# the one sanctioned call site of a C entry point
_ALLOWED = ("obs/launch.py",)


def _res(rule, ok, detail=""):
    return CheckResult(pass_name="obs", rule=rule, ok=ok, detail=detail)


# ---------------------------------------------------------------------------
# static coverage
# ---------------------------------------------------------------------------


def _build_aliases(tree) -> Set[str]:
    """Names the module binds to repro_torch.kernels.build."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                node.module == "repro_torch.kernels":
            out |= {a.asname or a.name for a in node.names
                    if a.name == "build"}
        elif isinstance(node, ast.Import):
            out |= {a.asname for a in node.names
                    if a.name == "repro_torch.kernels.build" and a.asname}
    return out


def _is_load_call(node, build: Set[str]) -> bool:
    """``BUILD.load(...)``, BUILD an alias of kernels/build.py."""
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr == "load" and \
        isinstance(node.func.value, ast.Name) and node.func.value.id in build


def _load_names(tree, build: Set[str]) -> Set[str]:
    """Names bound to a ``BUILD.load(...)`` result anywhere in the
    module."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                _is_load_call(node.value, build):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def _entry_attr(node, loads: Set[str], build: Set[str]):
    """The entry-point name of ``lib.X`` / ``BUILD.load(...).X``, else
    None."""
    if not isinstance(node, ast.Attribute):
        return None
    base = node.value
    if (isinstance(base, ast.Name) and base.id in loads) or \
            _is_load_call(base, build):
        return node.attr
    return None


def _call_name(call: ast.Call):
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else None


def _forwarders(tree) -> Dict[str, int]:
    """Module functions that hand one parameter to instrumented_launch as
    its entry point: {function name: that parameter's position}."""
    out = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        params = [a.arg for a in fn.args.args]
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    _call_name(node) == "instrumented_launch" and \
                    len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Name) and \
                    node.args[1].id in params:
                out[fn.name] = params.index(node.args[1].id)
    return out


def scan_source(path: pathlib.Path):
    """(raw entry-point calls [(line, name)], entry points handed to
    instrumented_launch) of one module."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    build = _build_aliases(tree)
    loads, fwd = _load_names(tree, build), _forwarders(tree)
    raw, reached = [], set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _entry_attr(node.func, loads, build)
        if name is not None:
            raw.append((node.lineno, name))
        callee = _call_name(node)
        for pos, arg in enumerate(node.args):
            entry = _entry_attr(arg, loads, build)
            if entry is None:
                continue
            if (callee == "instrumented_launch" and pos == 1) or \
                    fwd.get(callee) == pos:
                reached.add(entry)
    return raw, reached


def c_entry_points() -> Set[str]:
    """Every ``extern "C"`` function of csrc/*.cu."""
    out = set()
    for cu in sorted(CSRC.glob("*.cu")):
        out |= set(re.findall(r'extern "C" int (\w+)\(',
                              cu.read_text(encoding="utf-8")))
    return out


def lint_static_coverage(root: pathlib.Path = PKG) -> List[CheckResult]:
    from repro_torch.kernels import build as BUILD

    offenders, reached, scanned = [], set(), 0
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        scanned += 1
        raw, got = scan_source(path)
        reached |= got
        if rel not in _ALLOWED and raw:
            offenders.append(f"{rel}:{raw}")
    out = [_res(
        "obs.coverage.no_raw_entry_call", not offenders,
        f"{scanned} files scanned; C entry points called outside "
        f"obs/launch.py: {offenders or 'none'}")]
    entries = {e for e in c_entry_points() if e.endswith("_launch")}
    signed = {fn for table in BUILD.SIGNATURES.values() for fn in table}
    missing = sorted((entries | signed) - reached)
    out.append(_res(
        "obs.coverage.every_entry_instrumented", not missing,
        f"{len(entries)} extern \"C\" *_launch symbols and {len(signed)} "
        f"SIGNATURES entries; handed to instrumented_launch: "
        f"{len(reached)}; never: {missing or 'none'}"))
    return out


# ---------------------------------------------------------------------------
# counter fidelity
# ---------------------------------------------------------------------------


def _port_kernels(prof) -> List[str]:
    """Names of the device kernels of ``prof`` that the port's csrc
    defines: every ``__global__`` of the table of kernel regions
    (``launch/compat.py``), which a test holds to csrc."""
    from repro_torch.launch import compat

    pat = compat.kernel_regex()
    return [ev.name for ev in prof.events()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")
            and pat.search(ev.name)]


def lint_counter_fidelity(device="cpu") -> List[CheckResult]:
    import torch

    from repro_torch.analysis import launch_lint as LL

    out = []
    kernel = torch.device(device).type == "cuda"
    if not kernel:
        for call in LL.op_calls(device):
            reg, got = LL.run_op(call, kernel=False)
            emitted = int(reg.counter_total("launches_total"))
            declared = sum(LL.EXPECTED[call.name].values())
            out.append(_res(
                f"obs.counters.{call.name}",
                emitted == len(got) == declared,
                f"launches_total {emitted}, launches recorded {len(got)}, "
                f"declared {declared}"))
        return out
    from torch.profiler import ProfilerActivity, profile

    for call in LL.op_calls(device):
        LL.run_op(call, kernel=True)  # builds, first-use buffers
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reg, _ = LL.run_op(call, kernel=True)
            torch.cuda.synchronize()
        emitted = int(reg.counter_total("launches_total"))
        seen = _port_kernels(prof)
        out.append(_res(
            f"obs.counters.{call.name}",
            len(seen) == emitted == sum(LL.EXPECTED[call.name].values()),
            f"launches_total {emitted}; the profiler's csrc kernels "
            f"{len(seen)}: {sorted(s[:60] for s in seen)}"))
    return out


# ---------------------------------------------------------------------------
# schema and closed forms
# ---------------------------------------------------------------------------


def lint_schema_selfcheck(device="cpu") -> List[CheckResult]:
    from repro_torch.core import analysis as A
    from repro_torch.core import mapping as M
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.obs import launch as L
    from repro_torch.obs import metrics as MET
    from repro_torch.obs import schema as SCH

    out = []
    sched = OPS.make_sched(64, block=16)
    meta = L.meta_from_trisched("tri_attn.fwd", sched, impl="cuda", cells=2)
    st = A.strategy_stats(sched.n)["ltm"]
    out.append(_res(
        "obs.closed_forms.trisched",
        meta.tiles_launched == st.launched == M.tri(sched.n)
        and meta.tiles_bb == sched.n * sched.n
        and meta.tiles_domain / meta.tiles_launched == 1.0
        and abs(meta.tiles_bb / meta.tiles_launched
                - st.block_ratio_vs_bb) < 1e-12,
        f"meta launched={meta.tiles_launched} vs analysis {st.launched} "
        f"(= tri({sched.n})); I={meta.tiles_bb / meta.tiles_launched} vs "
        f"block_ratio {st.block_ratio_vs_bb}"))
    ev = meta.as_event(bytes_moved=0)
    errs = SCH.validate_event(ev, envelope=False)
    out.append(_res("obs.schema.launch_event", not errs,
                    f"validate_event on meta.as_event: {errs or 'ok'}"))

    reg = MET.Registry("selfcheck")
    reg.counter_inc("launches_total", 1, {"name": "x", "impl": "torch"})
    reg.histogram_observe("span_ms", 1.5, {"name": "s"})
    doc = {"schema": "repro.obs/v1", "kind": "metrics",
           "created_unix": time.time(), "run_id": None,
           "registry": reg.name, **reg.snapshot()}
    errs = SCH.validate_metrics(doc)
    out.append(_res("obs.schema.metrics_doc", not errs,
                    f"validate_metrics on a registry snapshot: "
                    f"{errs or 'ok'}"))
    traj = [{"schema": "repro.obs/v1", "created_unix": time.time(),
             "kernels": L.kernel_summary(reg)}]
    errs = SCH.validate_trajectory(traj)
    out.append(_res("obs.schema.trajectory", not errs,
                    f"validate_trajectory on a kernel_summary record: "
                    f"{errs or 'ok'}"))
    return out


def run(device="cpu") -> List[CheckResult]:
    out = []
    for rule_fn in (lambda: lint_static_coverage(),
                    lambda: lint_counter_fidelity(device),
                    lambda: lint_schema_selfcheck(device)):
        try:
            out.extend(rule_fn())
        except Exception as e:  # a crash is a lint failure
            out.append(_res("obs.crash", False,
                            f"exception: {type(e).__name__}: {e}"))
    return out
