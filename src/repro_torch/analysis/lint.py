"""Block-space checker CLI (port of ``repro/analysis/lint.py``).

    PYTHONPATH=src python -m repro_torch.analysis.lint [--pass NAME] \\
        [--json [PATH]] [-q] [--device cuda|cpu]

Runs the passes envelope, contracts, launch, obs and resilience on the
requested device (the card by default: the kernels, the device maps and
the profiler; ``--device cpu`` runs the plain versions), prints one line
per check, and exits non-zero if any check fails. ``--json`` writes the
full report (artifacts/lint_report.json when given without a path).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List

from repro_torch import device as DEV
from repro_torch.analysis.contracts import CheckResult

PASSES = ("envelope", "contracts", "launch", "obs", "resilience")


def run_pass(name: str, device="cpu") -> List[CheckResult]:
    if name == "envelope":
        from repro_torch.analysis import envelope as mod
    elif name == "contracts":
        from repro_torch.analysis import verifier as mod
    elif name == "launch":
        from repro_torch.analysis import launch_lint as mod
    elif name == "obs":
        from repro_torch.analysis import obs_lint as mod
    elif name == "resilience":
        from repro_torch.analysis import resilience_lint as mod
    else:
        raise SystemExit(f"unknown pass {name!r}; choose from {PASSES}")
    return mod.run(device)


def run_all(passes=PASSES, device="cpu") -> List[CheckResult]:
    out: List[CheckResult] = []
    for name in passes:
        out.extend(run_pass(name, device))
    return out


def report(results: List[CheckResult], *, verbose: bool = True) -> dict:
    by_pass: dict = {}
    for r in results:
        by_pass.setdefault(r.pass_name, []).append(r)
    if verbose:
        for name, rs in by_pass.items():
            n_fail = sum(not r.ok for r in rs)
            print(f"[{name}] {len(rs) - n_fail}/{len(rs)} checks passed")
            for r in rs:
                print(f"{'  ok ' if r.ok else '  FAIL'} {r.rule}: "
                      f"{r.detail}")
    return {
        "passes": {name: {"checks": len(rs),
                          "failures": sum(not r.ok for r in rs)}
                   for name, rs in by_pass.items()},
        "total_checks": len(results),
        "total_failures": sum(not r.ok for r in results),
        "results": [r.as_dict() for r in results],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's block-space checker")
    ap.add_argument("--json", nargs="?", const="artifacts/lint_report.json",
                    default=None, metavar="PATH",
                    help="write the full report as JSON "
                         "(default artifacts/lint_report.json)")
    ap.add_argument("--pass", dest="only", choices=PASSES, default=None,
                    help="run one pass instead of all of them")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print only the summary line")
    ap.add_argument("--device", default=DEV.DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(DEV.resolve(args.device))

    t0 = time.time()
    results = run_all((args.only,) if args.only else PASSES, device)
    rep = report(results, verbose=not args.quiet)
    rep["device"] = device
    rep["elapsed_s"] = round(time.time() - t0, 2)
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rep, indent=2) + "\n")
        print(f"report written to {path}")
    ok = rep["total_failures"] == 0
    print(f"lint on {device}: {rep['total_checks']} checks, "
          f"{rep['total_failures']} failures, {rep['elapsed_s']}s "
          f"-> {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
