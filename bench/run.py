#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration, traffic
mix, limits and per-layer metrics are files under ``bench/`` found by the
names there. Weights and inputs are made on the card from ``--seed``.
Set-up (the kernels' build or load, the weights, the checked steps or the
warm-up traffic) is timed as ``setup_s``; then the window measures for
``--seconds``. With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read after a profiler
window. Once the window has closed and the program's state is freed, the
plain reference judges what the timed path produced (``correct``). The last
line of standard output is the result as one JSON object; the numbers
compared, each with its limit, are the last lines of standard error.

Exit codes: 0 with a result; 2 without the card the cell asks for; 3 when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.core import checks, spec  # noqa: E402

# top-level module names that must not be loaded where the result is made
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on the wall clock (from /proc), else this
    module's import."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(c: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", impl: str = "cuda",
             t_start: float | None = None, fault: str | None = None) -> dict:
    """One run of cell ``c`` (``spec.cell``); returns the result object
    (its "checks" key last) and, under "_extra", what the control runs
    reuse."""
    import importlib

    from bench.core import traffic

    t_start = process_start() if t_start is None else t_start
    driver = traffic.kind(c["traffic"]).DRIVER
    mod = importlib.import_module(f"bench.core.{driver}_cell")
    out = mod.run(c, seed, seconds, trace, device, impl, t_start, fault)
    correct, shown = checks.judge(out["readings"], c["limits"])
    if trace:
        ctx = out["ctx"]
        metrics = {}
        for m in c["per_layer"]:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = out["end_to_end"]
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": _device_name(device), "count": 1,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": correct, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": dev}
    win = out["ctx"]["profile"] if trace else None
    if win is not None:
        dev["busy_s"] = win.busy_s
        dev["window_s"] = win.wall_s
        res["breakdown"] = win.breakdown()
    res["checks"] = shown
    res["_extra"] = out
    return res


def _device_name(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = spec.cell(args.workload)
    import torch

    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    res = run_cell(c, args.seed, args.seconds, bool(args.trace))
    extra = res.pop("_extra")
    if extra.get("detail"):
        print("detail " + json.dumps(extra["detail"]), file=sys.stderr)
    del extra
    bad = forbidden_loaded()
    if bad:
        print(f"bench: loaded after the window: {bad}", file=sys.stderr)
        return 3
    for name, v in res["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
