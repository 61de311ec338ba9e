"""Split ``chip_smoke.py``'s wall time by phase, for one or more checkouts
run one after the other on the same card.

    python3 scripts/smoke_phase_times.py --out chiprun_out/phase_times.json \\
        PARENT_ROOT . [...]

Runs ``python3 -u chip_smoke.py`` from each root in the order given and
stamps each line of its standard output with the seconds since that run
began. Consecutive lines that share a prefix (the text before the line's
first colon) form a segment, whose time runs from the last line of the
segment before it to its own last line, so a phase is charged the work
that led to its lines. ``profile`` and ``profiler`` lines join the
segment before them (a phase's windows). Segments are summed by prefix.

Writes each run's exit code, total seconds, seconds by prefix and stamped
lines to ``--out`` (each run's standard error beside it, ``.errN.log``),
and prints the prefixes side by side with their seconds in each run. The
card's name and power limit come first. Exits 1 if any run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

JOIN = {"profile", "profiler"}


def prefix_of(line: str) -> str:
    head, sep, _ = line.partition(":")
    if not sep or len(head) > 48 or "{" in head:
        return "(other)"
    return head.strip()


def run_one(root: Path, err_path: Path, timeout: float) -> dict:
    t0 = time.monotonic()
    stamped = []
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=root, text=True,
            stdout=subprocess.PIPE, stderr=err,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        try:
            for line in proc.stdout:
                stamped.append((time.monotonic() - t0, line.rstrip("\n")))
                if time.monotonic() - t0 > timeout:
                    proc.kill()
                    break
        finally:
            rc = proc.wait()
    total = time.monotonic() - t0
    by_prefix, seg, seg_end = {}, None, 0.0
    last = 0.0
    for t, line in stamped:
        p = prefix_of(line)
        if p in JOIN and seg is not None:
            p = seg
        if p != seg and seg is not None:
            by_prefix[seg] = by_prefix.get(seg, 0.0) + (last - seg_end)
            seg_end = last
        seg, last = p, t
    if seg is not None:
        by_prefix[seg] = by_prefix.get(seg, 0.0) + (last - seg_end)
    by_prefix["(after the last line)"] = total - last
    return {"root": str(root), "rc": rc, "seconds": total,
            "by_prefix": by_prefix, "lines": stamped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds a run may take before it is killed")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate(args.roots):
        err = args.out.with_suffix(f".err{i}.log")
        runs.append(run_one(root.resolve(), err, args.timeout))
        r = runs[-1]
        print(f"run {i} ({root}): rc {r['rc']}, {r['seconds']:.1f} s",
              flush=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}))
    names = []
    for r in runs:
        names += [p for p in r["by_prefix"] if p not in names]
    print("prefix | " + " | ".join(f"run {i} s" for i in range(len(runs))))
    for p in names:
        print(f"{p[:48]} | " + " | ".join(
            f"{r['by_prefix'].get(p, 0.0):.1f}" for r in runs))
    print("total | " + " | ".join(f"{r['seconds']:.1f}" for r in runs))
    return 1 if any(r["rc"] for r in runs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
