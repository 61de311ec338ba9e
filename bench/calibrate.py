#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's on many seeds, the
control's and the planted faults' on a few, all in one process on the card.
The benchmark's own runs never run this.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --mode program|control|fault:<name> [--seconds S] [--out FILE]

program       a run of the cell (a short window) on each seed: its readings;
control       the plain reference computed in float8 (e4m3) put in the
              program's place, against the float32 reference, on each seed;
fault:<name>  a run with a break planted under the timed path
              (``half_batch`` or ``lr_high`` for a training cell,
              ``token_altered`` for a serving one).
Each seed's readings are printed as one JSON line and, with ``--out``,
gathered into one JSON file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import run as RUN  # noqa: E402
from bench.core import checks, spec, traffic  # noqa: E402


def train_control(c: dict, seed: int, device: str) -> tuple:
    from bench.core.train_cell import _reference_batch
    from bench.reference import model as RM
    from bench.reference import train as RT

    conf = c["config"]
    m, o = spec.model(conf), conf["optimizer"]
    rows = traffic.train_rows(c["traffic"], seed, m["vocab_size"])
    batches = [_reference_batch(r, device)
               for r in rows[:conf["train"]["checked_steps"]]]
    ref = RT.train(m, o, seed, batches, device, RM.Precision("f32"))
    low = RT.train(m, o, seed, batches, device, RM.Precision("fp8"))
    return checks.train_readings(low, ref), checks.train_detail(low, ref)


def serve_control(extra: dict, device: str) -> dict:
    from bench.reference import model as RM

    params, m, seqs, rows, _ = extra["ref_inputs"]
    ref = RM.served_logits(params, m, seqs, rows, RM.Precision("f32"),
                           device)
    low = RM.served_logits(params, m, seqs, rows, RM.Precision("fp8"),
                           device)
    gaps = [g for r, lo in zip(ref, low)
            for g in checks.token_gaps(r, lo.argmax(dim=-1).tolist())]
    return {"tok_gap": max(gaps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    c = spec.cell(args.workload)
    device = "cuda"
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        row = {"workload": args.workload, "seed": seed, "mode": args.mode}
        if args.mode == "control" and \
                traffic.kind(c["traffic"]).DRIVER == "train":
            row["readings"], row["detail"] = train_control(c, seed, device)
        else:
            fault = args.mode.split(":", 1)[1] if \
                args.mode.startswith("fault:") else None
            res = RUN.run_cell(c, seed, args.seconds, False, fault=fault,
                               t_start=time.time())
            extra = res.pop("_extra")
            row["result"] = {k: res[k] for k in ("correct", "attempted",
                                                 "metrics")}
            row["readings"] = extra["readings"]
            row["sample"] = extra.get("sample")
            row["detail"] = extra.get("detail")
            if args.mode == "control":
                row["readings"] = serve_control(extra, device)
            del extra, res
        torch.cuda.empty_cache()
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
