#!/usr/bin/env python3
"""The knee of an open-loop serving cell: its traffic at several fixed
rates, one engine after another in one process on the card, each read for
the backlog it leaves and its tails. The benchmark's own runs never run
this; its reading fixes the rate written in the mix.

    python3 bench/sweep.py --workload <cell> --rates 2,3,4 --seconds 30 \\
        [--seed N] [--out FILE]
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

from bench.core import serve_cell as S  # noqa: E402
from bench.core import spec, stats  # noqa: E402
from bench.core import weights as W  # noqa: E402


def backlog(loop, now: float) -> int:
    """Requests due by ``now`` with no token yet."""
    return sum(1 for r in loop.reqs.values() if not r.token_times) + \
        sum(1 for q in loop.pending[loop.next:]
            if loop.t_base + q.due <= now)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    c = spec.cell(args.workload)
    conf = c["config"]
    m = spec.model(conf)
    cfg = spec.program_config(conf)
    params = W.make_params(m, args.seed, "cuda")
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(c["traffic"], rate_per_s=rate)
        eng = S._engine(params, cfg, conf, "cuda", "cuda")
        loop = S.Loop(eng, mix, args.seed, m["vocab_size"])
        loop.start()
        t0 = loop.t_base + mix["warmup_s"]
        while time.perf_counter() < t0:
            loop.round()
        t1 = t0 + args.seconds
        b0 = backlog(loop, t0)
        mid, bmid = t0 + args.seconds / 2, None
        while time.perf_counter() < t1:
            loop.round()
            if bmid is None and time.perf_counter() >= mid:
                bmid = backlog(loop, time.perf_counter())
        reqs = list(loop.reqs.values())
        ttft = stats.ttft_samples(reqs, t0, t1)
        row = {"rate_per_s": rate,
               "due": len(stats.due_in(reqs, t0, t1)),
               "first_tokens_in_window": sum(
                   1 for r in reqs if r.token_times
                   and t0 <= r.token_times[0] <= t1),
               "backlog_start": b0, "backlog_mid": bmid,
               "backlog_end": backlog(loop, t1),
               "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
               "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
               "itl_p95_ms": 1e3 * stats.percentile(
                   stats.itl_samples(reqs, t0, t1), 95),
               "tokens_per_s": stats.tokens_in(reqs, t0, t1) / args.seconds,
               "card": torch.cuda.get_device_name(0)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del eng, loop
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
