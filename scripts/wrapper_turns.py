"""Host time of the serving path's kernel wrappers, this tree against
another commit's, in turns on one card.

    python3 scripts/wrapper_turns.py --parent DIR [--rounds N]

DIR is an unpacked ``git archive`` of another commit under build/. Each
measurement is a fresh process (``--child``) that imports repro_torch
from one tree and times, with CUDA events over 20 back-to-back calls
(median of 7), ``kernel.packed_fwd`` and ``ops.packed_decode_attention``
at chip_smoke.py's kernel-phase shapes (yi-9b width, bf16, blk 64): the
wrapper's host work against the device's. Processes run parent, change,
change, parent, ``--rounds`` times; then the change again after the
resilience smoke's two tiers ran in the same process (``--smoke``), as
chip_smoke.py's phase 2b leaves it. Both trees must hold the same csrc
(their kernels are built once, into this tree's build directory, and
copied). Prints one JSON line a measurement and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _median_ms(fn, calls: int = 20, reps: int = 7) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[reps // 2]


def child(smoke: bool) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.kernels.tri_attn import ops as OPS

    BUILD.build_all()
    if smoke:
        from repro_torch.resilience import smoke as SMOKE

        art = ROOT / "build" / "wrapper_turns_artifacts"
        for extra in (["--plans", "3"], ["--fleet"]):
            if SMOKE.main(["--device", "cuda", "--artifacts", str(art)]
                          + extra):
                raise SystemExit("the resilience smoke failed")
    dev, rng = torch.device("cuda"), np.random.default_rng(0)
    h, hkv, d, blk, dt = 32, 4, 128, 64, torch.bfloat16
    rand = lambda *s, dtype=dt: torch.as_tensor(
        rng.standard_normal(s, np.float32), device=dev).to(dtype)
    psched = OPS.make_packed_sched([1024, 512, 256, 128], block=blk,
                                   window=[None, 300, None, None],
                                   prefix=[0, 0, 64, 0])
    s = psched.s_total
    q, k, v = rand(1, h, s, d), rand(1, hkv, s, d), rand(1, hkv, s, d)
    b, s_cache, kv_lens = 4, 2048, [2000, 37, 900, 300]
    tbl_np, needed = OPS.make_decode_table(kv_lens, list(range(b)), blk=blk,
                                           n_members=b + 1, n_slots=b,
                                           s_cache=s_cache)
    tbl = torch.as_tensor(tbl_np, device=dev)
    qd = rand(b, h, d)
    kc = rand(b, s_cache, hkv, d, dtype=torch.float32)
    vc = rand(b, s_cache, hkv, d, dtype=torch.float32)
    spec = OPS.DecodeRoundSpec(n_members=b + 1, capacity=needed, blk=blk,
                               impl="cuda", tiles=needed)
    return {"packed_fwd_ms": _median_ms(lambda: K.packed_fwd(q, k, v,
                                                             psched)),
            "packed_decode_ms": _median_ms(
                lambda: OPS.packed_decode_attention(qd, kc, vc, tbl, spec))}


def _run(src: Path, label: str, smoke: bool = False) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child"]
    out = subprocess.run(cmd + (["--smoke"] if smoke else []),
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    if out.returncode:
        raise SystemExit(f"{label}: rc {out.returncode}\n"
                         f"{out.stderr[-3000:]}")
    row = dict(json.loads(out.stdout.strip().splitlines()[-1]), tree=label)
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked archive of the parent")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.smoke)))
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("wrapper_turns: needs a CUDA card and --parent",
              file=sys.stderr)
        return 1
    parent = Path(args.parent).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as BUILD

    BUILD.build_all()
    built = BUILD.build_dir()
    theirs = parent / "build" / "repro_torch_kernels" / built.name
    if not theirs.exists():
        shutil.copytree(built, theirs)
    rows = []
    for _ in range(args.rounds):
        for label in ("parent", "change", "change", "parent"):
            rows.append(_run(parent / "src" if label == "parent"
                             else ROOT / "src", label))
    rows.append(_run(ROOT / "src", "change after the smoke", smoke=True))
    for label in ("parent", "change", "change after the smoke"):
        sel = [r for r in rows if r["tree"] == label]
        print(f"{label}: packed_fwd " + ", ".join(
            f"{r['packed_fwd_ms']:.4f}" for r in sel) + " ms; decode "
            + ", ".join(f"{r['packed_decode_ms']:.4f}" for r in sel)
            + " ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
