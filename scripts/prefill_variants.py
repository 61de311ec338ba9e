"""Time the owner order of the port's bf16 packed prefill attention on one card.

    python3 scripts/prefill_variants.py [--parent DIR] [--out FILE]

``packed_fwd`` (src/repro_torch/csrc/packed_fwd.cu) and the fused step's
prefill half issue their owners in the pack's order, heads numbered
fastest (``tri::prefill_owner``). This script builds a copy of the
checkout's sources under ``build/prefill_variants/`` whose ``packed_fwd``
issues the last rows first instead (the row index descending over the
members, so an ltm pack starts its longest walks first, as tri_fwd does;
heads fastest), and times both orders in turns at the packed training
shape (the 8 documents of chip_smoke.py's TRAIN_DOCS padded to blk 64,
H 32, Hkv 4, D 128) and at the serving shape (members of
1024/512/256/128 tokens: ltm, band 300, prefix 64, ltm), through the
wrapper (CUDA events) and on the device (profiler). Both orders must give
the same out and lse bit for bit.

With ``--parent DIR`` (an unpacked checkout of another commit, e.g.
``git archive <commit> | tar -x -C build/parent``) it also builds that
checkout's tri_fwd.cu and fwd_bb.cu, which share the forward body of
attn_mma.cuh, and times them against this tree's at the training
attention (B 1, H 32, Hkv 4, S 4096, D 128, ltm, blk 64) in the order
parent, change, change, parent, twice, reporting whether both give the
same out and lse bit for bit.

Prints one JSON object (and writes it to --out). Needs a CUDA card and
nvcc; exits 1 without them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

import _variants as V

ROOT = V.ROOT
ORDERS = ("pack order, heads fastest", "last rows first, heads fastest")

# packed_fwd.cu's owner mapping, and the one the copy gets in its place
# (its two calls given the table)
OWNER = """__device__ __forceinline__ int2 block_owner() {
  return tri::prefill_owner(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y);
}"""
LAST_ROWS_FIRST = """__device__ __forceinline__ int2 block_owner(const int* tbl, int R) {
  const int flat = blockIdx.y * gridDim.x + blockIdx.x, heads = gridDim.y;
  const int *rows = tbl + R, *n = tbl + 2 * R;
  int left = flat / heads, top = 0;
  for (int r = 0; r < R; ++r) top = max(top, n[r]);
  for (int i = top - 1; i >= 0; --i)
    for (int r = 0; r < R; ++r)
      if (n[r] > i && left-- == 0) return make_int2(rows[r] + i, flat % heads);
  return make_int2(0, flat % heads);
}"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose tri_fwd.cu and fwd_bb.cu are "
                         "timed against this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("prefill_variants: torch.cuda.is_available() is False")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.kernels.tri_attn import ops as OPS

    card = V.card()
    BUILD.build_all()
    default = {src: BUILD.load(src)
               for src in ("packed_fwd", "tri_fwd", "fwd_bb")}
    parent = Path(args.parent).resolve() / "src" / "repro_torch" / "csrc" \
        if args.parent else None
    out = ROOT / "build" / "prefill_variants"
    jobs = {"last_rows_first": (V.patched(
        BUILD.CSRC, "prefill_variants", "csrc_last_rows_first",
        {"packed_fwd.cu": [V.swap(OWNER, LAST_ROWS_FIRST),
                           V.swap("block_owner()", "block_owner(tbl, R)",
                                  2)]}),
        "packed_fwd", out / "last_rows_first")}
    if parent:
        jobs.update({f"parent_{src}": (parent, src, out / f"parent_{src}")
                     for src in ("tri_fwd", "fwd_bb")})
    built = {name: lib for name, (lib, _) in V.build(BUILD, jobs).items()}
    libs = dict(zip(ORDERS, (default["packed_fwd"],
                             built["last_rows_first"])))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h, hkv, d, blk = 32, 4, 128, 64

    def rand(*shape, dtype=torch.bfloat16):
        return torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(dtype)

    def use(src, lib):
        BUILD._LIBS[src] = lib

    shapes = {
        "training": OPS.make_packed_sched(
            [-(-n // blk) * blk for n in CS.TRAIN_DOCS], block=blk),
        "serving": OPS.make_packed_sched([1024, 512, 256, 128], block=blk,
                                         window=[None, 300, None, None],
                                         prefix=[0, 0, 64, 0])}
    report = {"card": card, "orders": {}}
    for label, psched in shapes.items():
        s = psched.s_total
        q, k, v = rand(1, h, s, d), rand(1, hkv, s, d), rand(1, hkv, s, d)
        outs = {}
        for order, lib in libs.items():
            use("packed_fwd", lib)
            outs[order] = K.packed_fwd(q, k, v, psched)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
            sys.exit(f"prefill_variants: the orders differ at the {label} "
                     "shape")
        turns = CS._in_turns({order: (lambda lib=lib: (
            use("packed_fwd", lib), K.packed_fwd(q, k, v, psched)))
            for order, lib in libs.items()}, 10, rounds=3)
        rows = {}
        for order, lib in libs.items():
            use("packed_fwd", lib)
            dev_ms = CS._device_ms(lambda: [K.packed_fwd(q, k, v, psched)
                                            for _ in range(20)], 20,
                                   "packed_fwd")
            rows[order] = {"ms": turns[order][0],
                           "ms_turns": turns[order][1], "device_ms": dev_ms}
        report["orders"][label] = {"lens": [m.n * blk
                                            for m in psched.members],
                                   "by_order": rows}
        print(f"prefill_variants: packed_fwd at the {label} shape: " + "; ".join(
            f"{name} {r['ms']:.4f} ms (turns {r['ms_turns']}), device "
            f"{r['device_ms']:.4f}" for name, r in rows.items()), flush=True)
    use("packed_fwd", default["packed_fwd"])

    if parent:
        s = 4096
        q, k, v = rand(1, h, s, d), rand(1, hkv, s, d), rand(1, hkv, s, d)
        sched = OPS.make_sched(s, block=blk)
        report["parent"] = {"dir": str(args.parent)}
        for src, fn in (("tri_fwd", K.fwd), ("fwd_bb", K.fwd_bb)):
            sides = {"parent": built[f"parent_{src}"], "change": default[src]}
            outs = {}
            for side, lib in sides.items():
                use(src, lib)
                outs[side] = fn(q, k, v, sched)
            torch.cuda.synchronize()
            runs = {side: [] for side in sides}
            for side in ("parent", "change", "change", "parent") * 2:
                use(src, sides[side])
                runs[side].append(CS._median_ms(lambda: fn(q, k, v, sched),
                                                10))
            use(src, default[src])
            report["parent"][src] = {
                "bitwise": all(torch.equal(a, b) for a, b in
                               zip(outs["parent"], outs["change"])),
                **{side: {"ms": statistics.median(r), "runs": r}
                   for side, r in runs.items()}}
        print("prefill_variants: parent against change at (B 1, H 32, S 4096, "
              "ltm, blk 64): " + "; ".join(
                  f"{src} parent {r['parent']['ms']:.4f} ms {r['parent']['runs']}"
                  f", change {r['change']['ms']:.4f} ms {r['change']['runs']}, "
                  f"bitwise equal {r['bitwise']}"
                  for src, r in report["parent"].items() if src != "dir"),
              flush=True)
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    print(card)


if __name__ == "__main__":
    main()
