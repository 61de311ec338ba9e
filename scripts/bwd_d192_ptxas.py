"""What ptxas says of the attention backward at head dim 192 (run on a
machine with nvcc; no card needed).

The backward's sources (csrc/tri_bwd.cu, csrc/packed_bwd.cu) dispatch head
dims 16-128 (csrc/attn_tiles.cuh's dispatch_tile). This script builds a
patched copy of them that dispatches the forward's set, 192 included, with
the port's nvcc flags, and prints each D 192 instantiation's registers and
spill stores beside the D 128 one of the same kernel and edge, and
BwdShape's shared memory at D 192 against the block's limit. It measures
what a D 192 backward body has to fit; nothing of it is loaded or run.

    python3 scripts/bwd_d192_ptxas.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _variants as V  # noqa: E402

sys.path.insert(0, str(V.ROOT / "src"))
from repro_torch.kernels import build as BUILD  # noqa: E402

SOURCES = ("tri_bwd", "packed_bwd")
# (kernel, BLK, D) of a mangled bf16 (tensor-core) or f32 instantiation
KERNELS = ("tri_bwd_dq_tc_kernel", "tri_bwd_dkv_tc_kernel",
           "tri_bwd_dq_kernel", "tri_bwd_dkv_kernel",
           "packed_bwd_dq_tc_kernel", "packed_bwd_dkv_tc_kernel",
           "packed_bwd_dq_kernel", "packed_bwd_dkv_kernel")
KEY = re.compile(rf"\d({'|'.join(KERNELS)})I(?:13__nv_bfloat16|f)?"
                 r"Li(\d+)ELi(\d+)E")


def _report(log: str) -> dict:
    lines, rows = log.splitlines(), {}
    for at, line in enumerate(lines):
        m = KEY.search(line)
        if "Compiling entry" not in line or m is None:
            continue
        dtype = "f32" if re.search(r"_kernelIf", line) else "bf16"
        text = " ".join(lines[at + 1:at + 4])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        rows[(m.group(1), dtype, int(m.group(2)), int(m.group(3)))] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_bytes": int(spill.group(1)) if spill else None}
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args()
    edit = V.swap("tri::dispatch_tile(", "tri::dispatch_fwd_tile(", 2)
    csrc = V.patched(BUILD.CSRC, "bwd_d192_ptxas", "d192",
                     {f"{s}.cu": [edit] for s in SOURCES})
    jobs = {s: (csrc, s, csrc / "out") for s in SOURCES}
    libs = V.build(BUILD, jobs)
    rows = {}
    for s in SOURCES:
        rows.update({(s,) + k: v for k, v in _report(libs[s][1]).items()})
    qb, d = 64, 192
    tile = qb * d * 2
    dkv = (2 + 2 * 3) * tile + 3 * 2 * qb * 4 + 2 * qb * qb * 4 + 8 * 7 \
        + 1024
    dq = (2 + 2 * 2) * tile + 8 * 3 + 1024
    print(f"card-free ptxas report ({BUILD._nvcc()}); BwdShape at D 192: "
          f"DKV_BYTES {dkv}, DQ_BYTES {dq}, limit {232448}")
    for key in sorted(k for k in rows if k[4] == 192):
        src, kern, dtype, blk, _ = key
        base = rows.get((src, kern, dtype, blk, 128), {})
        r = rows[key]
        print(f"{src} {kern} {dtype} BLK {blk}: D 192 {r['registers']} "
              f"registers, {r['spill_bytes']} B spills (D 128: "
              f"{base.get('registers')}, {base.get('spill_bytes')} B)")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"dkv_bytes": dkv, "dq_bytes": dq, "rows": [
                dict(zip(("source", "kernel", "dtype", "blk", "d"), k), **v)
                for k, v in sorted(rows.items())]}, indent=1))


if __name__ == "__main__":
    main()
