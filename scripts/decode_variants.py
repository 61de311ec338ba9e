"""Time candidate geometries of the port's decode body on one card.

    python3 scripts/decode_variants.py [--out FILE]

``packed_decode_fwd`` (src/repro_torch/csrc/packed_decode.cu on
attn_decode.cuh) cuts each member's cache walk into chunks of
DECODE_CHUNK = 128 tokens, holds a chunk's tiles in a ring of as many
stages as it has tiles, filled by cp.async from every thread, and runs
256 threads a block. This script builds copies of the checkout's sources
under ``build/decode_variants/`` with chunks of 256 tokens (3 stages: as
many 64-token f32 tiles as shared memory holds; and capped at 2), with
128 threads a block, with the PV's head groups capped at 4 and with the
ring filled by one cp.async.bulk a token row from one warp, and times
each against the tree's build in turns, through the C entry point (no
wrapper) with CUDA events and on the device (profiler), with L2 cold:
the launches rotate over 8 cache pairs (268 MB against the 50 MB L2).
Shapes: chip_smoke.py's kernel phase (4 slots, kv_len 2000/37/900/300)
and a serving profile round (902/42/602/202), both over a 2048-token f32
cache, bf16 q, H 32, Hkv 4, D 128, blk 64. Every candidate is held
against the plain version at chip_smoke.py's OUT_TOL; candidates with the
tree's chunks must give its bits, and the two 256-token builds each
other's. A diagnostic build whose chunks all write their own acc / l (no
partials, counters or merge; wrong for a split member, so not held to the
plain version) shows what the merge costs.

Prints one JSON object (and writes it to --out). Needs a CUDA card and
nvcc; exits 1 without them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import _variants as V

ROOT = V.ROOT

CHUNK = "constexpr int DECODE_CHUNK = 128;"
STAGES = "static constexpr int STAGES = CT < FIT ? CT : FIT;"
THREADS = "constexpr int NT = 256;"
GROUPS = "constexpr int NHG = NT / NC;"
COLUMN = "const int cc = tid % NC, hg = tid / NC;"
DIRECT = "    if (nc == 1) {"
LOADER = ("template <typename TC, int BLK, int D, int NT>\n"
          "__device__ __forceinline__ void decode_issue(",
          "// 16 bytes of cache elements at p as f32.")
# the loader as first built: warp 0 issues one cp.async.bulk a token row,
# completing on the stage's mbarrier (one arrival, expect_tx)
BULK_ROWS = r"""template <typename TC, int BLK, int D, int NT>
__device__ __forceinline__ void decode_issue(TC* stage, uint64_t* bar,
                                             const TC* ks, const TC* vs,
                                             int tok0, size_t tok_stride) {
  using Sh = DecodeShape<TC, BLK, D>;
  constexpr uint32_t ROW = D * sizeof(TC);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  if (lane == 0) tc::mbar_expect(bar, 2 * BLK * ROW);
  __syncwarp();
  for (int e = lane; e < 2 * BLK; e += 32) {
    const int row = e < BLK ? e : e - BLK;
    const TC* src = (e < BLK ? ks : vs) +
                    static_cast<size_t>(tok0 + row) * tok_stride;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(tc::smem_u32(stage + e * Sh::DP)),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(ROW),
        "r"(tc::smem_u32(bar))
        : "memory");
  }
}

template <int NT>
__device__ __forceinline__ void decode_bar_init(uint64_t* bar) {
  tc::mbar_init(bar);
}

"""


# name -> (chunk tokens, {file: [edit]})
VARIANTS = {
    "chunk 256, 3 stages": (256, {"attn_decode.cuh": [
        V.swap(CHUNK, "constexpr int DECODE_CHUNK = 256;")]}),
    "chunk 256, 2 stages": (256, {"attn_decode.cuh": [
        V.swap(CHUNK, "constexpr int DECODE_CHUNK = 256;"),
        V.swap(STAGES, "static constexpr int STAGES = "
                      "(CT < FIT ? CT : FIT) < 2 ? (CT < FIT ? CT : FIT) : 2;")]}),
    "chunk 128, 128 threads": (128, {"packed_decode.cu": [
        V.swap(THREADS, "constexpr int NT = 128;")]}),
    # PV: 4 head groups of 2 heads, so each V row is read from shared
    # memory 4 times a tile, not 8; the other threads idle in PV
    "chunk 128, PV in 4 head groups": (128, {"attn_decode.cuh": [
        V.swap(GROUPS, "constexpr int NHG = NT / NC < 4 ? NT / NC : 4;"),
        V.swap(COLUMN, "const int cc = tid % NC, hg = tid / NC < NHG ? "
                      "tid / NC : DECODE_HEADS;")]}),
    "chunk 128, cp.async.bulk a row": (128, {"attn_decode.cuh": [
        V.between(*LOADER, BULK_ROWS)]}),
}
# diagnostics, timed but not held to the plain version: every chunk writes
# its own acc / l, no partials, no counter and no merge (a split member's
# output is then its last chunk's), to show what the merge costs
DIAGNOSTICS = {
    "diagnostic: no merge": (128, {"attn_decode.cuh": [
        V.swap(DIRECT, "    if (true) {")]}),
}
SHAPES = {"kernel phase": [2000, 37, 900, 300],
          "serving round": [902, 42, 602, 202]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_variants: torch.cuda.is_available() is False")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.kernels.tri_attn import scan_impl as SC

    card = V.card()
    BUILD.build_all()
    libs = {"tree: chunk 128, 256 threads": BUILD.load("packed_decode")}
    chunks = {"tree: chunk 128, 256 threads": K.DECODE_CHUNK}
    every = {**VARIANTS, **DIAGNOSTICS}
    dirs = {name: V.patched(BUILD.CSRC, "decode_variants", name, edits)
            for name, (_, edits) in every.items()}
    libs.update({name: lib for name, (lib, _) in V.build(BUILD, {
        name: (csrc, "packed_decode", csrc)
        for name, csrc in dirs.items()}).items()})
    chunks.update({name: ch for name, (ch, _) in every.items()})
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    h, hkv, d, blk, b, s_cache = 32, 4, 128, 64, 4, 2048
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream

    def rand(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(dtype)

    qd = rand(b, h, d, dtype=torch.bfloat16)
    caches = [(rand(b, s_cache, hkv, d), rand(b, s_cache, hkv, d))
              for _ in range(CS.DECODE_PAIRS)]
    arrivals = {name: torch.zeros(4096, dtype=torch.int32, device=dev)
                for name in libs}
    report = {"card": card, "shapes": {}}
    for label, kv_lens in SHAPES.items():
        tbl_np, needed = OPS.make_decode_table(
            kv_lens, list(range(b)), blk=blk, n_members=b + 1, n_slots=b,
            s_cache=s_cache)
        tbl = torch.as_tensor(tbl_np, device=dev)
        out = torch.empty((b + 1, h, d), dtype=torch.bfloat16, device=dev)
        ws = {name: torch.empty((b + 1) * -(-s_cache // ch) * h * (d + 2),
                                dtype=torch.float32, device=dev)
              for name, ch in chunks.items()}
        turn = [0]

        def launch(name, pair=None):
            if pair is None:
                turn[0] += 1
                pair = caches[turn[0] % len(caches)]
            kc, vc = pair
            err = libs[name].packed_decode_launch(
                qd.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                tbl.data_ptr(), ws[name].data_ptr(),
                arrivals[name].data_ptr(), b + 1, needed, b, h, hkv, s_cache,
                d, blk, scale, 1, 0, stream)
            if err:
                sys.exit(f"decode_variants: {name}: cudaError {err}")
            return out

        want = SC.packed_decode_torch(qd, *caches[0], tbl, capacity=needed,
                                      blk=blk, tiles=needed, scale=scale)
        outs = {}
        for name in libs:
            got = launch(name, caches[0])[:b].clone()
            torch.cuda.synchronize()
            if name not in DIAGNOSTICS:
                CS._close(f"{name} at the {label} shape", got, want)
                outs[name] = got
        names = list(outs)
        for a in names:
            for c in names:
                if chunks[a] == chunks[c] and not torch.equal(outs[a],
                                                              outs[c]):
                    sys.exit(f"decode_variants: {a} and {c} differ at the "
                             f"{label} shape")
        turns = CS._in_turns({name: (lambda name=name: launch(name))
                              for name in libs}, 48, rounds=3)
        rows = {}
        for name in libs:
            dev_ms = CS._device_ms(lambda: [launch(name) for _ in range(24)],
                                   24, "packed_decode")
            rows[name] = {"ms": turns[name][0], "ms_turns": turns[name][1],
                          "device_ms": dev_ms,
                          "grid": K.decode_grid(needed, b + 1, blk, hkv,
                                                h // hkv) if chunks[name] ==
                          K.DECODE_CHUNK else None}
        report["shapes"][label] = {"kv_lens": kv_lens, "by_variant": rows}
        print(f"decode_variants: at the {label} shape (kv_lens {kv_lens}), "
              f"L2 cold: " + "; ".join(
                  f"{name} {r['ms']:.4f} ms (turns {r['ms_turns']}), device "
                  f"{r['device_ms']:.4f}" for name, r in rows.items())
              + f"; card {card}", flush=True)
    text = json.dumps(report)
    print(text)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
