"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--train-layers N]

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the eleven CUDA sources of src/repro_torch/csrc (nvcc, sm_90a);
     print ptxas's registers and spills of the bf16 instantiations of the
     attention tile bodies (the tensor-core kernels of tri_fwd.cu,
     fwd_bb.cu, packed_fwd.cu, tri_bwd.cu and packed_bwd.cu, fused_step.cu's
     bf16-q kernels, the CUDA-core kernels of tri_bwd.cu and packed_bwd.cu)
     and the HGMMA / HMMA instructions cuobjdump finds in each (every one
     of those kernels must be found, and each must hold the instruction of
     the body kernel.tile_body names for its direction, HGMMA at BLK 64
     and 128, HMMA in the forward at 16 and 32, neither in the backward at
     16 and 32, and no other; no tensor-core instantiation may spill);
     and of all 80 instantiations of packed_decode.cu's kernel (the decode
     body of attn_decode.cuh, f32 FMAs: no spill, no HGMMA or HMMA); and
     of all 16 of wkv_scan.cu's (the chunked kernel and the one-chunk
     walk, dtype x hd) and 8 of ssm_scan.cu's (no spill);
  2b. the port's checker on the card: ``repro_torch.analysis.lint`` with
     every pass on cuda, in a process of its own (its profiler windows
     would leave this process's launches slower; see
     scripts/profiler_overhead.py): the envelopes derived for the port's
     arithmetic, the tensor maps at every seam on the card and the device
     maps of csrc/packing.cuh through member_map_device; every schedule
     kind's contract with its tensor index_map on the card; every public
     op of the 17 kernel sites called once on the kernels (float32 at blk
     16, bf16 at blk 64), its launches held to declared literals, no plain
     launch; in a torch.profiler window around each op, the csrc kernels
     the profiler sees equal to the rise in launches_total; the
     resilience rules and faulted runs on the kernels. Then
     ``repro_torch.resilience.smoke`` (3 random plans and
     the fleet tier, the engines on the kernels at prefill_block 16), then
     ``repro_torch.obs.validate`` over the metrics documents and traces
     those runs wrote (under build/checker_artifacts/); prints the
     {"checker": ...} line of per-pass checks and failures and the
     phase's seconds;
  3. kernels: each kernel of the serving path at full yi-9b width (H=32,
     Hkv=4, D=128, blk=64, bf16 q/k/v, f32 decode cache) against its
     plain PyTorch version on the card (outputs within atol 4e-3 + rtol
     1e-2, log-sum-exp within atol 1e-2), timed with CUDA events beside
     the plain version, one library call (scaled_dot_product_attention
     with the equivalent mask; used nowhere in the port; packed_fwd in
     turns with it, and on the device through the profiler, its two runs
     bitwise equal; packed_decode_fwd likewise, in turns with SDPA and on
     the device with L2 cold, the launches rotated over DECODE_PAIRS cache
     pairs, as a serving round's 48 layers find it, and its share of the
     bound) and the bound max(bytes / 3.35 TB/s, flops / peak), both
     counted from what this run's masks and kv lengths need; the fused
     step against the split kernels on the same round (both halves
     bitwise equal to them) at its block's thread count;
  4. serving: yi-9b at full width (48 layers unless --layers cuts it) with
     random seeded bf16 weights, an Engine with both kernels serving 8
     skewed requests; asserts every request done, no degrade, no failure,
     and kernel launches == layers x engine launches; a torch.profiler
     window over a few more decode rounds (device busy share, top
     kernels); then a smoke-size float32 engine with the kernels and with
     the plain versions, which must emit identical greedy tokens; the
     serving CLI (launch/serve.py) at smoke size in both step modes on
     its default decode mode (auto), and in split mode with
     --decode-mode packed, whose rounds must launch packed_decode_fwd;
  4b. the decode auto-mode, the engine's default, on the serving weights
     (48 layers unless --layers cuts them): the reference's skew harness
     (benchmarks/bench_packed.py run_decode: slot 0 at 2048 tokens, the
     other three at 2048 / K, K = 1, 4, 16, blk 64), each mode forced on
     one engine round over a random cache, in turns: the medians of 7
     rounds' host wall time and CUDA events, the seconds a tile of each,
     the measured ratio, the mode the rule picks at
     PACKED_TILE_COST_RATIO and the faster one, both modes' logits
     compared; one attention layer in each mode's function
     (layers.packed_decode_attention, layers.decode_attention) on the
     device, every kernel of each call summed, beside row 2's kernel
     alone (the kernel held to its plain version, the two layers to each
     other); then with the defaults the split traffic above on a plain
     engine (tokens/s), and on packed and auto probe engines that keep
     each token's logits (tokens equal to the packed engine's; a stream
     that differs must differ first where both engines' logits agree
     within the bf16 policy, and in float32 only at a near-tie of the
     packed engine's top two logits within OUT_TOL), a uniform batch
     (every round lockstep, so no hand-written decode kernel: no
     packed_decode_kernel in a profiler window and no launch in
     launches_total) and a straggler batch (packed rounds, each one
     packed_decode_fwd launch a layer, the profiler's
     count within them); the phase's seconds;
  4c. the nine examples/torch_*.py, each main() on the card with its own
     assertions, each timed; every tri_attn kernel but the fused step and
     fwd_bb launched by them;
  5. training kernels: tri_attn.fwd and its dq and dk/dv backward at the
     train phase's attention shape (B 1, H 32, Hkv 4, S 4096, D 128, ltm,
     blk 64, bf16) against their plain versions on the same inputs
     (OUT_TOL, lse LSE_TOL, the bf16 wgmma backward's grads
     BF16_GRAD_TOL), each backward run twice and bitwise equal,
     timed beside the plain versions, SDPA (is_causal forward, in turns
     with tri_fwd; its autograd backward in turns with dq and dk/dv, its
     own grads' largest error against the same plain versions reported)
     and the bound; tri_fwd also at
     jamba-1.5-large's attention shape (B 4, H 64, Hkv 8, S 2048, D 128)
     against its plain version and SDPA, and at training sequences 64
     does not divide (S 4064 at blk 32, 4080 at blk 16: the mma.sync
     body) against SDPA, each timed in turns with SDPA; band, prefix and
     a 3-token band at blk 16, 32, 64 and 128 on small shapes (every bf16
     body), each forward and backward run twice, bitwise equal and
     finite;
  6. packed training kernels: packed_fwd and the packed dq and dk/dv
     (tri_attn.packed_bwd) at the packed train phase's attention shape
     (one row of the 8 documents 1500/1000/600/370/250/100/60/40 padded
     to blk 64 multiples, 4096 rows, ltm members; H 32, Hkv 4, D 128,
     bf16) against their plain versions (the bf16 wgmma backward's grads
     at BF16_GRAD_TOL), timed beside them, SDPA with the block-diagonal
     causal mask (its forward in turns with packed_fwd; its autograd
     backward in turns with dq and dk/dv, its own grads' error against the
     plain versions reported), the kernels' device time and the bound; mixed ltm/prefix/band/3-token band members at blk 16, 64
     and 128; two runs of the backward bitwise equal;
  7. the paper's experiment: dummy_ltm over the whole certified ltm_map
     envelope (n = 23169, 268,412,865 blocks) equal to i + j on the card;
     edm_ltm and edm_bb against their plain versions (EDM tolerances of
     tests/oracles.py) in full at N = 16384 (d 1-4, squared, bf16) and at
     N = 65536 on 4096 sampled tiles plus every tile past the 2^31-element
     offset, BB's lower tiles equal to LTM's bit for bit, its upper tiles
     and every self-distance exactly 0; fwd_bb at the train phase's
     attention shape against fwd_bb_torch and tri_fwd (OUT_TOL, LSE_TOL),
     two runs bitwise equal, its counters n^2 and tri(n) per (batch,
     head), band and 3-token band windows at blk 16, 32, 64 and 128 (two
     runs bitwise equal, finite); the plain versions and torch.cdist
     timed, fwd_bb, tri_fwd and SDPA in turns; then the experiment
     through the entry points with every count at 0 before and asserted
     after (no plain version): ops.edm cuda and bb over N 16384/32768/65536 x d 1-4 at
     blk 64 and N 65536, d 3 at blk 128 (I_edm = t_bb / t_ltm beside the
     structural n^2 / tri(n) of kernel_summary and the paper's Kepler
     1.12-1.15), dummy_ltm at n = 1024, 4096 and 23169, and
     triangular_attention bb against cuda (I_attn, and I_attn less the
     partials' round trip at 3.35 TB/s); beside dummy_ltm, empty one-warp
     blocks on its grid (tri_edm.cu's empty_blocks_launch, a yardstick
     no path of the port runs): the card's block dispatch, its bound;
  7b. the 3-body workload on the tetrahedron: dummy_tet over the whole
     certified tet_map envelope (n = 1624, 715,169,000 blocks) equal to
     i + j + k (int64 closed form on the card); three_body_tet and
     three_body_bb3 against their plain versions for every tile at
     N 8192/16384 x d 3/64 at blk 128 and N 8192, d 3 at blk 64, and
     strict at N 16384, d 3 (each tile within 2 (b + d) float32 units of
     its sum|(A B) * C|), bb3's simplex cells equal to tet's bit for bit
     and every other cell exactly 0, two runs bitwise equal; the plain
     versions and the library einsum timed; then the workload through
     ops.three_body / three_body_total and dummy_tet with every count at
     0 before and asserted after (I_3body = t_bb3 / t_tet beside
     n^3 / tet(n), ns a dummy_tet block, the block dispatch of its grid
     by empty blocks); then a prefix past its sequence
     (dense and packed) through tri_fwd/tri_bwd and packed_fwd/packed_bwd,
     forward and grads, against the plain versions and the oracle;
  7c. rwkv6: wkv_scan.wkv at full rwkv6-1.6b width (B 4, L 2048, H 32,
     hd 64, f32) against its plain version (within 1e-4 of its scale),
     two runs bitwise equal with every chain counter back at 0, two
     halves chained equal to the whole, an L = 1 step whose state
     aliases its cache (s0 = s_L), bf16 inputs; timed beside the plain
     version (no library call computes WKV6) and the byte bound, and on
     the device with L2 cold (its inputs stream through L2); then
     rwkv6-1.6b at its published widths (all 24 layers, random seeded
     bf16 weights): make_prefill_step on 4 x 2048 tokens and generate 32
     tokens, with exactly 24 wkv launches a prefill and a token and no
     plain version, and prefill of 2047 tokens + one decode step equal to
     the forward's last logits (2e-2); the engine (4 slots, 8 requests of
     16-128 prompt tokens, 16 new each): every request done, launches =
     24 x (admission steps + lockstep rounds), each request's first-token
     logits within 2e-2 of a batch-1 prefill + serve step; a smoke-size
     float32 engine (2 slots, 8 requests, a 1-token prompt) emitting
     batch-1 generate's tokens on the card; the serving CLI with --arch
     rwkv6-1.6b;
  7d. jamba: ssm_scan.selective_scan at the model's prefill shape (B 4,
     L 2048, D 16384, N 16) against its plain version (within 1e-4 of its
     scale) in f32 and with bf16 inputs (5e-2), at the reference test's
     shapes, two runs bitwise equal, two halves chained equal to the
     whole, an L = 1 step at B 4 whose state aliases its cache; timed
     beside the plain version (no library call computes a selective
     scan) and the bound (bytes against the exponentials on the SFUs),
     and on the device with L2 cold; then jamba-1.5-large-398b at its
     published widths cut to one superlayer (7 Mamba + 1 attention
     layers) and 4 of 16 experts, random seeded bf16 weights (32.26 GB):
     make_prefill_step on 4 x 2048 tokens with exactly 7 ssm launches and
     1 tri_attn.fwd and no plain version, generate 32 tokens with 7 a
     token, prefill of 2047 + one decode step equal to the forward's last
     logits (the bf16 policy), the engine (4 slots, 8 requests of 16-128
     prompt tokens, 16 new each): every request done, launches = 7 x
     (admission steps + lockstep rounds), each slot's state after its
     admission equal to a batch-1 decode of the prompt bit for bit (the
     first-token logits against it reported); profiler windows over the
     prefill and 4 tokens; a smoke-size float32 engine on the kernels
     emitting the plain versions' tokens; the serving CLI with --arch
     jamba-1.5-large-398b;
  7e. the other architectures of the registry, random seeded bf16
     weights, depth cut with dataclasses.replace where the card's memory
     asks: granite-moe-3b-a800m at its published widths and all 32 layers
     (40 experts top-8, g 3, head dim 64) served at the serving phase's
     settings (4 slots x 2048, blk 64, f32 cache, 8 skewed prompts of
     60-1000 tokens), split (32 new each) then fused (staggered budgets):
     every request done, launches = 32 x the engine's, no plain version,
     each request's first-token logits within the bf16 policy of a
     batch-1 prefill through the attention oracle (impl ref) whose MoE
     layers route every position to the experts the engine routed it to
     (a top-k router's near-ties break either way under bf16 rounding);
     a profiler window over 4 decode rounds and the host syncs a round by
     source file; the same first tokens in float32 at full width
     (RWKV_F32_TOL); mixtral-8x7b cut to 8 of 32 layers (slots of 4096
     rolling rows, max_len 4608): a 4500-token prompt past the window
     (band members in its admission prefill) and three of 60-500 tokens,
     64 new each, the long request's logits at its first 45 steps against
     the plain versions' forward over the same 4544 tokens routed as the
     engine routed them (the bf16 policy; in float32, 47.5 GB,
     RWKV_F32_TOL); granite-34b cut to 4 of 88 layers (g 48) and
     llama3-405b to 2 of 126 (g 16): engines of 2 slots, 4 requests of
     16-256 tokens, 16 new, first-token logits as above; musicgen-large (48 layers, audio
     frames, seq 2048) and internvl2-1b (24 layers, 256 vision patches,
     seq 4096) at full width and depth: 2 training steps of batch 1 with
     2 x layers tri_attn.fwd and layers dq and dk/dv launches a step, then
     a smoke-size float32 step each on the kernels against the plain
     versions (rtol 1e-5); nemotron-4-340b (head dim 192, g 12): rows
     1-9 of the kernel table at its attention shape (H 96, Hkv 8, D 192,
     bf16, blk 64; the kernel phase's serving members, one layer at seq
     2048 for tri_fwd and fwd_bb, bwd dq and dk/dv at seq 2048 and
     packed_bwd dq and dk/dv on one 2048-row row of 8 documents, each
     backward twice bitwise, in turns with SDPA's backward, its device
     time) against their plain versions, in turns with SDPA, beside their
     bounds, then its published widths cut to 4 of 96 layers (46.51 GB)
     served as granite-34b is, split and fused (staggered budgets),
     launches = 4 x the engine's, a profiler window over 4 decode rounds
     and the host syncs a round, a make_prefill_step batch through
     tri_fwd against the oracle; then cut to 1 of 96 layers (12.89 B
     parameters, bf16, remat, Adafactor, microbatches 1) and trained 3
     dense steps on one 2048-token row and 3 packed steps on one row of
     8 documents: launches of exactly 2 (fwd or packed_fwd) and 1 (dq,
     dk/dv) a layer a step, the first step's loss and attention weights'
     grads within the bf16 policy of the same step through the oracle
     attention, losses finite and falling, step times, real tokens/s and
     peak memory, and the first step's chunked Adafactor update of wo
     against a whole-leaf float32 one on the card; each new arch's smoke
     config, and nemotron's at head dim 192, as a float32 engine on the
     kernels emitting the plain versions' tokens; the serving CLI with --arch
     granite-moe-3b-a800m; a {"other_archs": ...} line;
  8. training: yi-9b at full width (24 of 48 layers unless --train-layers
     says otherwise: the 48-layer AdamW state does not fit 80 GB) for 3
     steps of seq 4096, batch 1, remat, random seeded bf16 weights,
     SyntheticLM batches; asserts finite positive losses, kernel launches
     of exactly 2 x layers (fwd, with the remat recompute) and layers (dq,
     dk/dv) a step, and no plain-version launch; a profiler window over a
     fourth step; then, on the same state, packed document training:
     3 steps of PackedDocsLM rows of the 8 documents (3920 real tokens a
     step) with launches of exactly 2 x layers (packed_fwd) and layers
     (packed dq, dk/dv) a step, no other kernel and no plain version; a
     profiler window over a fourth; one forward+backward of the packed
     row and of the pad-to-max batch (8 x 1536, through tri_fwd/tri_bwd)
     on the same parameters, whose losses agree within PAD_LOSS_RTOL;
     then smoke-size float32 training on the card: 3 steps with the
     kernels and with the plain versions agree, 20 steps lower the loss,
     6 steps straight and 3 + checkpoint + restore + 3 end in
     bitwise-equal states; 3 packed steps with the kernels and with the
     plain versions agree, and packed and padded losses agree (rtol
     1e-5);
  8b. data-parallel training with the int8 error-feedback grad all-reduce
     (parallel/compression.py) over an NCCL group of one rank
     (launch/mesh.init_data_group): the dry-run's reckoning of yi-9b at
     full width cut to COMPRESSED_LAYERS (16) of 48 layers (seq 4096,
     batch 1, remat, AdamW, err_state) printed first, failing past
     COMPRESSED_FIT_BYTES; 3 plain then 3 compressed steps on one state
     with launches of exactly 2 x layers (fwd) and layers (dq, dk/dv) a
     step in both modes and no plain version; on the first compressed
     step the codes of one stacked attention and one MLP leaf (each
     dequantized grad q x max|g + err| / 127 over the stack, bitwise, |new err| <= scale / 2, dequant +
     new err == g + err within an ulp); finite losses, a nonzero
     err_state, the compressed steps' peak within PEAK_RTOL of the
     reckoning; median step times of both modes and the codec's ms a
     step (CUDA events around the hook); smoke-size float32: compressed
     steps on the kernels and the plain versions agree, the one-rank
     group and no group bitwise equal, 3 + save_async + restore + 3 == 6
     straight bitwise (err_state included); the trainer CLI with
     --compress-grads; the phase's seconds;
  9. the roofline: yi-9b's dense step of phase 8 in a fresh process
     (python -m repro_torch.roofline.attribution): its step times, MFU
     and max_memory_allocated over ROOFLINE_STEPS steps, the dry-run's
     count of the same cut cell on meta (its peak within PEAK_RTOL of the
     measured, its roofline terms and mfu_at_bound), and one profiler
     window over one more step attributed by region (each compat region,
     GEMMs, PyTorch's elementwise kernels by module and aten op, other),
     the window's region launches held to the wrappers' counts; nemotron's
     1-of-96 dense step of phase 7e reckoned the same way against the
     peak and step times it read (its check tensors named and added),
     and the attribution of the window phase 7e took over a fourth step
     in the smoke's own process; the dry-run's tri_3body cell at the
     reference's defaults and rows 13-14's bounds through
     roofline/model.py.
The last lines are the {"kernels": [...]} line (rows 1-9 carry their
nemotron D 192 readings under "at_d192"), the card line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    # the card's peaks and every bound below (H100 SXM5 80GB, 700 W)
    from repro_torch.roofline import model as RF
except ImportError:  # main() fails: the package is not beside the script
    RF = None
# bf16 outputs of ~0.05-1 differ by at most a bf16 ulp; a skipped 64-key
# tile moves out by ~1e-2 and lse by ~6e-2, so both limits catch it
OUT_TOL = dict(atol=4e-3, rtol=1e-2)
LSE_TOL = dict(atol=1e-2, rtol=0.0)
# grads of the bf16 wgmma backward (tri_bwd.cu, blk 64 and 128): P and dS
# enter its dV, dK and dQ products in bf16, as in FlashAttention's and
# SDPA's backward, ~2^-9 relative a term; where a grad's terms cancel
# (few live keys, large P and dS) that leaves it a few bf16 steps off the
# f32 plain version (tests/test_torch_tri_bwd_numerics.py: 0.0039 without
# the rounding, 0.031 with it). The bf16 grad tolerance of the card tests
# (GRAD_TOL, tests/test_torch_cuda.py); the CUDA-core bodies keep OUT_TOL
BF16_GRAD_TOL = dict(atol=2e-2, rtol=2e-2)
# the packed train phase's documents (real tokens), padded to blk 64
TRAIN_DOCS = (1500, 1000, 600, 370, 250, 100, 60, 40)
# bf16 packed and pad-to-max losses round at other places (other matmul
# shapes, other tile edges): each token's logits move by ~1e-2, their
# mean cross entropy over 3920 tokens by far less than 0.5%
PAD_LOSS_RTOL = 5e-3
# cache pairs packed_decode_fwd's L2-cold timing rotates over (8 x 33.5 MB)
DECODE_PAIRS = 8


def _fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _reset_launches(K):
    """Every kernel wrapper's launch count to 0, just before a path."""
    for fn in K.WRAPPERS.values():
        fn.launches = 0


def _launches(K) -> dict:
    return {name: fn.launches for name, fn in K.WRAPPERS.items()}


def _close(name, got, want, tol=OUT_TOL):
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        _fail(f"{name}: kernel disagrees with its reference "
              f"(max abs err {err}, tolerance {tol})")
    return err


# the tensor-core kernels of tri_fwd.cu / fwd_bb.cu / packed_fwd.cu /
# fused_step.cu (its bf16-q instantiations, whose prefill half runs the
# forward body) / tri_bwd.cu / packed_bwd.cu and the CUDA-core kernels of
# tri_bwd.cu and packed_bwd.cu: the source of each and the direction of its
# tile body (kernel.tile_body's op)
BODY_DIR = {"tri_fwd_tc_kernel": ("tri_fwd", "fwd"),
            "fwd_bb_tc_kernel": ("fwd_bb", "fwd"),
            "packed_fwd_tc_kernel": ("packed_fwd", "fwd"),
            "fused_step_kernel": ("fused_step", "fwd"),
            "tri_bwd_dq_tc_kernel": ("tri_bwd", "bwd"),
            "tri_bwd_dkv_tc_kernel": ("tri_bwd", "bwd"),
            "tri_bwd_dq_kernel": ("tri_bwd", "bwd"),
            "tri_bwd_dkv_kernel": ("tri_bwd", "bwd"),
            "packed_bwd_dq_tc_kernel": ("packed_bwd", "bwd"),
            "packed_bwd_dkv_tc_kernel": ("packed_bwd", "bwd"),
            "packed_bwd_dq_kernel": ("packed_bwd", "bwd"),
            "packed_bwd_dkv_kernel": ("packed_bwd", "bwd")}
# their bf16 instantiations in mangled names: (kernel, BLK, D) of
# <BLK, D> (the tensor-core kernels) or <__nv_bfloat16, BLK, D>, and the
# fused kernel's <__nv_bfloat16, cache type, BLK, D> (float "f", or bf16
# again, a substitution "S<n>_"), keyed "fused_step_kernel f32 cache" /
# "... bf16 cache"
KERNEL_KEY = re.compile(rf"({'|'.join(BODY_DIR)})I(?:13__nv_bfloat16)?"
                        r"Li(\d+)ELi(\d+)E")
FUSED_KEY = re.compile(r"fused_step_kernelI13__nv_bfloat16(f|S\d*_)"
                       r"Li(\d+)ELi(\d+)E")


def _kernel_key(line: str):
    m = KERNEL_KEY.search(line)
    if m is not None:
        return (m.group(1), int(m.group(2)), int(m.group(3)))
    m = FUSED_KEY.search(line)
    if m is not None:
        cache = "f32" if m.group(1) == "f" else "bf16"
        return (f"fused_step_kernel {cache} cache", int(m.group(2)),
                int(m.group(3)))
    return None


def _in_turns(fns: dict, reps: int, rounds: int = 2) -> dict:
    """CUDA-event medians of each fn, timed in turns (a, b, a, b, ...) in
    this call: name -> (median of the rounds, the rounds)."""
    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(_median_ms(fn, reps))
    return {name: (statistics.median(r), r) for name, r in runs.items()}


# the SASS instruction of each tensor-core tile body (kernel.tile_body);
# the CUDA-core body (fma_f32) holds neither
BODY_OP = {"wgmma": "HGMMA", "mma.sync": "HMMA"}


def tensor_core_build(BUILD, K) -> dict:
    """What ptxas said of the bf16 instantiations of the attention tile
    bodies (registers, spills) and how many HGMMA (wgmma) and HMMA
    (mma.sync) instructions cuobjdump finds in each: the tensor-core
    kernels of tri_fwd.cu, fwd_bb.cu, packed_fwd.cu, tri_bwd.cu and
    packed_bwd.cu, fused_step.cu's bf16-q kernels and the bf16 CUDA-core
    kernels of tri_bwd.cu and packed_bwd.cu. Every kernel of BODY_DIR must
    be found, and each instantiation must hold the instruction of the body
    K.tile_body names for its BLK and direction and no other (a CUDA-core
    body neither), so the label the wrappers report is the compiled
    dispatch; no tensor-core instantiation may spill. Returns {(kernel,
    BLK, D): {"registers": r, "HGMMA": n, ...}}."""
    info, said = {}, {}  # said: ptxas's lines on each instantiation
    for lib in sorted({lib for lib, _ in BODY_DIR.values()}):
        lines = (BUILD.build_dir() / f"{lib}.log").read_text().splitlines()
        for at, line in enumerate(lines):
            key = _kernel_key(line)
            if "Compiling entry" not in line or key is None:
                continue
            text = " ".join(lines[at + 1:at + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            info[key] = {"registers": int(regs.group(1)) if regs else None,
                         "spill_bytes": int(spill.group(1)) if spill else None}
            said[key] = text
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "--dump-sass",
                               str(BUILD.build_dir() / f"lib{lib}.so")],
                              capture_output=True, text=True, check=True).stdout
        key = None
        for line in sass.splitlines():
            if "Function :" in line:
                key = _kernel_key(line)
            elif key is not None:
                for op in ("HGMMA", "HMMA"):
                    if op + "." in line:
                        info[key][op] = info[key].get(op, 0) + 1
    missing = set(BODY_DIR) - {kern.split(" ")[0] for kern, _, _ in info}
    if missing:
        _fail(f"tensor cores: no bf16 instantiation of {sorted(missing)}")
    totals = {op: sum(r.get(op, 0) for r in info.values())
              for op in ("HGMMA", "HMMA")}
    print(f"tensor cores: {len(info)} bf16 instantiations of tri_fwd_tc_kernel,"
          f" fwd_bb_tc_kernel, packed_fwd_tc_kernel, fused_step_kernel (bf16 "
          f"q, f32 and bf16 cache), tri_bwd_dq/dkv_tc_kernel, "
          f"packed_bwd_dq/dkv_tc_kernel (BLK 64, 128) and tri_bwd_dq/dkv_kernel,"
          f" packed_bwd_dq/dkv_kernel (BLK 16, 32), SASS {totals['HGMMA']} "
          f"HGMMA and {totals['HMMA']} HMMA; ptxas: " + "; ".join(
              f"{k[0].replace('_kernel', '')} {k[1]}x{k[2]} {r['registers']} "
              f"regs {r['spill_bytes']} B spills {r.get('HGMMA', 0)} HGMMA "
              f"{r.get('HMMA', 0)} HMMA" for k, r in sorted(info.items())),
          flush=True)
    for (kern, blk, d), row in sorted(info.items()):
        body = K.tile_body(torch.bfloat16, blk,
                           BODY_DIR[kern.split(" ")[0]][1])
        op = BODY_OP.get(body)
        wrong = [o for o in BODY_OP.values() if o != op and row.get(o)]
        if (op is not None and not row.get(op)) or wrong:
            _fail(f"{kern} BLK {blk} D {d}: SASS holds {row.get('HGMMA', 0)} "
                  f"HGMMA and {row.get('HMMA', 0)} HMMA; tile_body names "
                  f"{body}")
        if op and row["spill_bytes"] != 0:
            _fail(f"{kern} BLK {blk} D {d}: ptxas reports "
                  f"{row['spill_bytes']} bytes of spill stores: "
                  f"{said[(kern, blk, d)]}")
    return info


# the decode kernels' instantiations: packed_decode_kernel<TQ, TC, BLK, D>
# (float "f" or bf16 "13__nv_bfloat16", a repeated bf16 a substitution)
DECODE_KEY = re.compile(r"packed_decode_kernelI(13__nv_bfloat16|f)"
                        r"(13__nv_bfloat16|f|S\d*_)Li(\d+)ELi(\d+)E")


def decode_build(BUILD) -> dict:
    """What ptxas said of every instantiation of packed_decode.cu's kernel
    (the decode body of attn_decode.cuh, which the fused kernels' decode
    half runs too: their bf16-q instantiations are in tensor_core_build's
    report), and the tensor-core instructions cuobjdump finds there. Fails
    unless all 80 (q x cache dtype x BLK x D, D 16-192) are found, none
    spills and none holds an HGMMA or HMMA: the decode body is f32 FMAs
    on the CUDA cores. Returns {(q, cache, BLK, D): {"registers": r, ...}}."""
    def key(line):
        m = DECODE_KEY.search(line)
        if m is None:
            return None
        q = "bf16" if m.group(1).startswith("13") else "f32"
        c = "f32" if m.group(2) == "f" else "bf16"
        return (q, c, int(m.group(3)), int(m.group(4)))

    info = {}
    lines = (BUILD.build_dir() / "packed_decode.log").read_text().splitlines()
    for at, line in enumerate(lines):
        k = key(line)
        if "Compiling entry" not in line or k is None:
            continue
        text = " ".join(lines[at + 1:at + 4])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        info[k] = {"registers": int(regs.group(1)) if regs else None,
                   "spill_bytes": int(spill.group(1)) if spill else None,
                   "ptxas": text}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(BUILD.build_dir() / "libpacked_decode.so")],
                          capture_output=True, text=True, check=True).stdout
    k = None
    for line in sass.splitlines():
        if "Function :" in line:
            k = key(line)
        elif k is not None and ("HGMMA." in line or "HMMA." in line):
            info[k]["tensor_core_ops"] = info[k].get("tensor_core_ops", 0) + 1
    if len(info) != 80:
        _fail(f"decode: {len(info)} instantiations of packed_decode_kernel "
              f"in ptxas's report, not 80")
    for k, row in sorted(info.items()):
        if row["spill_bytes"] != 0 or row.get("tensor_core_ops"):
            _fail(f"decode: packed_decode_kernel {k}: "
                  f"{row.get('tensor_core_ops', 0)} HGMMA/HMMA, ptxas: "
                  f"{row['ptxas']}")
    regs = [row["registers"] for row in info.values()]
    print(f"decode: 80 instantiations of packed_decode_kernel (q x cache "
          f"dtype x BLK x D), {min(regs)}-{max(regs)} registers, no spills, "
          f"no HGMMA or HMMA; bf16 q, f32 cache, 64 x 128: "
          f"{info[('bf16', 'f32', 64, 128)]['registers']} registers, 64 x "
          f"192: {info[('bf16', 'f32', 64, 192)]['registers']}", flush=True)
    return {k: {"registers": r["registers"], "spill_bytes": r["spill_bytes"]}
            for k, r in info.items()}


SCAN_KERNELS = ("wkv_kernel", "wkv_walk_kernel", "ssm_kernel")
SCAN_KEY = re.compile(rf"({'|'.join(SCAN_KERNELS)})I(13__nv_bfloat16|f)Li(\d+)E")


def scan_build(BUILD) -> dict:
    """What ptxas said of every instantiation of the recurrent scans'
    kernels (wkv_scan.cu: the chunked kernel and the one-chunk walk, each
    dtype x hd; ssm_scan.cu: dtype x N). Fails unless all 8 of each are
    found and none spills. Returns {(kernel, dtype, hd or N): {...}}."""
    info = {}
    for src in ("wkv_scan", "ssm_scan"):
        lines = (BUILD.build_dir() / f"{src}.log").read_text().splitlines()
        for at, line in enumerate(lines):
            m = SCAN_KEY.search(line)
            if "Compiling entry" not in line or m is None:
                continue
            text = " ".join(lines[at + 1:at + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            key = (m.group(1), "f32" if m.group(2) == "f" else "bf16",
                   int(m.group(3)))
            info[key] = {"registers": int(regs.group(1)) if regs else None,
                         "spill_bytes": int(spill.group(1)) if spill
                         else None, "ptxas": text}
    counts = {kern: sum(k[0] == kern for k in info) for kern in SCAN_KERNELS}
    if counts != dict.fromkeys(SCAN_KERNELS, 8):
        _fail(f"scans: instantiations in ptxas's report {counts}, not 8 "
              f"of each of {SCAN_KERNELS}")
    for k, row in sorted(info.items()):
        if row["spill_bytes"] != 0:
            _fail(f"scans: {k} spills: {row['ptxas']}")
    regs = {kern: [r["registers"] for k, r in info.items() if k[0] == kern]
            for kern in SCAN_KERNELS}
    print("scans: 8 instantiations each of " + ", ".join(
        f"{kern} {min(r)}-{max(r)} registers" for kern, r in regs.items())
        + f"; f32 wkv_kernel hd 64: "
        f"{info[('wkv_kernel', 'f32', 64)]['registers']}, wkv_walk_kernel "
        f"hd 64: {info[('wkv_walk_kernel', 'f32', 64)]['registers']}, "
        f"ssm_kernel N 16: {info[('ssm_kernel', 'f32', 16)]['registers']}; "
        f"no spills", flush=True)
    return {k: {"registers": r["registers"], "spill_bytes": r["spill_bytes"]}
            for k, r in info.items()}


def kernel_phase(dev, K, OPS, SC, h=32, hkv=4, d=128, tag="kernels"):
    """Both kernels at full yi-9b width (or another attention shape: H,
    Hkv, D) vs plain version and SDPA; ``tag`` starts each printed
    line."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    blk = 64
    dt = torch.bfloat16

    def rand(*shape, dtype=dt):
        return torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(dtype)

    # packed prefill: ltm ~1000, band ~500 (window 300), prefix ~250
    # (64-token bidirectional prefix), ltm ~90, padded to blk multiples
    lens = [1024, 512, 256, 128]
    psched = OPS.make_packed_sched(lens, block=blk,
                                   window=[None, 300, None, None],
                                   prefix=[0, 0, 64, 0])
    s = psched.s_total
    q, k, v = rand(1, h, s, d), rand(1, hkv, s, d), rand(1, hkv, s, d)
    out, lse = K.packed_fwd(q, k, v, psched)
    torch.cuda.synchronize()
    want_out, want_lse = SC.packed_fwd_torch(q, k, v, psched, d ** -0.5)
    err_fwd = max(_close("packed_fwd out", out, want_out),
                  _close("packed_fwd lse", lse, want_lse, LSE_TOL))
    mask = torch.zeros((s, s), dtype=torch.bool, device=dev)
    base = 0
    for m in psched.members:
        n_tok = m.n * blk
        seg = slice(base, base + n_tok)
        qp = torch.arange(n_tok, device=dev)[:, None]
        kp = torch.arange(n_tok, device=dev)[None, :]
        mm = kp <= qp
        if m.window is not None:
            mm &= (qp - kp) < m.window
        if m.prefix:
            mm |= kp < m.prefix
        mask[seg, seg] = mm
        base += n_tok
    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 enable_gqa=True)
    _close("packed_fwd vs SDPA", out, lib())
    again = K.packed_fwd(q, k, v, psched)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        _fail("packed_fwd: two runs on the same inputs differ")
    turns = _in_turns({"fwd": lambda: K.packed_fwd(q, k, v, psched),
                       "sdpa": lib}, 20)
    fwd_ms, fwd_lib = turns["fwd"][0], turns["sdpa"][0]
    fwd_device = _device_ms(lambda: [K.packed_fwd(q, k, v, psched)
                                     for _ in range(20)], 20, "packed_fwd")
    fwd_plain = _median_ms(
        lambda: SC.packed_fwd_torch(q, k, v, psched, d ** -0.5), 3, 1)
    # QK^T and PV: 2 * D multiply-adds per head for each unmasked pair
    pairs = int(mask.sum())
    fwd_bound, fwd_by = RF.attn_bounds(q, k, h * pairs)["fwd"]

    # decode round: 4 skewed slots over a 2048-token f32 cache
    b, s_cache = 4, 2048
    kv_lens = [2000, 37, 900, 300]
    tbl_np, needed = OPS.make_decode_table(kv_lens, list(range(b)), blk=blk,
                                           n_members=b + 1, n_slots=b,
                                           s_cache=s_cache)
    tbl = torch.as_tensor(tbl_np, device=dev)
    qd = rand(b, h, d)
    kc = rand(b, s_cache, hkv, d, dtype=torch.float32)
    vc = rand(b, s_cache, hkv, d, dtype=torch.float32)
    spec = OPS.DecodeRoundSpec(n_members=b + 1, capacity=needed, blk=blk,
                               impl="cuda", tiles=needed)
    got = OPS.packed_decode_attention(qd, kc, vc, tbl, spec)
    torch.cuda.synchronize()
    want = SC.packed_decode_torch(qd, kc, vc, tbl, capacity=needed, blk=blk,
                                  tiles=needed, scale=d ** -0.5)
    err_dec = _close("packed_decode", got, want)
    valid = torch.arange(s_cache, device=dev)[None, :] < torch.as_tensor(
        kv_lens, device=dev)[:, None]
    q32 = qd.float()[:, :, None]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    dec_lib = lambda: F.scaled_dot_product_attention(
        q32, kt, vt, attn_mask=valid[:, None, None], enable_gqa=True)
    _close("packed_decode vs SDPA", got, dec_lib()[:, :, 0])
    again = K.packed_decode_fwd(qd, kc, vc, tbl, capacity=needed, blk=blk,
                                tiles=needed)
    if not torch.equal(got, OPS.packed_decode_attention(qd, kc, vc, tbl,
                                                        spec)) or \
            not torch.equal(got, again[:b]):
        _fail("packed_decode: two runs on the same inputs differ")
    dec_ms = _median_ms(lambda: K.packed_decode_fwd(
        qd, kc, vc, tbl, capacity=needed, blk=blk, tiles=needed), 50)
    dec_plain = _median_ms(lambda: SC.packed_decode_torch(
        qd, kc, vc, tbl, capacity=needed, blk=blk, tiles=needed,
        scale=d ** -0.5), 3, 1)
    # L2 cold, as the 48 layers of a serving round find it: the launches
    # rotate over DECODE_PAIRS cache pairs of 33.5 MB, 268 MB against the
    # 50 MB L2, for the kernel and SDPA alike
    caches = [(kc, vc)] + [(rand(b, s_cache, hkv, d, dtype=torch.float32),
                            rand(b, s_cache, hkv, d, dtype=torch.float32))
                           for _ in range(DECODE_PAIRS - 1)]
    turn = [0]

    def next_pair():
        turn[0] += 1
        return caches[turn[0] % len(caches)]

    def dec_cold():
        kc_, vc_ = next_pair()
        return K.packed_decode_fwd(qd, kc_, vc_, tbl, capacity=needed,
                                   blk=blk, tiles=needed)

    def lib_cold():
        kc_, vc_ = next_pair()
        return F.scaled_dot_product_attention(
            q32, kc_.transpose(1, 2), vc_.transpose(1, 2),
            attn_mask=valid[:, None, None], enable_gqa=True)

    dec_turns = _in_turns({"decode": dec_cold, "sdpa": lib_cold}, 48)
    dec_lib_ms = dec_turns["sdpa"][0]
    dec_device = _device_ms(lambda: [dec_cold() for _ in range(24)], 24,
                            "packed_decode")
    dec_warm = _device_ms(lambda: [K.packed_decode_fwd(
        qd, kc, vc, tbl, capacity=needed, blk=blk, tiles=needed)
        for _ in range(24)], 24, "packed_decode")
    del caches
    # each slot reads its [kv_first, kv_len) rows of K and V once
    kv_tokens = int((tbl_np[3] - tbl_np[4]).sum())
    dec_bound, dec_by = RF.bound(*RF.decode_work(
        q_elems=qd.numel(), b=b, h=h, d=d, elt=qd.element_size(),
        tbl_elems=tbl.numel(), kv_tokens=kv_tokens, hkv=hkv,
        cache_elt=kc.element_size()), torch.float32)
    dec_grid = K.decode_grid(needed, b + 1, blk, hkv, h // hkv)
    dec_path = (f"fma_f32, chunks of {K.DECODE_CHUNK} tokens split over "
                f"the SMs, merged in the launch")
    print(f"{tag}: packed_decode_fwd at the kernel phase's shape "
          f"({dec_path}; grid {dec_grid}) {dec_ms:.4f} ms through the "
          f"wrapper, L2 cold in turns {dec_turns['decode'][1]}, on the "
          f"device L2 cold {dec_device:.4f} ms ({100 * dec_bound / dec_device:.1f}% "
          f"of the bound {dec_bound:.6f} ms), L2 warm {dec_warm:.4f} ms; "
          f"SDPA with the kv mask, L2 cold, {dec_lib_ms:.4f} ms in turns "
          f"{dec_turns['sdpa'][1]}; err vs plain {err_dec:.3g}; two runs "
          f"bitwise equal", flush=True)
    ctx = dict(psched=psched, qkv=(q, k, v), out=out, pairs=pairs,
               fwd_lib=lib, kv_lens=kv_lens, dec=(qd, kc, vc), dec_out=got,
               kv_tokens=kv_tokens, dec_lib=dec_lib)
    path = K.tile_body(dt, blk, BODY_DIR["packed_fwd_tc_kernel"][1])
    print(f"{tag}: packed_fwd at the serving shape {fwd_ms:.4f} ms "
          f"({path}) in turns {turns['fwd'][1]}, on the device "
          f"{fwd_device:.4f} ms, SDPA with the block mask {fwd_lib:.4f} ms in "
          f"turns {turns['sdpa'][1]}, bound {fwd_bound:.6f} ms "
          f"({100 * fwd_bound / fwd_device:.1f}% on the device), err vs plain "
          f"{err_fwd:.3g}", flush=True)
    return ctx, [
        {"name": "tri_attn.packed_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_fwd.cu",
         "replaces": "src/repro/kernels/tri_attn/kernel.py:384",
         "max_abs_err": err_fwd, "ms": fwd_ms, "plain_ms": fwd_plain,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": fwd_lib,
         "library": "SDPA forward with the block-diagonal member mask",
         "path": path, "device_ms": fwd_device, "ms_turns": turns["fwd"][1],
         "library_ms_turns": turns["sdpa"][1],
         "shape": {"lens": lens, "H": h, "Hkv": hkv, "D": d, "blk": blk,
                   "steps": psched.steps, "pairs": pairs}},
        {"name": "tri_attn.packed_decode_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_decode.cu",
         "replaces": "src/repro/kernels/tri_attn/kernel.py:742",
         "path": dec_path,
         "max_abs_err": err_dec, "ms": dec_ms, "plain_ms": dec_plain,
         "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": dec_lib_ms,
         "library": "SDPA with the kv mask, f32, L2 cold, in turns",
         "device_ms": dec_device, "device_ms_l2_warm": dec_warm,
         "ms_turns_l2_cold": dec_turns["decode"][1],
         "library_ms_turns": dec_turns["sdpa"][1], "grid": dec_grid,
         "shape": {"kv_lens": kv_lens, "H": h, "Hkv": hkv, "D": d,
                   "blk": blk, "S_cache": s_cache, "tiles": needed,
                   "kv_tokens": kv_tokens}},
    ]


def fused_kernel_phase(dev, K, OPS, SC, D, ctx, tag="fused"):
    """tri_attn.fused_step_fwd at full yi-9b width: the prefill members of
    the packed_fwd row admitted into slots 4-7 of B = 8 while slots 0-3
    decode the packed_decode row's kv_lens, on the same tensors. Held
    against the plain version, and against the split kernels, bitwise:
    the prefill half runs packed_fwd's tensor-core body at its 2 blk
    threads, the decode half packed_decode's chunks and body at that count
    (256 in packed_decode), each output element by the same operations."""
    rng = np.random.default_rng(1)
    psched = ctx["psched"]
    qp, kp, vp = ctx["qkv"]
    qd4, kc4, vc4 = ctx["dec"]
    kv_lens, live = ctx["kv_lens"], list(range(len(ctx["kv_lens"])))
    b, h, d = 8, qd4.shape[1], qd4.shape[2]
    blk, s_cache = psched.blk, kc4.shape[1]

    def more(x):  # slots 4-7 (being admitted) hold other data
        extra = torch.as_tensor(rng.standard_normal(x.shape, np.float32),
                                device=dev).to(x.dtype)
        return torch.cat([x, extra]).contiguous()

    qd, kc, vc = more(qd4), more(kc4), more(vc4)
    n_members = len(psched.members) + b + 1
    tbl_np, needed = OPS.make_fused_table(psched, kv_lens, live, blk=blk,
                                          n_members=n_members, n_slots=b,
                                          s_cache=s_cache)
    tbl = torch.as_tensor(tbl_np, device=dev)
    capacity = psched.steps + D.round_capacity(needed - psched.steps)
    spec = OPS.FusedStepSpec(n_members=n_members, capacity=capacity,
                             blk=blk, impl="cuda", tiles=needed)
    ins = (qp, kp, vp, qd, kc, vc, tbl)
    o_pack, o_dec = OPS.fused_step_attention(*ins, psched, spec)
    torch.cuda.synchronize()
    want_pack, want_dec = SC.fused_step_torch(
        *ins, capacity=capacity, blk=blk, tiles=needed, scale=d ** -0.5)
    err = max(_close("fused_step pack", o_pack, want_pack),
              _close("fused_step decode", o_dec, want_dec))
    if not torch.equal(o_pack, ctx["out"]):
        _fail("fused_step: the prefill half is not bitwise equal to "
              "packed_fwd on the same tensors")
    _close("fused_step decode vs packed_decode_fwd", o_dec[live],
           ctx["dec_out"])
    dec_bitwise = torch.equal(o_dec[live], ctx["dec_out"])
    if not dec_bitwise:
        _fail("fused_step: the decode half is not bitwise equal to "
              "packed_decode_fwd on the same tensors")
    if torch.count_nonzero(o_dec[len(live):]):
        _fail("fused_step: slots without a live decode member are not 0")
    raw = lambda: K.fused_step_fwd(*ins, psched=psched, capacity=capacity,
                                   tiles=needed)
    dtbl_np, dneeded = OPS.make_decode_table(kv_lens, live, blk=blk,
                                             n_members=len(live) + 1,
                                             n_slots=len(live),
                                             s_cache=s_cache)
    dtbl = torch.as_tensor(dtbl_np, device=dev)

    def split():
        K.packed_fwd(qp, kp, vp, psched)
        K.packed_decode_fwd(qd4, kc4, vc4, dtbl, capacity=dneeded, blk=blk,
                            tiles=dneeded)

    def library():
        ctx["fwd_lib"]()
        ctx["dec_lib"]()

    # re-read the split kernels beside the fused one, in turns
    times = {"fused": [], "split": [], "fwd": [], "dec": []}
    for _ in range(3):
        times["fwd"].append(_median_ms(lambda: K.packed_fwd(qp, kp, vp,
                                                            psched), 10))
        times["dec"].append(_median_ms(lambda: K.packed_decode_fwd(
            qd4, kc4, vc4, dtbl, capacity=dneeded, blk=blk,
            tiles=dneeded), 25))
        times["fused"].append(_median_ms(raw, 10))
        times["split"].append(_median_ms(split, 10))
    fused_ms = statistics.median(times["fused"])
    device_ms = _device_ms(lambda: [raw() for _ in range(20)], 20,
                           "fused_step")
    plain_ms = _median_ms(lambda: SC.fused_step_torch(
        *ins, capacity=capacity, blk=blk, tiles=needed, scale=d ** -0.5),
        3, 1)
    lib_ms = _median_ms(library, 10)
    hkv = kp.shape[1]
    work = dict(pack_q_elems=qp.numel(), pack_k_elems=kp.numel(),
                pack_v_elems=vp.numel(), elt=qp.element_size(),
                live=len(live), h=h, d=d, tbl_elems=tbl.numel(),
                kv_tokens=ctx["kv_tokens"], hkv=hkv,
                cache_elt=kc.element_size(), pairs=ctx["pairs"])
    nbytes = RF.fused_step_work(**work)[0]
    bound, by = RF.fused_step_bound(**work)
    path = K.tile_body(qp.dtype, blk, BODY_DIR["fused_step_kernel"][1])
    grid = K.decode_grid(needed - psched.steps, n_members - len(psched.members),
                         blk, hkv, h // hkv)
    dec_blocks = grid[0] * grid[1]
    # csrc/fused_step.cu's FusedShape::NT: the prefill body's threads
    threads = 256 if path == "fma_f32" else 2 * blk
    print(f"{tag}: fused_step_fwd at {threads} threads a block ({path} "
          f"prefill, the decode half at {threads}) {times['fused']} ms, on "
          f"the device {device_ms:.4f} ms; split kernels summed "
          f"{times['split']} ms, packed_fwd {times['fwd']} ms, "
          f"packed_decode_fwd {times['dec']} ms (re-read in turns); prefill "
          f"half bitwise equal to packed_fwd, decode half bitwise equal to "
          f"packed_decode_fwd; {nbytes} bytes, grid {dec_blocks} decode + "
          f"{psched.total_tiles * h} prefill blocks", flush=True)
    return {"name": "tri_attn.fused_step_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_step.cu",
            "replaces": "src/repro/kernels/tri_attn/kernel.py:909",
            "path": path, "threads": threads, "device_ms": device_ms,
            "ms_turns": times["fused"],
            "max_abs_err": err, "ms": fused_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": "two SDPA calls (prefill with the dense block mask, "
                       "decode with the kv mask): no single PyTorch call "
                       "computes the mixed function",
            "split_ms": statistics.median(times["split"]),
            "reread_ms": {"tri_attn.packed_fwd": times["fwd"],
                          "tri_attn.packed_decode_fwd": times["dec"]},
            "decode_half_bitwise": dec_bitwise,
            "shape": {"lens": [m.n * blk for m in psched.members],
                      "kv_lens": kv_lens, "B": b, "S_cache": s_cache,
                      "tiles": needed, "capacity": capacity,
                      "bytes": nbytes}}


def _check_served(label, eng, results, uids, max_new, cfg):
    report = eng.report()
    st = eng.stats
    if sorted(results) != sorted(uids) or any(
            r["status"] != "done" for r in report.values()):
        _fail(f"{label}: not every request is done: {report}")
    if any(len(results[u]) != m for u, m in zip(uids, max_new)):
        _fail(f"{label}: a request emitted the wrong number of tokens")
    if any(not 0 <= t < cfg.vocab_size for u in results for t in results[u]):
        _fail(f"{label}: a token lies outside the vocabulary")
    if st["launches_degraded_total"] or st["requests_failed_total"]:
        _fail(f"{label}: degraded={st['launches_degraded_total']} "
              f"failed={st['requests_failed_total']}")
    return st


def _serve(eng, prompts, max_new):
    for uid, (p, m) in enumerate(zip(prompts, max_new)):
        eng.submit(p, max_new=m, uid=uid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def serving_phase(dev, layers: int, card: str, K):
    """Split serving, the decode auto-mode (phase 4b), then fused serving
    at full width on one set of random weights; returns each kernel's
    launches on its path, and rows 1-2's on the default (auto) path."""
    import dataclasses

    from repro_torch.configs import yi_9b
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine

    cfg = yi_9b.CONFIG
    if layers != cfg.n_layers:
        print(f"serving: depth cut to {layers} of {cfg.n_layers} layers "
              f"(--layers)", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"serving: yi-9b {cfg.n_layers}L d_model={cfg.d_model} "
          f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size}: {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB of bf16 weights in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kw = dict(slots=4, max_len=2048, prefill_block=64, decode_block=64,
              prefill_impl="cuda", decode_impl="cuda", decode_mode="packed",
              device=dev)
    n_l = cfg.n_layers
    rng = np.random.default_rng(1)

    # split mode: 8 skewed prompts, 32 new tokens each
    prompt_lens = [1000, 90, 500, 250, 700, 60, 380, 150]
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in prompt_lens]
    max_new = [32] * len(prompts)
    eng = Engine(params, cfg, **kw)
    _reset_launches(K)
    results, wall = _serve(eng, prompts, max_new)
    counts = _launches(K)
    launches = {n: counts.pop(n) for n in ("tri_attn.packed_fwd",
                                           "tri_attn.packed_decode_fwd")}
    st = _check_served("serving", eng, results, range(len(prompts)),
                       max_new, cfg)
    if launches["tri_attn.packed_fwd"] != n_l * st["prefill_launches"] or \
            launches["tri_attn.packed_decode_fwd"] != \
            n_l * st["decode_packed_launches"] or \
            st["decode_packed_launches"] != st["decode_rounds"] or \
            not all(launches.values()) or any(counts.values()):
        _fail(f"serving: kernel launches {launches} != {n_l} layers x "
              f"engine launches (prefill {st['prefill_launches']}, decode "
              f"{st['decode_packed_launches']} of {st['decode_rounds']})")
    new_tokens = sum(len(v) for v in results.values())
    prompt_tokens = sum(prompt_lens)
    print(f"serving: {len(results)} requests, {prompt_tokens} prompt + "
          f"{new_tokens} generated tokens in {wall:.3f} s: "
          f"{new_tokens / wall:.1f} generated tokens/s "
          f"({(prompt_tokens + new_tokens) / wall:.1f} tokens/s incl. "
          f"prefill); admit rounds {st['admit_rounds']}, prefill launches "
          f"{st['prefill_launches']}, decode rounds {st['decode_rounds']}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"card {card}", flush=True)
    for uid, n in enumerate((900, 40, 600, 200)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=6,
                   uid=1000 + uid)
    eng.round()  # admit + first decode round, outside the window
    profile_rounds(eng, 4, "packed decode rounds", card)
    eng.run()
    auto = auto_phase(params, cfg, kw, prompts, max_new, results, card, K)
    del eng

    # fused mode: 12 prompts with staggered budgets, so that admit rounds
    # carry live decode slots; split mode on the same traffic beside it
    prompt_lens = [1000, 90, 500, 250, 700, 60, 380, 150, 820, 45, 610, 220]
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in prompt_lens]
    max_new = [8, 40, 16, 32, 24, 12, 36, 20, 28, 10, 18, 30]
    eng = Engine(params, cfg, step_mode="fused", **kw)
    _reset_launches(K)
    results, wall = _serve(eng, prompts, max_new)
    counts = _launches(K)
    fused_launches = counts.pop("tri_attn.fused_step_fwd")
    st = _check_served("fused serving", eng, results, range(len(prompts)),
                       max_new, cfg)
    mixed = st["decode_rounds"] - st["decode_packed_launches"]
    if fused_launches != n_l * st["fused_launches"] or \
            counts.pop("tri_attn.packed_decode_fwd") != \
            n_l * st["decode_packed_launches"] or any(counts.values()) \
            or not fused_launches or mixed < 4 or st["fused_fallbacks"]:
        _fail(f"fused serving: launches fused {fused_launches}, decode "
              f"{K.packed_decode_fwd.launches}, prefill "
              f"{K.packed_fwd.launches} for {n_l} layers x engine fused "
              f"{st['fused_launches']} / decode "
              f"{st['decode_packed_launches']}; mixed rounds {mixed}")
    new_tokens = sum(len(v) for v in results.values())
    split_eng = Engine(params, cfg, **kw)
    split_results, split_wall = _serve(split_eng, prompts, max_new)
    _check_served("split serving", split_eng, split_results,
                  range(len(prompts)), max_new, cfg)
    del split_eng
    print(f"fused serving: {len(results)} requests, {sum(prompt_lens)} "
          f"prompt + {new_tokens} generated tokens: fused {wall:.3f} s, "
          f"{new_tokens / wall:.1f} generated tokens/s; split on the same "
          f"traffic {split_wall:.3f} s, {new_tokens / split_wall:.1f} "
          f"generated tokens/s; fused rounds {st['fused_rounds']} "
          f"({mixed} with live decode slots), decode-only rounds "
          f"{st['decode_packed_launches']}, fused tiles {st['fused_tiles']}; "
          f"card {card}", flush=True)
    # a profiler window over fused rounds that carry admits: three long
    # requests decode while one-token requests take the fourth slot
    for uid, n in enumerate((900, 600, 200)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=40,
                   uid=2000 + uid)
    eng.round()  # admits the long ones, no live slot: outside the window
    for uid, n in enumerate((700, 150, 400, 90, 300, 500)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=1,
                   uid=2100 + uid)
    eng.round()
    profile_rounds(eng, 4, "fused rounds (1 admit + 3 live slots each)",
                   card)
    eng.run()
    del eng
    snapshot_phase(params, cfg, kw, rng, card)
    del params
    torch.cuda.empty_cache()
    return dict(launches, **{"tri_attn.fused_step_fwd": fused_launches}), \
        auto


def snapshot_phase(params, cfg, kw, rng, card):
    """Snapshot a fused engine mid-run, finish it, restore the snapshot on
    the same params and finish again: identical tokens."""
    from repro_torch.resilience import snapshot as SNAP
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, step_mode="fused", **kw)
    max_new = [6, 14, 9, 12, 4, 10]
    for uid, (n, m) in enumerate(zip((640, 90, 300, 1200, 40, 500),
                                     max_new)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=m,
                   uid=uid)
    for _ in range(5):
        eng.round()
    t0 = time.perf_counter()
    snap = SNAP.snapshot(eng)
    snap_s = time.perf_counter() - t0
    first = eng.run()
    again = SNAP.restore(snap, params=params).run()
    if first != again or sorted(first) != list(range(len(max_new))):
        _fail(f"snapshot: restored tokens {again} != {first}")
    print(f"snapshot: fused engine cut after 5 rounds ({snap_s:.3f} s to "
          f"copy the cache to host), restored on the same params: identical "
          f"tokens for {len(first)} requests; card {card}", flush=True)


# phase 4b, the decode auto-mode: the reference's skew harness
# (benchmarks/bench_packed.py, run_decode) at the serving cell, slot 0 at
# AUTO_BASE tokens and the other three at AUTO_BASE / K
AUTO_BASE = 2048
AUTO_SKEWS = (1, 4, 16)
AUTO_ROUNDS = 7      # timed rounds a mode a K (medians), after 2 warm-up
AUTO_LAYER_CALLS = 20  # one layer's attention calls in a profiler window
AUTO_UNIFORM = (700, 700, 700, 700)   # equal prompts, equal budgets
AUTO_STRAGGLER = (1900, 60, 60, 60)   # tiles (30, 1, 1, 1) at blk 64
AUTO_NEW = 12
AUTO_WINDOW = 4  # rounds in the batches' profiler windows


def _window_kernels(fn) -> dict:
    """{device kernel name: [launches, device ms]} of one torch.profiler
    window (host and device activity) over ``fn()``; device kernels only,
    since host ops carry their kernels' time too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and str(ev.device_type).endswith("CUDA"):
            out[ev.key] = [ev.count, us / 1e3]
    return out


def _auto_round_times(eng, kv_lens) -> dict:
    """Both decode modes forced on one engine round at ``kv_lens`` (all
    slots live, positions kv_len - 1), in turns: the medians of the host
    wall time and of CUDA events over the round, ms; the last logits."""
    live = list(range(eng.B))
    eng.pos = torch.as_tensor([k - 1 for k in kv_lens], dtype=torch.int32,
                              device=eng.device)
    host = {"packed": [], "lockstep": []}
    events = {"packed": [], "lockstep": []}
    last = {}
    for r in range(2 + AUTO_ROUNDS):
        for mode in (("packed", "lockstep") if r % 2 == 0
                     else ("lockstep", "packed")):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            logits, _ = eng._decode_round(live, kv_lens, 0, mode)
            e1.record()
            e1.synchronize()
            t1 = time.perf_counter()
            last[mode] = logits[:, 0, :eng.cfg.vocab_size].float()
            if r >= 2:
                host[mode].append((t1 - t0) * 1e3)
                events[mode].append(e0.elapsed_time(e1))
    return {"host": {m: statistics.median(v) for m, v in host.items()},
            "events": {m: statistics.median(v) for m, v in events.items()},
            "logits": last}


def _per_call_ms(kernels: dict, calls: int) -> float:
    """Device ms a call from a _window_kernels reading over ``calls``
    calls: each kernel's mean launch times its launches a call (its count
    over ``calls``, rounded, so a launch the trace missed does not read
    low), summed over every kernel the calls launched."""
    return sum(ms / n * max(1, round(n / calls))
               for n, ms in kernels.values())


def _auto_layer_ms(eng, kv_lens, OPS, D, SC):
    """One attention layer of a decode round at ``kv_lens`` on the serving
    cell's shapes (layer 0's bf16 weights and f32 cache, a random bf16
    hidden state), in the function each mode's round runs a layer with:
    layers.packed_decode_attention (row 2's kernel) for packed and
    layers.decode_attention (the full-cache einsum) for lockstep. Each
    mode's device ms a call is the sum over every kernel the call
    launches (projections, rope, the cache write, attention and wo alike,
    _per_call_ms), read in one profiler window of AUTO_LAYER_CALLS calls;
    row 2's kernel alone is read from the packed window. The kernel is
    held to its plain version, the two layers' outputs to each other at
    the bf16 policy."""
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as T

    cfg, dev, b = eng.cfg, eng.device, eng.B
    lp = T.layer_params(eng.params["layers"], 0)["l0"]["mixer"]
    kc, vc = eng.cache["l0"]["k"][0], eng.cache["l0"]["v"][0]
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((b, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    x = torch.randn((b, 1, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = torch.as_tensor([k - 1 for k in kv_lens], dtype=torch.int32,
                          device=dev)
    tbl_np, needed = OPS.make_decode_table(
        kv_lens, list(range(b)), blk=eng.decode_block, n_members=b + 1,
        n_slots=b, s_cache=eng.s_cache)
    tbl = torch.as_tensor(tbl_np, device=dev)
    spec = OPS.DecodeRoundSpec(
        n_members=b + 1, capacity=D.round_capacity(needed),
        blk=eng.decode_block, impl="cuda", tiles=needed)
    got = OPS.packed_decode_attention(q, kc, vc, tbl, spec)
    err = _close("auto: packed_decode_fwd", got, SC.packed_decode_torch(
        q, kc, vc, tbl, capacity=spec.capacity, blk=eng.decode_block,
        tiles=needed, scale=cfg.head_dim ** -0.5))
    layer = {
        "packed": lambda: LY.packed_decode_attention(
            lp, x, cfg, cache_k=kc, cache_v=vc, pos=pos, decode_tbl=tbl,
            decode_spec=spec)[0],
        "lockstep": lambda: LY.decode_attention(
            lp, x, cfg, cache_k=kc, cache_v=vc, pos=pos)[0]}
    out = {m: f() for m, f in layer.items()}
    err_layer = _close("auto: one layer, packed vs lockstep", out["packed"],
                       out["lockstep"], _logit_tol(out["lockstep"]))
    windows = {m: _window_kernels(lambda f=f: [
        f() for _ in range(AUTO_LAYER_CALLS)]) for m, f in layer.items()}
    dec = {k: v for k, v in windows["packed"].items()
           if "packed_decode_kernel" in k}
    if any(["packed_decode_kernel" in k for k in windows["lockstep"]]) or \
            not dec:
        _fail(f"auto: packed_decode_kernel in the lockstep layer's window "
              f"or missing from the packed one: {sorted(windows['packed'])}"
              f" / {sorted(windows['lockstep'])}")
    return {"kernel_ms": _per_call_ms(dec, AUTO_LAYER_CALLS),
            "layer_ms": {m: _per_call_ms(w, AUTO_LAYER_CALLS)
                         for m, w in windows.items()},
            "layer_kernels": {m: len(w) for m, w in windows.items()},
            "tiles": needed, "err": err, "err_layer": err_layer}


def _auto_tokens_match(label, probe, packed, cfg, strict) -> list:
    """The tokens of ``probe`` == those of ``packed`` (two _probe_engine
    runs of the same traffic, the second with decode_mode "packed")
    request by request, or the first token where a stream differs is a
    near-tie. With ``strict`` (float32) a near-tie is the packed engine's
    top two logits within OUT_TOL of each other. In bf16 the two paths' attention outputs round
    to bf16 apart (the kernel's f32 chunks against the einsum's f32 sum)
    and 48 bf16 layers carry that to the logits, so a flip must instead
    come where the two engines' logits of that round agree within the
    bf16 policy (_logit_tol): the flip's margin is then under their
    rounding. Returns the flips (uid, token, packed top-two gap, max
    |logit difference|)."""
    got = {r.uid: r.out for r in probe.finished}
    want = {r.uid: r.out for r in packed.finished if r.uid in got}
    if sorted(want) != sorted(got):
        _fail(f"{label}: requests {sorted(got)} against {sorted(want)}")
    bad = [u for u in want if got[u] != want[u]]
    ties = []
    for u in bad:
        step = next(i for i, (a, b) in enumerate(zip(got[u], want[u]))
                    if a != b)
        lp = packed.logits[u, step][:cfg.vocab_size]
        la = probe.logits[u, step][:cfg.vocab_size]
        top = torch.topk(lp, 2).values
        gap = float(top[0] - top[1])
        diff = float((la - lp).abs().max())
        if strict and gap > OUT_TOL["atol"] + \
                OUT_TOL["rtol"] * float(top[0].abs()):
            _fail(f"{label}: request {u} token {step} differs from the "
                  f"packed engine's, and its top two logits are {gap:.4g} "
                  f"apart: not a near-tie")
        _close(f"{label}: request {u} logits at token {step}", la[None],
               lp[None], _logit_tol(lp))
        ties.append((u, step, round(gap, 6), round(diff, 6)))
    if ties:
        how = ("a near-tie within OUT_TOL" if strict
               else "within the bf16 logit policy")
        print(f"{label}: streams that differ from the packed engine's, at "
              f"(uid, token, packed top-two gap, max |logit diff|) {ties}: "
              f"each {how} there; every token before it and every other "
              f"stream equal", flush=True)
    return ties


def auto_phase(params, cfg, kw, prompts, max_new, packed_results, card,
               K):
    """Phase 4b: the engine's default decode mode ("auto") at full width.
    The crossover: each mode forced on one round at K = 1, 4, 16 (host
    wall and CUDA-event medians, seconds a tile, the measured ratio, the
    rule's pick at PACKED_TILE_COST_RATIO and the faster mode), all K
    before any profiler window (a window slows the host's later
    launches), then one attention layer in each mode's own function on
    the device, all kernels of each call, beside row 2's kernel alone;
    the split mix served with the defaults on a plain engine (tokens/s,
    launches), then on packed and auto probe engines (each probe's tokens
    == the plain engine's of its mode, auto's == packed's but flips as
    _auto_tokens_match says), and in float32 too; a uniform batch (every
    round lockstep, no decode kernel in a profiler window or in
    launches_total) and a straggler batch (packed rounds, one decode
    launch a layer each). ``packed_results`` are the serving phase's
    plain packed engine's tokens on the same traffic. Returns the default
    path's launches of rows 1 and 2."""
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.kernels.tri_attn import scan_impl as SC
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.serve import decode as D
    from repro_torch.serve import engine as E

    t_phase = time.perf_counter()
    auto_kw = {k: v for k, v in kw.items() if k != "decode_mode"}
    n_l = cfg.n_layers
    eng = E.Engine(params, cfg, **auto_kw)
    if eng.decode_mode != "auto":
        _fail(f"auto: the engine's default decode mode is "
              f"{eng.decode_mode!r}")
    gen = torch.Generator(device=eng.device).manual_seed(5)
    for leaves in eng.cache.values():
        for t in leaves.values():
            t.normal_(generator=gen)
    eng.last_tok = torch.randint(1, cfg.vocab_size, (eng.B, 1), generator=gen,
                                 device=eng.device)
    rows = []
    for skew in AUTO_SKEWS:
        kv_lens = [AUTO_BASE] + [AUTO_BASE // skew] * (eng.B - 1)
        tiles = [-(-k // eng.decode_block) for k in kv_lens]
        done = {"packed": sum(tiles), "lockstep": eng.B * max(tiles)}
        t = _auto_round_times(eng, kv_lens)
        tile_us = {src: {m: 1e3 * t[src][m] / done[m] for m in done}
                   for src in ("host", "events")}
        lg = t["logits"]
        rows.append({
            "K": skew, "kv_lens": kv_lens, "tiles": tiles,
            "done_tiles": done, "host_ms": t["host"],
            "events_ms": t["events"], "us_a_tile": tile_us,
            "ratio": {src: tile_us[src]["packed"] / tile_us[src]["lockstep"]
                      for src in tile_us},
            "rule_2_3": eng._round_mode(tiles),
            "faster": min(t["host"], key=t["host"].get),
            "logits_max_diff": float((lg["packed"] - lg["lockstep"])
                                     .abs().max()),
            "argmax_agree": int((lg["packed"].argmax(-1)
                                 == lg["lockstep"].argmax(-1)).sum())})
    for row in rows:
        row["layer"] = layer = _auto_layer_ms(eng, row["kv_lens"], OPS, D, SC)
        host, ev, us = row["host_ms"], row["events_ms"], row["us_a_tile"]
        print(f"auto crossover K={row['K']}: kv_lens {row['kv_lens']}, tiles "
              f"{row['tiles']} (packed {row['done_tiles']['packed']}, "
              f"lockstep {row['done_tiles']['lockstep']}); round host ms "
              f"packed {host['packed']:.3f} lockstep {host['lockstep']:.3f}, "
              f"CUDA events packed {ev['packed']:.3f} lockstep "
              f"{ev['lockstep']:.3f} (medians of {AUTO_ROUNDS}); us a tile "
              f"(host) packed {us['host']['packed']:.3f} lockstep "
              f"{us['host']['lockstep']:.3f}, measured ratio "
              f"{row['ratio']['host']:.4f} (events "
              f"{row['ratio']['events']:.4f}); the rule at "
              f"{E.PACKED_TILE_COST_RATIO} picks {row['rule_2_3']}, faster: "
              f"{row['faster']}; logits max |packed - lockstep| "
              f"{row['logits_max_diff']:.4g}, argmax equal in "
              f"{row['argmax_agree']}/{eng.B} slots; one layer on the "
              f"device, all kernels of each call: packed "
              f"(layers.packed_decode_attention, "
              f"{layer['layer_kernels']['packed']} kernel names) "
              f"{layer['layer_ms']['packed']:.4f} ms, of which "
              f"packed_decode_fwd {layer['kernel_ms']:.4f} ms; lockstep "
              f"(layers.decode_attention, the full-cache einsum, "
              f"{layer['layer_kernels']['lockstep']} kernel names) "
              f"{layer['layer_ms']['lockstep']:.4f} ms (kernel vs plain "
              f"err {layer['err']:.3g}, the layers' outputs "
              f"{layer['err_layer']:.3g} apart); card {card}", flush=True)
    print(json.dumps({"auto_crossover": rows}, default=float), flush=True)
    del eng
    torch.cuda.empty_cache()

    launches = dict.fromkeys(("tri_attn.packed_fwd",
                              "tri_attn.packed_decode_fwd"), 0)

    def serve(label, lens_prompts, budgets, window=False):
        """One default engine over the traffic, counted from 0; with
        ``window`` the rounds after the first in a profiler window."""
        eng = E.Engine(params, cfg, **auto_kw)
        reg = MET.Registry(label)
        _reset_launches(K)
        kernels, packed0 = {}, 0
        with MET.scope(reg):
            if window:
                for uid, (p, m) in enumerate(zip(lens_prompts, budgets)):
                    eng.submit(p, max_new=m, uid=uid)
                eng.round()
                packed0 = eng.stats["decode_packed_launches"]
                kernels = _window_kernels(
                    lambda: [eng.round() for _ in range(AUTO_WINDOW)])
                packed0 -= eng.stats["decode_packed_launches"]
                eng.run()
                results, wall = {r.uid: r.out for r in eng.finished}, None
            else:
                results, wall = _serve(eng, lens_prompts, budgets)
        st = _check_served(label, eng, results, range(len(lens_prompts)),
                           budgets, cfg)
        if st["decode_packed_launches"] + st["decode_lockstep_launches"] != \
                st["decode_rounds"]:
            _fail(f"{label}: rounds {st['decode_rounds']} != packed "
                  f"{st['decode_packed_launches']} + lockstep "
                  f"{st['decode_lockstep_launches']}")
        got = _check_launches(label, K, reg, {
            "tri_attn.packed_fwd": n_l * st["prefill_launches"],
            "tri_attn.packed_decode_fwd": n_l * st["decode_packed_launches"]})
        cuda = reg.counter_value("launches_total", {
            "name": "tri_attn.packed_decode_fwd", "impl": "cuda"})
        if cuda != got["tri_attn.packed_decode_fwd"]:
            _fail(f"{label}: launches_total {cuda} != the wrapper's "
                  f"{got['tri_attn.packed_decode_fwd']}")
        for name, n in got.items():
            launches[name] += n
        return eng, results, wall, st, kernels, -packed0

    # the serving cell's split mix with the defaults, on a plain engine
    # (the tokens/s reading, like the serving phase's packed line)
    eng, results, wall, st, _, _ = serve("auto serving", prompts, max_new)
    new_tokens = sum(len(v) for v in results.values())
    print(f"auto serving: {len(results)} requests, {new_tokens} generated "
          f"tokens in {wall:.3f} s: {new_tokens / wall:.1f} generated "
          f"tokens/s (a plain engine); decode rounds {st['decode_rounds']}: "
          f"packed {st['decode_packed_launches']}, lockstep "
          f"{st['decode_lockstep_launches']}; tiles "
          f"{st['decode_tiles_packed']} packed vs "
          f"{st['decode_tiles_padded']} padded; card {card}", flush=True)
    del eng
    # the same traffic on two probe engines, packed and auto, which keep
    # each token's logits: a probe's tokens equal the plain engine's of
    # its mode, and auto's equal packed's but for flips as
    # _auto_tokens_match says
    probes, walls = {}, {}
    for mode, want in (("packed", packed_results), ("auto", results)):
        probes[mode] = _probe_engine(E.Engine, params, cfg, **dict(
            auto_kw, decode_mode=mode))
        got, walls[mode] = _serve(probes[mode], prompts, max_new)
        _check_served(f"auto serving, probe ({mode})", probes[mode], got,
                      range(len(prompts)), max_new, cfg)
        if got != want:
            _fail(f"auto serving: the {mode} probe's tokens differ from "
                  f"the plain {mode} engine's")
    ties = _auto_tokens_match("auto serving", probes["auto"],
                              probes["packed"], cfg, strict=False)
    print(f"auto serving, probes: tokens == the packed engine's but "
          f"{len(ties)} streams from a flip within the bf16 logit policy; "
          f"generated tokens/s of the recording probes (logits cloned "
          f"every token) packed {new_tokens / walls['packed']:.1f}, auto "
          f"{new_tokens / walls['auto']:.1f}; card {card}", flush=True)
    del probes

    # the same traffic in float32 at full width and depth, where the two
    # decode paths agree to f32 rounding: tokens equal but near-ties
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = MD.init_params(cfg32, seed=0, device=params["embed"].device)
    run32 = {}
    for mode, e_kw in (("packed", {"decode_mode": "packed"}), ("auto", {})):
        run32[mode] = _probe_engine(E.Engine, params32, cfg32,
                                    **dict(auto_kw, **e_kw))
        got, _ = _serve(run32[mode], prompts, max_new)
        st32 = _check_served(f"auto serving float32 ({mode})", run32[mode],
                             got, range(len(prompts)), max_new, cfg)
    ties = _auto_tokens_match("auto serving, float32", run32["auto"],
                              run32["packed"], cfg32, strict=True)
    print(f"auto serving, float32 (full width and depth, "
          f"{sum(p.numel() for p in _leaves(params32)) / 1e9:.2f} B "
          f"parameters): decode rounds packed "
          f"{st32['decode_packed_launches']}, lockstep "
          f"{st32['decode_lockstep_launches']}; tokens == the packed "
          f"engine's for {len(prompts) - len(ties)} of {len(prompts)} "
          f"streams, the rest from a near-tie within OUT_TOL; card {card}",
          flush=True)
    del params32, run32
    torch.cuda.empty_cache()

    rng = np.random.default_rng(32)
    for label, lens in (("auto uniform batch", AUTO_UNIFORM),
                        ("auto straggler batch", AUTO_STRAGGLER)):
        batch = [rng.integers(1, cfg.vocab_size, size=n) for n in lens]
        budgets = [AUTO_NEW] * len(batch)
        eng, _, _, st, kernels, in_window = serve(label, batch, budgets,
                                                  window=True)
        seen = sum(n for name, (n, _) in kernels.items()
                   if "packed_decode_kernel" in name)
        if not kernels:
            _fail(f"{label}: the profiler window saw no device kernel")
        if lens == AUTO_UNIFORM:
            if st["decode_packed_launches"] or seen or \
                    st["decode_lockstep_launches"] != st["decode_rounds"]:
                _fail(f"{label}: packed rounds {st['decode_packed_launches']}"
                      f" of {st['decode_rounds']}, packed_decode_kernel "
                      f"{seen} times in the profiler window")
        else:
            in_window *= n_l
            if not st["decode_packed_launches"] or not 0 < seen <= in_window:
                _fail(f"{label}: packed rounds {st['decode_packed_launches']}"
                      f", packed_decode_kernel {seen} times in a window of "
                      f"{in_window} launches")
        print(f"{label}: prompts {lens}, {AUTO_NEW} new each: decode rounds "
              f"{st['decode_rounds']} (packed {st['decode_packed_launches']}"
              f", lockstep {st['decode_lockstep_launches']}); "
              f"packed_decode_fwd launches {n_l} x packed rounds; a "
              f"profiler window over rounds 2-{AUTO_WINDOW + 1}: "
              f"packed_decode_kernel x{seen}, {len(kernels)} kernel names; "
              f"card {card}", flush=True)
        del eng
    secs = time.perf_counter() - t_phase
    print(f"auto: phase {secs:.1f} s; default-path launches {launches}",
          flush=True)
    return launches


EXAMPLES = ("quickstart", "triangular_attention", "edm_pairwise",
            "tet_3body", "packed_prefill", "packed_decode", "packed_train",
            "serve_demo", "fleet_serve")


def examples_phase(K):
    """The nine examples/torch_*.py, each main() on the card (their own
    assertions), with the tri_attn kernels they launch counted."""
    import importlib.util

    root = Path(__file__).resolve().parent / "examples"
    t0 = time.perf_counter()
    secs = {}
    _reset_launches(K)
    for name in EXAMPLES:
        path = root / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t = time.perf_counter()
        mod.main("cuda")
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t, 2)
        print(f"examples: torch_{name}.py main() on the card in "
              f"{secs[name]} s", flush=True)
    ran = {n: c for n, c in _launches(K).items() if c}
    missing = set(K.WRAPPERS) - set(ran) - {"tri_attn.fused_step_fwd",
                                            "tri_attn.fwd_bb"}
    if missing:
        _fail(f"examples: no launch of {sorted(missing)}")
    total = time.perf_counter() - t0
    print(json.dumps({"examples": {"seconds": secs, "total_s": round(
        total, 2), "tri_attn_launches": ran}}), flush=True)


def profile_rounds(eng, rounds: int, label: str, card):
    """torch.profiler over ``rounds`` engine rounds."""
    profile_window(lambda: [eng.round() for _ in range(rounds)], rounds,
                   "round", label, card)


def profile_window(fn, count: int, unit: str, label: str, card):
    """torch.profiler over ``fn()`` (``count`` rounds or steps): device
    busy time against wall time, and the kernels that take it."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    rows = sorted(((ms, n, name) for name, (n, ms)
                   in _window_kernels(timed).items()), reverse=True)
    wall_ms = wall[0]
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    top = "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for ms, n, name in rows[:6])
    print(f"profile: {count} {label}, wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{n_kernels / count:.0f} kernel launches a {unit}; top: "
          f"{top or 'no device time in the trace'}; card {card}", flush=True)


def checker_phase() -> dict:
    """The port's checker on the card: every lint pass on cuda, the
    resilience smoke's engine and fleet tiers on the kernels, and the obs
    validator over the artifacts they wrote. Fails on any failure."""
    from repro_torch.obs import validate as VAL
    from repro_torch.resilience import smoke as SMOKE

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    art = root / "build" / "checker_artifacts"
    shutil.rmtree(art, ignore_errors=True)
    # the lint opens torch.profiler windows, and a process that has opened
    # one launches slower after it (scripts/profiler_overhead.py): it runs
    # in a process of its own, so no later phase's time carries that
    report = art / "lint_report.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--device",
         "cuda", "-q", "--json", str(report)], capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    rep = json.loads(report.read_text()) if report.exists() else None
    for r in (rep or {}).get("results", []):
        if not r["ok"] or r["rule"].startswith("obs.counters."):
            print(f"checker: {'ok' if r['ok'] else 'FAIL'} {r['rule']}: "
                  f"{r['detail'][:300]}", flush=True)
    if run.returncode or rep is None or rep["total_failures"]:
        _fail(f"checker: the lint on cuda failed (rc {run.returncode}): "
              f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    lint_s = time.perf_counter() - t0
    smoke = {}
    for tier, extra in (("engine", ["--plans", "3"]), ("fleet", ["--fleet"])):
        rc = SMOKE.main(["--device", "cuda", "--artifacts", str(art)]
                        + extra)
        if rc:
            _fail(f"checker: the resilience smoke's {tier} tier failed")
        smoke[tier] = "ok"
    files = sorted(str(p) for p in art.glob("metrics_*.json")) + \
        sorted(str(p) for p in (art / "trace").glob("*.jsonl"))
    if len(files) < 4 or VAL.main(["-q"] + files):
        _fail(f"checker: obs.validate refused the smoke's artifacts {files}")
    out = {"passes": rep["passes"], "checks": rep["total_checks"],
           "failures": rep["total_failures"], "lint_s": round(lint_s, 2),
           "smoke": smoke, "validated_files": len(files),
           "seconds": round(time.perf_counter() - t0, 2)}
    print(json.dumps({"checker": out}), flush=True)
    return out


def smoke_identity(dev):
    """Smoke-size float32 engines on the card: split and fused with the
    kernels, fused with the plain versions, all emit identical greedy
    tokens; a 2-replica fleet with one injected launch error per step mode
    emits them too."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.resilience import faults as F
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.fleet import Fleet

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in (37, 5, 60, 18, 23)]
    max_new = [8, 3, 6, 9, 5]
    kw = dict(slots=2, max_len=128, prefill_block=16, decode_block=16,
              decode_mode="packed", device=dev)
    outs = {}
    for name, impl, mode in (("split cuda", "cuda", "split"),
                             ("split torch", "torch", "split"),
                             ("fused cuda", "cuda", "fused"),
                             ("fused torch", "torch", "fused")):
        eng = Engine(params, cfg, prefill_impl=impl, decode_impl=impl,
                     step_mode=mode, **kw)
        outs[name], _ = _serve(eng, prompts, max_new)
        _check_served(f"smoke {name}", eng, outs[name], range(len(prompts)),
                      max_new, cfg)
    for name, got in outs.items():
        if got != outs["split cuda"]:
            _fail(f"smoke: {name} tokens {got} != split cuda "
                  f"{outs['split cuda']}")
    for mode in ("split", "fused"):
        fleet = Fleet(params, cfg, engines=2, heartbeat_timeout_s=5.0,
                      engine_kw=dict(kw, step_mode=mode),
                      fault_plan=F.FaultPlan([F.Fault(
                          "launch_error", "decode", 1, times=99, engine=0)]))
        for uid, (p, m) in enumerate(zip(prompts, max_new)):
            fleet.submit(p, max_new=m, uid=uid)
        got = fleet.run(max_steps=200)
        st = fleet.stats
        if got != outs["split cuda"] or not st["fleet_failovers_total"] or \
                any(r["status"] != "done" for r in fleet.report().values()):
            _fail(f"smoke fleet ({mode}): tokens {got} != "
                  f"{outs['split cuda']} or no failover: {st}")
    print(f"smoke: float32 engines, split/fused x cuda/torch greedy tokens "
          f"identical for {len(prompts)} requests; 2-replica fleet with an "
          f"injected launch error fails over to identical tokens in both "
          f"step modes", flush=True)


def train_kernel_phase(dev, K, OPS, SC):
    """tri_attn.fwd, bwd dq and bwd dk/dv at the attention shape of the
    train phase (one yi-9b layer at seq 4096: B 1, H 32, Hkv 4, D 128,
    ltm, blk 64, bf16) against their plain versions on the same inputs,
    timed beside them, SDPA and the bound; band, prefix and 3-token band
    schedules at blk 16, 32, 64 and 128 on small shapes."""
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    dt = torch.bfloat16

    def case(b, h, hkv, s, d):
        return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                                device=dev).to(dt)
                for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                              (b, h, s, d))]

    def check(label, q, k, v, do, sched):
        """The three kernels against their plain versions, the backward
        run twice (bitwise equal: no atomics); returns the errors, the
        kernels' (out, lse, delta) and the plain grads."""
        scale = q.shape[-1] ** -0.5
        out, lse = K.fwd(q, k, v, sched)
        delta = (do.float() * out.float()).sum(dim=-1)
        grads = (K.bwd_dq(q, k, v, do, lse, delta, sched),
                 *K.bwd_dkv(q, k, v, do, lse, delta, sched))
        again = (K.bwd_dq(q, k, v, do, lse, delta, sched),
                 *K.bwd_dkv(q, k, v, do, lse, delta, sched))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
                   for a, b in zip(grads, again)):
            _fail(f"tri_bwd {label}: two runs of dq / dk / dv differ or "
                  f"non-finite")
        w_out, w_lse = SC.fwd_torch(q, k, v, sched, scale)
        want = (SC.dq_torch(q, k, v, do, lse, delta, sched, scale),
                *SC.dkv_torch(q, k, v, do, lse, delta, sched, scale))
        tol = BF16_GRAD_TOL if K.tile_body(dt, sched.bq, "bwd") == "wgmma" \
            else OUT_TOL
        errs = (max(_close(f"{label} fwd out", out, w_out),
                    _close(f"{label} fwd lse", lse, w_lse, LSE_TOL)),
                _close(f"{label} bwd dq", grads[0], want[0], tol),
                max(_close(f"{label} bwd dk", grads[1], want[1], tol),
                    _close(f"{label} bwd dv", grads[2], want[2], tol)))
        return errs, (out, lse, delta), want

    kinds = {"band": lambda blk: (blk + 5, 0),
             "prefix": lambda blk: (None, blk + 3),
             "band_short": lambda blk: (3, 0)}  # whole tile rows masked
    for kind, geom in kinds.items():
        for blk in (16, 32, 64, 128):  # every bf16 body of both directions
            window, prefix = geom(blk)
            q, k, v, do = case(2, 8, 2, 6 * blk, 128)
            sched = OPS.make_sched(6 * blk, block=blk, window=window,
                                   prefix=prefix)
            _, (out, lse, _), _ = check(f"{kind} blk {blk}", q, k, v, do,
                                        sched)
            again = K.fwd(q, k, v, sched)
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                    and bool(torch.isfinite(out.float()).all())):
                _fail(f"tri_fwd {kind} blk {blk}: two runs differ or "
                      f"non-finite")
    b, h, hkv, s, d, blk = 1, 32, 4, 4096, 128, 64
    q, k, v, do = case(b, h, hkv, s, d)
    sched = OPS.make_sched(s, block=blk)
    scale = d ** -0.5
    errs, (out, lse, delta), want = check("ltm", q, k, v, do, sched)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    _close("fwd vs SDPA", out, sdpa())
    bw = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*bw, is_causal=True,
                                           enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, bw, do, retain_graph=True)
    # SDPA's own grads against the same plain versions, beside the kernels'
    g_lib = sdpa_bwd()
    lib_err = [float((got.float() - w.float()).abs().max())
               for got, w in zip(g_lib, want)]
    lib_err = {"dq": lib_err[0], "dkv": max(lib_err[1:])}
    turns = _in_turns({"fwd": lambda: K.fwd(q, k, v, sched), "sdpa": sdpa}, 10)
    bturns = _in_turns({
        "dq": lambda: K.bwd_dq(q, k, v, do, lse, delta, sched),
        "dkv": lambda: K.bwd_dkv(q, k, v, do, lse, delta, sched),
        "sdpa": sdpa_bwd}, 10)
    ms = {"fwd": turns["fwd"][0], "dq": bturns["dq"][0],
          "dkv": bturns["dkv"][0]}
    plain = {"fwd": _median_ms(lambda: SC.fwd_torch(q, k, v, sched, scale),
                               3, 1),
             "dq": _median_ms(lambda: SC.dq_torch(q, k, v, do, lse, delta,
                                                  sched, scale), 3, 1),
             "dkv": _median_ms(lambda: SC.dkv_torch(q, k, v, do, lse, delta,
                                                    sched, scale), 3, 1)}
    lib_fwd, lib_bwd = turns["sdpa"][0], bturns["sdpa"][0]
    pairs = h * s * (s + 1) // 2  # unmasked (query, key) pairs, ltm
    bounds = RF.attn_bounds(q, k, pairs)
    names = {"fwd": ("tri_attn.fwd", "src/repro_torch/csrc/tri_fwd.cu",
                     "src/repro/kernels/tri_attn/kernel.py:293",
                     "SDPA is_causal forward"),
             "dq": ("tri_attn.bwd_dq", "src/repro_torch/csrc/tri_bwd.cu",
                    "src/repro/kernels/tri_attn/kernel.py:1018",
                    "SDPA is_causal backward through autograd (dq, dk and "
                    "dv together: no PyTorch call computes dq alone)"),
             "dkv": ("tri_attn.bwd_dkv", "src/repro_torch/csrc/tri_bwd.cu",
                     "src/repro/kernels/tri_attn/kernel.py:1055",
                     "SDPA is_causal backward through autograd (dq, dk and "
                     "dv together)")}
    out_rows = []
    for key, err in zip(("fwd", "dq", "dkv"), errs):
        name, src, rep, lib = names[key]
        out_rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "max_abs_err": err, "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": lib_fwd if key == "fwd" else lib_bwd,
            "library": lib,
            "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d,
                      "blk": blk, "kind": "ltm", "pairs": pairs}})
    fwd_row = out_rows[0]
    for key, row in zip(("dq", "dkv"), out_rows[1:]):
        row.update(path=K.tile_body(dt, blk, "bwd"),
                   bound_share=row["bound_ms"] / row["ms"],
                   ms_turns=bturns[key][1],
                   library_ms_turns=bturns["sdpa"][1],
                   library_max_abs_err=lib_err[key],
                   grid=list(K.bwd_grid(key, sched, h if key == "dq" else hkv,
                                        b, dt)))

    def other_shape(label, b, h, hkv, s, blk, plain):
        """tri_fwd at another shape a main path or a user gives it, held
        against SDPA (is_causal computes the same ltm function) and, where
        ``plain``, its plain version (out and lse), then timed in turns
        with SDPA."""
        q, k, v, _ = case(b, h, hkv, s, d)
        sched = OPS.make_sched(s, block=blk)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
        out, lse = K.fwd(q, k, v, sched)
        err = _close(f"fwd vs SDPA {label}", out, sdpa())
        if plain:
            w_out, w_lse = SC.fwd_torch(q, k, v, sched, scale)
            err = max(_close(f"fwd out {label}", out, w_out),
                      _close(f"fwd lse {label}", lse, w_lse, LSE_TOL))
        at = _in_turns({"fwd": lambda: K.fwd(q, k, v, sched), "sdpa": sdpa},
                       10)
        return {"shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d,
                          "blk": blk},
                "path": K.tile_body(dt, blk), "max_abs_err": err,
                "against": "plain version" if plain else "SDPA",
                "ms": at["fwd"][0], "ms_turns": at["fwd"][1],
                "library_ms": at["sdpa"][0], "library_ms_turns": at["sdpa"][1],
                "bound_ms": RF.attn_bounds(q, k, b * h * s * (s + 1) // 2)[
                    "fwd"][0]}

    # jamba-1.5-large's attention layer on a 4 x 2048 prefill; training at
    # a sequence 64 does not divide, which layers.attention runs at the
    # tile edge halved until it divides (4064: blk 32, 4080: blk 16), on
    # the mma.sync body
    fwd_row["at_jamba_shape"] = other_shape("at jamba's shape", 4, 64, 8,
                                            2048, blk, plain=True)
    fwd_row["at_ragged_seq"] = [other_shape(f"at S {rs}", b, h, hkv, rs, rb,
                                            plain=False)
                                for rs, rb in ((4064, 32), (4080, 16))]
    fwd_row.update(path=K.tile_body(dt, blk),
                   bound_share=fwd_row["bound_ms"] / fwd_row["ms"],
                   ms_turns=turns["fwd"][1], library_ms_turns=turns["sdpa"][1])
    print(f"train kernels: tri_fwd {ms['fwd']:.4f} ms ({fwd_row['path']}), "
          f"SDPA {lib_fwd:.4f} ms in turns {turns['fwd'][1]} / "
          f"{turns['sdpa'][1]}, bound {fwd_row['bound_ms']:.4f} ms "
          f"({100 * fwd_row['bound_share']:.1f}%); " + "; ".join(
              f"at (B {r['shape']['B']}, H {r['shape']['H']}, Hkv "
              f"{r['shape']['Hkv']}, S {r['shape']['S']}, blk "
              f"{r['shape']['blk']}, {r['path']}) {r['ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}, err vs "
              f"{r['against']} {r['max_abs_err']:.3g}"
              for r in [fwd_row["at_jamba_shape"]] + fwd_row["at_ragged_seq"]),
          flush=True)
    print("train kernels: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} ms ({r['path']}, grid {r['grid']}) in "
        f"turns {r['ms_turns']}, bound {r['bound_ms']:.4f} ms "
        f"({100 * r['bound_share']:.1f}%), err vs plain "
        f"{r['max_abs_err']:.3g}" for r in out_rows[1:])
        + f"; SDPA backward (dq, dk, dv) {lib_bwd:.4f} ms in turns "
        f"{bturns['sdpa'][1]}, err vs plain dq {lib_err['dq']:.3g}, dk/dv "
        f"{lib_err['dkv']:.3g}; dq + dk/dv {ms['dq'] + ms['dkv']:.4f} ms",
        flush=True)
    return out_rows


def packed_train_kernel_phase(dev, K, OPS, SC):
    """packed_fwd and the packed dq and dk/dv at the attention shape of the
    packed train phase (one row of TRAIN_DOCS padded to blk 64: 4096 rows,
    8 ltm members; B 1, H 32, Hkv 4, D 128, bf16) against their plain
    versions on the same inputs (the bf16 wgmma backward's grads at
    BF16_GRAD_TOL, the CUDA-core body's at OUT_TOL), timed beside them,
    SDPA with the block-diagonal causal mask (its autograd backward in
    turns with dq and dk/dv, its own grads' largest error against the same
    plain versions reported) and the bound; mixed ltm/prefix/band/3-token
    band members at blk 16, 64 and 128 on small shapes. Every run of the
    backward is repeated and must be bitwise equal (no atomics). Returns
    the rows of the two backward kernels and packed_fwd's reading at this
    shape."""
    import torch.nn.functional as F

    rng = np.random.default_rng(4)
    dt = torch.bfloat16

    def case(h, hkv, s, d):
        return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                                device=dev).to(dt)
                for shape in ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d),
                              (1, h, s, d))]

    def check(label, q, k, v, do, psched):
        scale = q.shape[-1] ** -0.5
        out, lse = K.packed_fwd(q, k, v, psched)
        delta = (do.float() * out.float()).sum(dim=-1)
        grads = (K.packed_bwd_dq(q, k, v, do, lse, delta, psched),
                 *K.packed_bwd_dkv(q, k, v, do, lse, delta, psched))
        again = (K.packed_bwd_dq(q, k, v, do, lse, delta, psched),
                 *K.packed_bwd_dkv(q, k, v, do, lse, delta, psched))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
                   for a, b in zip(grads, again)):
            _fail(f"{label}: two runs of packed_bwd differ or non-finite")
        w_out, w_lse = SC.packed_fwd_torch(q, k, v, psched, scale)
        want = (SC.packed_dq_torch(q, k, v, do, lse, delta, psched, scale),
                *SC.packed_dkv_torch(q, k, v, do, lse, delta, psched, scale))
        tol = BF16_GRAD_TOL \
            if K.tile_body(dt, psched.blk, "bwd") == "wgmma" else OUT_TOL
        errs = (max(_close(f"{label} packed_fwd out", out, w_out),
                    _close(f"{label} packed_fwd lse", lse, w_lse, LSE_TOL)),
                _close(f"{label} packed_bwd dq", grads[0], want[0], tol),
                max(_close(f"{label} packed_bwd dk", grads[1], want[1], tol),
                    _close(f"{label} packed_bwd dv", grads[2], want[2], tol)))
        return errs, (out, lse, delta), want

    for blk in (16, 64, 128):  # the CUDA-core body, then wgmma at 64, 128
        psched = OPS.make_packed_sched([5 * blk, 2 * blk, 3 * blk, blk],
                                       block=blk,
                                       window=[None, None, blk + 3, 3],
                                       prefix=[0, blk + 1, 0, 0])
        check(f"mixed blk {blk}", *case(8, 2, psched.s_total, 128), psched)
    h, hkv, d, blk = 32, 4, 128, 64
    lens = [-(-n // blk) * blk for n in TRAIN_DOCS]
    psched = OPS.make_packed_sched(lens, block=blk)
    s = psched.s_total
    q, k, v, do = case(h, hkv, s, d)
    scale = d ** -0.5
    errs, (out, lse, delta), want = check("ltm docs", q, k, v, do, psched)
    mask = torch.zeros((s, s), dtype=torch.bool, device=dev)
    base = 0
    for n_tok in lens:
        mask[base:base + n_tok, base:base + n_tok] = torch.ones(
            (n_tok, n_tok), dtype=torch.bool, device=dev).tril()
        base += n_tok
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    _close("packed_fwd vs SDPA (block-diagonal causal mask)", out, sdpa())
    bw = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*bw, attn_mask=mask,
                                           enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, bw, do, retain_graph=True)
    # SDPA's own grads against the same plain versions, beside the kernels'
    lib_err = [float((got.float() - w.float()).abs().max())
               for got, w in zip(sdpa_bwd(), want)]
    lib_err = {"dq": lib_err[0], "dkv": max(lib_err[1:])}
    bturns = _in_turns({
        "dq": lambda: K.packed_bwd_dq(q, k, v, do, lse, delta, psched),
        "dkv": lambda: K.packed_bwd_dkv(q, k, v, do, lse, delta, psched),
        "sdpa": sdpa_bwd}, 10)
    fturns = _in_turns({"fwd": lambda: K.packed_fwd(q, k, v, psched),
                        "sdpa": sdpa}, 10)
    ms = {"fwd": fturns["fwd"][0], "dq": bturns["dq"][0],
          "dkv": bturns["dkv"][0]}
    plain = {"fwd": _median_ms(lambda: SC.packed_fwd_torch(q, k, v, psched,
                                                           scale), 3, 1),
             "dq": _median_ms(lambda: SC.packed_dq_torch(
                 q, k, v, do, lse, delta, psched, scale), 3, 1),
             "dkv": _median_ms(lambda: SC.packed_dkv_torch(
                 q, k, v, do, lse, delta, psched, scale), 3, 1)}
    lib_fwd, lib_bwd = fturns["sdpa"][0], bturns["sdpa"][0]
    # the kernels' own time on the device (the wrappers' host work, which
    # the event timings above include once it outlasts the kernel, left out)
    device = {
        "fwd": _device_ms(lambda: [K.packed_fwd(q, k, v, psched)
                                   for _ in range(20)], 20, "packed_fwd"),
        "dq": _device_ms(lambda: [K.packed_bwd_dq(q, k, v, do, lse, delta,
                                                  psched)
                                  for _ in range(20)], 20, "packed_bwd_dq"),
        "dkv": _device_ms(lambda: [K.packed_bwd_dkv(q, k, v, do, lse, delta,
                                                    psched)
                                   for _ in range(20)], 20, "packed_bwd_dkv")}
    pairs = h * int(mask.sum())  # unmasked (query, key) pairs
    bounds = RF.attn_bounds(q, k, pairs)
    shape = {"B": 1, "H": h, "Hkv": hkv, "D": d, "blk": blk, "docs":
             list(TRAIN_DOCS), "member_lens": lens, "S": s, "kind": "ltm",
             "steps": psched.steps, "pairs": pairs}
    lib = ("SDPA backward through autograd with the block-diagonal causal "
           "mask (dq, dk and dv together: no PyTorch call computes one "
           "alone)")
    rows = [{"name": f"tri_attn.packed_bwd_{key}", "route": "cuda",
             "source": "src/repro_torch/csrc/packed_bwd.cu",
             "replaces": "src/repro/kernels/tri_attn/kernel.py:549",
             "max_abs_err": err, "ms": ms[key], "plain_ms": plain[key],
             "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
             "library_ms": lib_bwd, "library": lib, "shape": shape,
             "path": K.tile_body(dt, blk, "bwd"),
             "bound_share": bounds[key][0] / ms[key],
             "ms_turns": bturns[key][1], "device_ms": device[key],
             "library_ms_turns": bturns["sdpa"][1],
             "library_max_abs_err": lib_err[key],
             "grid": list(K.packed_bwd_grid(key, psched,
                                            h if key == "dq" else hkv, 1,
                                            dt))}
            for key, err in zip(("dq", "dkv"), errs[1:])]
    fwd_path = K.tile_body(dt, blk, BODY_DIR["packed_fwd_tc_kernel"][1])
    print("packed train kernels: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} ms ({r['path']}, grid {r['grid']}) in "
        f"turns {r['ms_turns']}, on the device {r['device_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({100 * r['bound_share']:.1f}%), "
        f"err vs plain {r['max_abs_err']:.3g}" for r in rows)
        + f"; SDPA backward with the block mask (dq, dk, dv) {lib_bwd:.4f} "
        f"ms in turns {bturns['sdpa'][1]}, err vs plain dq "
        f"{lib_err['dq']:.3g}, dk/dv {lib_err['dkv']:.3g}; dq + dk/dv "
        f"{ms['dq'] + ms['dkv']:.4f} ms; packed_fwd {ms['fwd']:.4f} ms "
        f"({fwd_path}) in turns {fturns['fwd'][1]}, on "
        f"the device {device['fwd']:.4f} ms, bound {bounds['fwd'][0]:.6f} ms "
        f"({100 * bounds['fwd'][0] / device['fwd']:.1f}% on the device), "
        f"SDPA with the block mask {lib_fwd:.4f} ms in turns "
        f"{fturns['sdpa'][1]}", flush=True)
    fwd_reading = {"max_abs_err": errs[0], "ms": ms["fwd"],
                   "plain_ms": plain["fwd"], "bound_ms": bounds["fwd"][0],
                   "bound_by": bounds["fwd"][1], "library_ms": lib_fwd,
                   "library": "SDPA forward with the block-diagonal causal "
                              "mask", "shape": shape,
                   "path": fwd_path,
                   "device_ms": device["fwd"], "ms_turns": fturns["fwd"][1],
                   "library_ms_turns": fturns["sdpa"][1]}
    return rows, fwd_reading


# EDM tolerances of tests/oracles.py (edm, edm_sq; bf16 edm): sqrt
# amplifies the f32 roundoff of d^2 ~ 0 (a + b - 2ab)
EDM_TOL = {(torch.float32, False): dict(atol=2e-3, rtol=1e-4),
           (torch.float32, True): dict(atol=1e-5, rtol=1e-5),
           (torch.bfloat16, False): dict(atol=5e-2, rtol=5e-2)}
# the paper's measured BB / LTM time ratio of its EDM on Kepler
PAPER_I_KEPLER = (1.12, 1.15)
# the paper's experiment: pairwise distances of N points in d = 1..4
# features at blk 64, and the op's default blk 128 at N = 65536, d = 3
EDM_SWEEP = tuple((n_rows, d, 64) for n_rows in (16384, 32768, 65536)
                  for d in (1, 2, 3, 4)) + ((65536, 3, 128),)
EDM_HEADLINE = (65536, 3, 64)
EDM_FULL_ROWS = 16384  # checked in full against the plain version
EDM_SAMPLE = 4096  # tiles sampled at the largest N
DUMMY_NS = (1024, 4096)  # besides the envelope's last row
# the train phase's attention (B, H, Hkv, S, D, blk)
ATTN_SHAPE = (1, 32, 4, 4096, 128, 64)
PAPER_REPS, PAPER_WARMUP = 5, 1


def _isqrt64(x):
    """Exact floor(sqrt(x)) of an int64 tensor below 2^52: the float64
    candidate, corrected one step each way."""
    r = torch.sqrt(x.double()).floor().long()
    r = torch.where(r * r > x, r - 1, r)
    return torch.where((r + 1) * (r + 1) <= x, r + 1, r)


def _check_dummy(out, n: int):
    """dummy_ltm's output against the closed form i + j of every lambda,
    computed on the card in int64 in chunks; returns the lambdas
    checked."""
    t = n * (n + 1) // 2
    if tuple(out.shape) != (t, 1):
        _fail(f"dummy_ltm({n}): shape {tuple(out.shape)} != ({t}, 1)")
    step = 1 << 26
    for t0 in range(0, t, step):
        lam = torch.arange(t0, min(t, t0 + step), dtype=torch.int64,
                           device=out.device)
        i = (_isqrt64(8 * lam + 1) - 1) // 2
        j = lam - i * (i + 1) // 2
        bad = int((out[t0:t0 + step, 0] != (i + j).float()).sum())
        if bad:
            _fail(f"dummy_ltm({n}): {bad} of lambdas [{t0}, "
                  f"{t0 + len(lam)}) differ from i + j")
    return t


def _edm_close(name, got, want, tol):
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **tol):
        _fail(f"{name}: kernel disagrees with its plain version (max abs "
              f"err {err}, tolerance {tol})")
    return err


def _check_edm(EK, ER, x, blk, squared, sample: int, rng):
    """edm_ltm and edm_bb on x against the plain version: every tile when
    ``sample`` is 0, else a seeded sample of ``sample`` tiles plus every
    tile with an output element at or past offset 2^31 in either output.
    Also: BB's lower tiles equal LTM's bit for bit, BB's upper tiles and
    the diagonal self-distances are exact zeros. Returns the max abs
    error and the tiles checked against the plain version."""
    n_rows = x.shape[0]
    n = n_rows // blk
    t = n * (n + 1) // 2
    tol = EDM_TOL[(x.dtype, squared)]
    ltm = EK.edm_ltm(x, blk, squared=squared)
    bb = EK.edm_bb(x, blk, squared=squared)
    torch.cuda.synchronize()
    ii, jj = ER.tile_coords(n, x.device)
    bb_tiles = bb.view(n, blk, n, blk)
    step = max(1, (1 << 26) // (blk * blk))
    for t0 in range(0, t, step):
        sl = slice(t0, t0 + step)
        if not torch.equal(ltm[sl], bb_tiles[ii[sl], :, jj[sl], :]):
            _fail(f"edm N={n_rows} blk={blk}: BB's lower tiles differ from "
                  f"LTM's in lambdas [{t0}, {t0 + step})")
    rows = torch.arange(blk, device=x.device)
    for r0 in range(0, n_rows, blk * 64):  # 64 tile rows at a time
        band = bb[r0:r0 + blk * 64]
        tile_i = (r0 + torch.arange(band.shape[0], device=x.device)) // blk
        upper = (torch.arange(n_rows, device=x.device) // blk)[None, :] > \
            tile_i[:, None]
        if bool(((band != 0) & upper).any()):
            _fail(f"edm_bb N={n_rows} blk={blk}: nonzero upper tiles")
    diag = torch.tensor([i * (i + 1) // 2 + i for i in range(n)],
                        device=x.device)
    if int(torch.count_nonzero(ltm[diag][:, rows, rows])):
        _fail(f"edm N={n_rows} blk={blk}: nonzero self-distance")
    if sample:
        two31 = 2 ** 31
        # LTM tile lambda ends at (lambda + 1) b^2 - 1; BB tile (i, j) at
        # ((i + 1) b - 1) N + (j + 1) b - 1
        far = ((torch.arange(t, device=x.device) + 1) * blk * blk - 1
               >= two31) | (((ii + 1) * blk - 1) * n_rows + (jj + 1) * blk
                            - 1 >= two31)
        pick = torch.as_tensor(rng.choice(t, min(sample, t), replace=False),
                               device=x.device)
        far[pick] = True
        lams = torch.nonzero(far)[:, 0]
    else:
        lams = torch.arange(t, device=x.device)
        _edm_close(f"edm_bb N={n_rows} d={x.shape[1]}", bb,
                   EK.edm_bb_torch(x, blk, squared=squared), tol)
    err = 0.0
    for t0 in range(0, len(lams), step):
        lam = lams[t0:t0 + step]
        want = EK.edm_tiles(x, blk, ii[lam], jj[lam], squared=squared)
        err = max(err, _edm_close(f"edm_ltm N={n_rows} d={x.shape[1]}",
                                  ltm[lam], want, tol))
    return err, len(lams)


def _empty_blocks_ms(blocks: int) -> float:
    """CUDA-event median of tri_edm.cu's empty_blocks_launch: ``blocks``
    empty one-warp blocks on a 1-D grid, the dummy kernels' geometry
    without their work, so the floor of a kernel of one block a lambda
    (a yardstick that no path of the port runs)."""
    from repro_torch.kernels.tri_edm import kernel as EK

    return _median_ms(lambda: EK.empty_blocks(blocks, device="cuda"),
                      PAPER_REPS, PAPER_WARMUP)


def paper_phase(dev, K, OPS, SC):
    """The paper's experiment on the card: dummy_ltm (the mapping alone),
    the EDM by g(lambda) (edm_ltm) against the bounding box (edm_bb), and
    the BB attention forward (fwd_bb) against tri_fwd. Checks each kernel
    against its plain version, times the plain versions and the library
    calls, then drives the experiment through the entry points (ops.edm,
    dummy_ltm, triangular_attention) with every count at 0 before and
    read after. Returns the four kernels' rows."""
    import torch.nn.functional as F

    from repro_torch.core import mapping as M
    from repro_torch.kernels.tri_edm import kernel as EK
    from repro_torch.kernels.tri_edm import ops as EOPS
    from repro_torch.kernels.tri_edm import ref as ER
    from repro_torch.obs import launch as OBS
    from repro_torch.obs import metrics as MET

    rng = np.random.default_rng(15)

    def points(n_rows, d, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal((n_rows, d), np.float32),
                               device=dev).to(dtype)

    # -- dummy_ltm over the whole certified envelope -----------------------
    n_env = M.LTM_TRACED_MAX_I
    checked = _check_dummy(EK.dummy_ltm(n_env, device=dev), n_env)
    for n in DUMMY_NS:
        _check_dummy(EK.dummy_ltm(n, device=dev), n)
    if not torch.equal(EK.dummy_ltm(DUMMY_NS[0], device=dev),
                       EK.dummy_ltm_torch(DUMMY_NS[0], dev)):
        _fail("dummy_ltm disagrees with its plain version")
    print(f"paper: dummy_ltm at n = {n_env} equals i + j for all {checked} "
          f"lambdas (int64 closed form on the card)", flush=True)

    # -- EDM correctness ----------------------------------------------------
    edm_err = {"tri_edm.ltm": 0.0}
    for d in (1, 2, 3, 4):
        err, _ = _check_edm(EK, ER, points(EDM_FULL_ROWS, d), 64, False, 0,
                            rng)
        edm_err["tri_edm.ltm"] = max(edm_err["tri_edm.ltm"], err)
    x = points(EDM_FULL_ROWS, 3)
    _check_edm(EK, ER, x, 64, True, 0, rng)
    _check_edm(EK, ER, x.to(torch.bfloat16), 64, False, 0, rng)
    big = [c for c in EDM_SWEEP if c[0] == EDM_HEADLINE[0]]
    for n_rows, d, blk in big:
        err, count = _check_edm(EK, ER, points(n_rows, d), blk, False,
                                EDM_SAMPLE, rng)
        edm_err["tri_edm.ltm"] = max(edm_err["tri_edm.ltm"], err)
        print(f"paper: edm N={n_rows} d={d} blk={blk}: {count} tiles "
              f"against the plain version ({EDM_SAMPLE} sampled + every "
              f"tile past offset 2^31), BB lower == LTM bitwise, zeros "
              f"exact; max "
              f"abs err {err:.3g}", flush=True)
    torch.cuda.empty_cache()

    # -- fwd_bb correctness at the train phase's attention shape ------------
    def qkv(b, h, hkv, s, d):
        return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                                device=dev).to(torch.bfloat16)
                for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]

    attn_err = 0.0
    for blk in (16, 32, 64, 128):  # both bf16 bodies: mma.sync, wgmma
        for window in (blk + 5, 3):  # band, band_short
            sched = OPS.make_sched(6 * blk, block=blk, window=window)
            q, k, v = qkv(2, 8, 2, 6 * blk, 128)
            out, lse = K.fwd_bb(q, k, v, sched)
            again = K.fwd_bb(q, k, v, sched)
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                    and bool(torch.isfinite(out.float()).all())):
                _fail(f"fwd_bb window {window} blk {blk}: two runs differ "
                      f"or non-finite")
            for label, (w_out, w_lse) in (
                    ("plain", SC.fwd_bb_torch(q, k, v, sched, 128 ** -0.5)),
                    ("tri_fwd", K.fwd(q, k, v, sched))):
                _close(f"fwd_bb window {window} blk {blk} vs {label} out",
                       out, w_out)
                _close(f"fwd_bb window {window} blk {blk} vs {label} lse",
                       lse, w_lse, LSE_TOL)
    b, h, hkv, s, d, blk = ATTN_SHAPE
    q, k, v = qkv(b, h, hkv, s, d)
    sched = OPS.make_sched(s, block=blk)
    scale = d ** -0.5
    n_attn = sched.n
    reg = MET.Registry("fwd_bb")
    with MET.scope(reg):
        out, lse = K.fwd_bb(q, k, v, sched)
    again = K.fwd_bb(q, k, v, sched)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        _fail("fwd_bb: two runs differ")
    summ = OBS.kernel_summary(reg)["tri_attn.fwd_bb"]
    if (summ["launches"], summ["tiles_launched"], summ["tiles_domain"]) != \
            (1, n_attn * n_attn * b * h, M.tri(n_attn) * b * h):
        _fail(f"fwd_bb counters {summ}")
    w_out, w_lse = SC.fwd_bb_torch(q, k, v, sched, scale)
    f_out, f_lse = K.fwd(q, k, v, sched)
    attn_err = max(_close("fwd_bb out", out, w_out),
                   _close("fwd_bb lse", lse, w_lse, LSE_TOL),
                   _close("fwd_bb vs tri_fwd out", out, f_out),
                   _close("fwd_bb vs tri_fwd lse", lse, f_lse, LSE_TOL))
    del again, w_out, w_lse, f_out, f_lse
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    _close("fwd_bb vs SDPA", out, sdpa())
    print(f"paper: fwd_bb at B {b} H {h} Hkv {hkv} S {s} D {d} blk {blk} "
          f"matches fwd_bb_torch and tri_fwd (max abs err {attn_err:.3g}), "
          f"two runs bitwise equal, counters {summ['tiles_launched']} "
          f"launched / {summ['tiles_domain']} in the domain", flush=True)

    # -- plain versions and library calls (outside the counted path) --------
    n_rows, d_h, blk_h = EDM_HEADLINE
    x = points(n_rows, d_h)
    plain = {
        "tri_edm.ltm": _median_ms(lambda: EK.edm_ltm_torch(x, blk_h), 1, 1),
        "tri_edm.bb": _median_ms(lambda: EK.edm_bb_torch(x, blk_h), 1, 1),
        "tri_edm.dummy_ltm": _median_ms(
            lambda: EK.dummy_ltm_torch(n_env, dev), 3, 1),
        "tri_attn.fwd_bb": _median_ms(
            lambda: SC.fwd_bb_torch(q, k, v, sched, scale), 3, 1)}
    cdist = _median_ms(lambda: torch.cdist(x, x), 5, 1)
    turns = _in_turns({"fwd_bb": lambda: K.fwd_bb(q, k, v, sched),
                       "tri_fwd": lambda: K.fwd(q, k, v, sched),
                       "sdpa": sdpa}, 10)
    library = {"tri_edm.ltm": cdist, "tri_edm.bb": cdist,
               "tri_edm.dummy_ltm": None,
               "tri_attn.fwd_bb": turns["sdpa"][0]}
    del x
    torch.cuda.empty_cache()

    # -- the experiment, through the entry points, counted ------------------
    for mod in (K, EK):
        _reset_launches(mod)
    reg = MET.Registry("paper")
    sweep, per = [], PAPER_REPS + PAPER_WARMUP
    with MET.scope(reg), torch.no_grad():
        for e_rows, e_d, e_blk in EDM_SWEEP:
            x = points(e_rows, e_d)
            cfg_reg = MET.Registry("edm config")
            with MET.scope(cfg_reg):
                t_ltm = _median_ms(lambda: EOPS.edm(x, e_blk, impl="cuda"),
                                   PAPER_REPS, PAPER_WARMUP)
                t_bb = _median_ms(lambda: EOPS.edm(x, e_blk, impl="bb"),
                                  PAPER_REPS, PAPER_WARMUP)
            sweep.append({
                "N": e_rows, "d": e_d, "blk": e_blk, "ltm_ms": t_ltm,
                "bb_ms": t_bb, "I_edm": t_bb / t_ltm,
                "I_struct": OBS.kernel_summary(cfg_reg)["tri_edm.ltm"][
                    "improvement_vs_bb"],
                "ltm_bound_ms": RF.bound(*RF.edm_work(
                    "ltm", e_rows, e_d, e_blk), torch.float32)[0],
                "bb_bound_ms": RF.bound(*RF.edm_work(
                    "bb", e_rows, e_d, e_blk), torch.float32)[0]})
            del x
        dummy_ms = {n: _median_ms(lambda: EK.dummy_ltm(n, device=dev),
                                  PAPER_REPS, PAPER_WARMUP)
                    for n in DUMMY_NS + (n_env,)}
        dispatch_ms = _empty_blocks_ms(M.tri(n_env))
        attn_ms = {impl: _median_ms(
            lambda: OPS.triangular_attention(q, k, v, impl=impl, block=blk),
            PAPER_REPS, PAPER_WARMUP) for impl in ("bb", "cuda")}
    launches = {**_launches(EK), **_launches(K)}
    want = {"tri_edm.ltm": per * len(EDM_SWEEP),
            "tri_edm.bb": per * len(EDM_SWEEP),
            "tri_edm.dummy_ltm": per * (len(DUMMY_NS) + 1),
            "tri_attn.fwd_bb": per, "tri_attn.fwd": per}
    for mod in (EK, K):
        _check_launches("paper", mod, reg, {
            name: c for name, c in want.items() if name in mod.WRAPPERS})
    torch.cuda.empty_cache()

    i_attn = attn_ms["bb"] / attn_ms["cuda"]
    # the partials' round trip, which tri_fwd does not pay: written once,
    # read once, B H tri(n) (blk D + 2 blk) f32
    part_floor = 2 * 4 * b * h * M.tri(n_attn) * (blk * d + 2 * blk) \
        / RF.HBM_BYTES_PER_S * 1e3
    for row in sweep:
        print(f"paper: edm N={row['N']} d={row['d']} blk={row['blk']}: LTM "
              f"{row['ltm_ms']:.4f} ms (bound {row['ltm_bound_ms']:.4f}), "
              f"BB {row['bb_ms']:.4f} ms (bound {row['bb_bound_ms']:.4f}); "
              f"I_edm {row['I_edm']:.4f} (structural n^2/tri(n) "
              f"{row['I_struct']:.4f}; the paper on Kepler "
              f"{PAPER_I_KEPLER[0]}-{PAPER_I_KEPLER[1]})", flush=True)
    for n, ms in dummy_ms.items():
        print(f"paper: dummy_ltm n={n}: {ms:.4f} ms, "
              f"{ms * 1e6 / M.tri(n):.4f} ns a block", flush=True)
    print(f"paper: block dispatch (empty one-warp blocks on dummy_ltm's grid "
          f"of {M.tri(n_env)}): {dispatch_ms:.4f} ms, "
          f"{dispatch_ms * 1e6 / M.tri(n_env):.4f} ns a block; dummy_ltm at "
          f"{dispatch_ms / dummy_ms[n_env]:.1%} of it", flush=True)
    print(f"paper: attention at B {b} H {h} S {s} blk {blk}: fwd_bb "
          f"{attn_ms['bb']:.4f} ms, tri_fwd {attn_ms['cuda']:.4f} ms, I_attn "
          f"{i_attn:.4f} (structural "
          f"{n_attn * n_attn / M.tri(n_attn):.4f}); the partials' floor "
          f"{part_floor:.4f} ms, (t_fwd_bb - floor) / t_tri_fwd "
          f"{(attn_ms['bb'] - part_floor) / attn_ms['cuda']:.4f}; in turns "
          f"fwd_bb {turns['fwd_bb'][1]}, tri_fwd {turns['tri_fwd'][1]}, SDPA "
          f"{turns['sdpa'][1]} ms ({K.tile_body(q.dtype, blk)})", flush=True)

    head = next(r for r in sweep if (r["N"], r["d"], r["blk"]) == EDM_HEADLINE)
    shape = {"N": EDM_HEADLINE[0], "d": EDM_HEADLINE[1],
             "blk": EDM_HEADLINE[2], "dtype": "float32"}
    lib_edm = ("torch.cdist(x, x): the full N x N f32 matrix (no PyTorch "
               "call gives the packed output)")
    bounds = {
        "tri_edm.ltm": RF.bound(*RF.edm_work("ltm", *EDM_HEADLINE),
                                torch.float32),
        "tri_edm.bb": RF.bound(*RF.edm_work("bb", *EDM_HEADLINE),
                               torch.float32),
        "tri_edm.dummy_ltm": RF.bound(*RF.dummy_work(M.tri(n_env)),
                                      torch.float32),
        "tri_attn.fwd_bb": RF.attn_bounds(q, k, h * s * (s + 1) // 2)["fwd"]}
    rows = [
        {"name": "tri_edm.ltm", "source": "src/repro_torch/csrc/tri_edm.cu",
         "replaces": "src/repro/kernels/tri_edm/kernel.py:50",
         "max_abs_err": edm_err["tri_edm.ltm"], "ms": head["ltm_ms"],
         "library": lib_edm, "shape": shape, "sweep": sweep},
        {"name": "tri_edm.bb", "source": "src/repro_torch/csrc/tri_edm.cu",
         "replaces": "src/repro/kernels/tri_edm/kernel.py:90",
         "max_abs_err": edm_err["tri_edm.ltm"], "ms": head["bb_ms"],
         "library": lib_edm, "shape": shape, "I_edm": head["I_edm"],
         "I_struct": head["I_struct"]},
        {"name": "tri_edm.dummy_ltm",
         "source": "src/repro_torch/csrc/tri_edm.cu",
         "replaces": "src/repro/kernels/tri_edm/kernel.py:117",
         "max_abs_err": 0.0, "ms": dummy_ms[n_env],
         "library": None, "shape": {"n": n_env, "blocks": M.tri(n_env)},
         "ms_by_n": {str(n): ms for n, ms in dummy_ms.items()},
         "ns_per_block": dummy_ms[n_env] * 1e6 / M.tri(n_env),
         "bound_dispatch_ms": dispatch_ms},
        {"name": "tri_attn.fwd_bb", "source": "src/repro_torch/csrc/fwd_bb.cu",
         "replaces": "src/repro/kernels/tri_attn/kernel.py:1205",
         "max_abs_err": attn_err, "ms": attn_ms["bb"],
         "library": "SDPA is_causal forward",
         "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d, "blk": blk,
                   "kind": "ltm"},
         "tri_fwd_ms": attn_ms["cuda"], "I_attn": i_attn,
         "path": K.tile_body(q.dtype, blk), "partials_floor_ms": part_floor,
         "I_attn_less_floor": (attn_ms["bb"] - part_floor) / attn_ms["cuda"],
         "ms_turns": turns["fwd_bb"][1],
         "tri_fwd_ms_turns": turns["tri_fwd"][1],
         "library_ms_turns": turns["sdpa"][1]}]
    for row in rows:
        name = row["name"]
        row.update(route="cuda", plain_ms=plain[name],
                   bound_ms=bounds[name][0], bound_by=bounds[name][1],
                   library_ms=library[name], launches=launches[name])
    rows[-1]["bound_share"] = rows[-1]["bound_ms"] / rows[-1]["ms"]
    return rows


# the 3-body cells (N, d, blk): the five shapes of the prediction
TB_SHAPES = ((8192, 3, 128), (8192, 64, 128), (16384, 3, 128),
             (16384, 64, 128), (8192, 3, 64))
TB_HEADLINE = (16384, 3, 128)
TB_DUMMY_N = 128  # the tet grid of the headline, besides the envelope's
# a tile's sum may differ from the plain version's by rounding only: at
# most 2 (b + d) float32 units (2^-24) of its sum(|(A B) * C|)
U32 = 2.0 ** -24


def _tb_ulps(blk: int, d: int) -> int:
    return 2 * (blk + d)


def _tet64(i):
    return i * (i + 1) * (i + 2) // 6


def _check_dummy_tet(out, n: int):
    """dummy_tet's output against the closed form i + j + k of every
    lambda, in int64 on the card in chunks (the plane by the float64 cube
    root of 6 lambda, corrected one step each way); returns the lambdas
    checked."""
    t = _tet64(n)
    if tuple(out.shape) != (t, 1):
        _fail(f"dummy_tet({n}): shape {tuple(out.shape)} != ({t}, 1)")
    step = 1 << 26
    for t0 in range(0, t, step):
        lam = torch.arange(t0, min(t, t0 + step), dtype=torch.int64,
                           device=out.device)
        i = torch.pow((6 * lam).double(), 1.0 / 3.0).floor().long()
        i = torch.where(_tet64(i + 1) <= lam, i + 1, i)
        i = torch.where(_tet64(i) > lam, i - 1, i)
        mu = lam - _tet64(i)
        j = (_isqrt64(8 * mu + 1) - 1) // 2
        k = mu - j * (j + 1) // 2
        bad = int((out[t0:t0 + step, 0] != (i + j + k).float()).sum())
        if bad:
            _fail(f"dummy_tet({n}): {bad} of lambdas [{t0}, "
                  f"{t0 + len(lam)}) differ from i + j + k")
    return t


def _check_three_body(TK, TR, x, blk, strict):
    """three_body_tet and three_body_bb3 on x against the plain version:
    every tile within _tb_ulps of its scale; bb3's simplex cells equal
    tet's bit for bit and every other cell exactly 0; a second run of
    each bitwise equal. Returns (max abs err, max err in units of
    u * sum|(A B) * C|)."""
    n = x.shape[0] // blk
    label = f"3body N={x.shape[0]} d={x.shape[1]} blk={blk} strict={strict}"
    tet = TK.three_body_tet(x, blk, strict=strict)
    cube = TK.three_body_bb3(x, blk, strict=strict)
    torch.cuda.synchronize()
    if not (torch.equal(TK.three_body_tet(x, blk, strict=strict), tet)
            and torch.equal(TK.three_body_bb3(x, blk, strict=strict),
                            cube)):
        _fail(f"{label}: two runs differ")
    i, j, k = TR.tet_coords(n, x.device).unbind(1)
    if not torch.equal(cube[i, j, k], tet[:, 0]):
        _fail(f"{label}: bb3's simplex cells differ from tet's")
    cube[i, j, k] = 0.0
    if int(torch.count_nonzero(cube)):
        _fail(f"{label}: bb3 has nonzero cells outside the simplex")
    del cube
    err = ulps = 0.0
    step = max(1, TR.CHUNK_ELEMS // (blk * blk))
    for t0 in range(0, len(i), step):
        sl = slice(t0, t0 + step)
        want, scale = TK.triplet_tiles(x, blk, i[sl], j[sl], k[sl],
                                       strict=strict, with_abs=True)
        diff = (tet[sl, 0] - want).abs()
        err = max(err, float(diff.max()))
        ulps = max(ulps, float((diff / (U32 * scale.clamp_min(1e-30)))
                               .max()))
    if ulps > _tb_ulps(blk, x.shape[1]):
        _fail(f"{label}: a tile differs from the plain version by "
              f"{ulps:.3g} units of u * sum|(AB)*C| (limit "
              f"{_tb_ulps(blk, x.shape[1])})")
    return err, ulps


def three_body_phase(dev):
    """The 3-body workload on the card: dummy_tet over the whole certified
    tet_map envelope; three_body_tet and three_body_bb3 against their
    plain versions at the five cells and strict at the headline; the plain
    versions and the library einsum timed; then the workload through the
    entry points (ops.three_body, ops.three_body_total, dummy_tet) with
    every count at 0 before and read after. Returns the three kernels'
    rows."""
    from repro_torch.core import mapping as M
    from repro_torch.kernels.tri_3body import kernel as TK
    from repro_torch.kernels.tri_3body import ops as TOPS
    from repro_torch.kernels.tri_3body import ref as TR
    from repro_torch.obs import metrics as MET

    rng = np.random.default_rng(16)

    def points(n_rows, d):
        return torch.as_tensor(rng.standard_normal((n_rows, d), np.float32),
                               device=dev)

    # -- dummy_tet over the whole certified envelope -----------------------
    n_env = M.TET_TRACED_MAX_I
    checked = _check_dummy_tet(TK.dummy_tet(n_env, device=dev), n_env)
    if not torch.equal(TK.dummy_tet(TB_DUMMY_N, device=dev),
                       TK.dummy_tet_torch(TB_DUMMY_N, dev)):
        _fail("dummy_tet disagrees with its plain version")
    print(f"3body: dummy_tet at n = {n_env} equals i + j + k for all "
          f"{checked} lambdas (int64 closed form on the card)", flush=True)
    torch.cuda.empty_cache()

    # -- correctness at every cell, strict at the headline ------------------
    err = ulps = 0.0
    for n_rows, d, blk, strict in tuple(s + (False,) for s in TB_SHAPES) \
            + (TB_HEADLINE + (True,),):
        e, u = _check_three_body(TK, TR, points(n_rows, d), blk, strict)
        err, ulps = max(err, e), max(ulps, u)
        print(f"3body: N={n_rows} d={d} blk={blk} strict={strict}: every "
              f"tile against the plain version (max abs err {e:.4g}, "
              f"{u:.3f} units of u * sum|(AB)*C|, limit "
              f"{_tb_ulps(blk, d)}), bb3 simplex == tet bitwise, zeros "
              f"exact, two runs bitwise equal", flush=True)
    torch.cuda.empty_cache()

    # -- plain versions and the library call (outside the counted path) -----
    n_rows, d_h, blk_h = TB_HEADLINE
    x = points(n_rows, d_h)
    plain = {
        "tri_3body.tet": _median_ms(
            lambda: TK.three_body_tet_torch(x, blk_h), 1, 1),
        "tri_3body.bb3": _median_ms(
            lambda: TK.three_body_bb3_torch(x, blk_h), 1, 1),
        "tri_3body.dummy_tet": _median_ms(
            lambda: TK.dummy_tet_torch(n_env, dev), 1, 1)}
    torch.cuda.empty_cache()
    g = TR.gram(x)
    with TR.full_f32():
        einsum = _median_ms(lambda: torch.einsum("ab,bc,ac->", g, g, g), 3, 1)
    del g, x
    torch.cuda.empty_cache()

    # -- the workload, through the entry points, counted --------------------
    _reset_launches(TK)
    reg = MET.Registry("3body")
    per = PAPER_REPS + PAPER_WARMUP
    cells = []
    with MET.scope(reg), torch.no_grad():
        for c_rows, c_d, c_blk in TB_SHAPES:
            x = points(c_rows, c_d)
            t_tet = _median_ms(lambda: TOPS.three_body(x, c_blk, impl="cuda"),
                               PAPER_REPS, PAPER_WARMUP)
            t_bb3 = _median_ms(lambda: TOPS.three_body(x, c_blk, impl="bb3"),
                               PAPER_REPS, PAPER_WARMUP)
            n = c_rows // c_blk
            flops = RF.three_body_flops(c_rows, c_d, c_blk)
            cells.append({
                "N": c_rows, "d": c_d, "blk": c_blk, "tet_ms": t_tet,
                "bb3_ms": t_bb3, "I_3body": t_bb3 / t_tet,
                "I_struct": n ** 3 / M.tet(n),
                "tet_bound_ms": RF.bound(*RF.three_body_work(
                    "tet", c_rows, c_d, c_blk), torch.float32)[0],
                "bb3_bound_ms": RF.bound(*RF.three_body_work(
                    "bb3", c_rows, c_d, c_blk), torch.float32)[0],
                "tet_tflops": flops / t_tet / 1e9})
            del x
        x = points(n_rows, d_h)
        totals = {impl: _median_ms(lambda: TOPS.three_body_total(
            x, blk_h, impl=impl), PAPER_REPS, PAPER_WARMUP)
            for impl in ("cuda", "bb3")}
        dummy_ms = {n: _median_ms(lambda: TK.dummy_tet(n, device=dev),
                                  PAPER_REPS, PAPER_WARMUP)
                    for n in (TB_DUMMY_N, n_env)}
        dispatch_ms = _empty_blocks_ms(M.tet(n_env))
    _check_launches("3body", TK, reg, {
        "tri_3body.tet": per * (len(TB_SHAPES) + 1),
        "tri_3body.bb3": per * (len(TB_SHAPES) + 1),
        "tri_3body.dummy_tet": per * 2})
    launches = dict(_launches(TK))
    torch.cuda.empty_cache()

    for c in cells:
        print(f"3body: N={c['N']} d={c['d']} blk={c['blk']}: tet "
              f"{c['tet_ms']:.4f} ms (bound {c['tet_bound_ms']:.4f}, "
              f"{c['tet_tflops']:.2f} TFLOP/s), bb3 {c['bb3_ms']:.4f} ms "
              f"(bound {c['bb3_bound_ms']:.4f}); I_3body "
              f"{c['I_3body']:.4f} (structural n^3/tet(n) "
              f"{c['I_struct']:.4f})", flush=True)
    for n, ms in dummy_ms.items():
        print(f"3body: dummy_tet n={n}: {ms:.4f} ms, "
              f"{ms * 1e6 / M.tet(n):.4f} ns a block", flush=True)
    print(f"3body: block dispatch (empty one-warp blocks on dummy_tet's grid "
          f"of {M.tet(n_env)}): {dispatch_ms:.4f} ms, "
          f"{dispatch_ms * 1e6 / M.tet(n_env):.4f} ns a block; dummy_tet at "
          f"{dispatch_ms / dummy_ms[n_env]:.1%} of it", flush=True)
    print(f"3body: three_body_total at N={n_rows} d={d_h} blk={blk_h}: "
          f"cuda {totals['cuda']:.4f} ms, bb3 {totals['bb3']:.4f} ms; "
          f"library einsum over the N^3 ordered triples {einsum:.4f} ms",
          flush=True)

    head = next(c for c in cells if (c["N"], c["d"], c["blk"]) == TB_HEADLINE)
    shape = {"N": n_rows, "d": d_h, "blk": blk_h, "dtype": "float32"}
    lib = ("torch.einsum('ab,bc,ac->', G, G, G) on the f32 Gram matrix, TF32 "
           "off: the total over all N^3 ordered triples (no PyTorch call "
           "gives the packed per-tile output)")
    bounds = {
        "tri_3body.tet": RF.bound(*RF.three_body_work("tet", *TB_HEADLINE),
                                  torch.float32),
        "tri_3body.bb3": RF.bound(*RF.three_body_work("bb3", *TB_HEADLINE),
                                  torch.float32),
        "tri_3body.dummy_tet": RF.bound(*RF.dummy_work(M.tet(n_env)),
                                        torch.float32)}
    rows = [
        {"name": "tri_3body.tet", "source": "src/repro_torch/csrc/tri_3body.cu",
         "replaces": "src/repro/kernels/tri_3body/kernel.py:82",
         "max_abs_err": err, "max_err_ulps_of_scale": ulps,
         "ms": head["tet_ms"], "library_ms": einsum, "library": lib,
         "shape": shape, "cells": cells,
         "total_ms": totals["cuda"]},
        {"name": "tri_3body.bb3", "source": "src/repro_torch/csrc/tri_3body.cu",
         "replaces": "src/repro/kernels/tri_3body/kernel.py:131",
         "max_abs_err": err, "ms": head["bb3_ms"], "library_ms": einsum,
         "library": lib, "shape": shape, "I_3body": head["I_3body"],
         "I_struct": head["I_struct"], "total_ms": totals["bb3"]},
        {"name": "tri_3body.dummy_tet",
         "source": "src/repro_torch/csrc/tri_3body.cu",
         "replaces": "src/repro/kernels/tri_3body/kernel.py:163",
         "max_abs_err": 0.0, "ms": dummy_ms[n_env], "library_ms": None,
         "library": None, "shape": {"n": n_env, "blocks": M.tet(n_env)},
         "ms_by_n": {str(n): ms for n, ms in dummy_ms.items()},
         "ns_per_block": dummy_ms[n_env] * 1e6 / M.tet(n_env),
         "bound_dispatch_ms": dispatch_ms}]
    for row in rows:
        name = row["name"]
        row.update(route="cuda", plain_ms=plain[name],
                   bound_ms=bounds[name][0], bound_by=bounds[name][1],
                   launches=launches[name])
    return rows


def prefix_phase(dev):
    """A prefix at least as long as its sequence on the card: tri_fwd and
    tri_bwd (dense, prefix 64 and 100 over 64 tokens) and packed_fwd and
    packed_bwd (members of 32 and 64 tokens, member prefix (48, 0)),
    forward and grads, against the plain versions and the oracle (f32,
    B 1, H 4, Hkv 2, D 16, blk 16; OUT tolerance 2e-5, grads atol 2e-4
    rtol 2e-3, the attn / attn_grad policy of tests/oracles.py)."""
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.kernels.tri_attn import ops as OPS

    rng = np.random.default_rng(100)
    tol_out, tol_grad = dict(atol=2e-5, rtol=2e-5), dict(atol=2e-4, rtol=2e-3)

    def run(s, call):
        q, k, v, do = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                                       device=dev)
                       for shape in ((1, 4, s, 16), (1, 2, s, 16),
                                     (1, 2, s, 16), (1, 4, s, 16)))
        res = {}
        for impl in ("cuda", "torch", "ref"):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = {n: f.launches for n, f in K.WRAPPERS.items()}
            out = call(leaves, impl)
            out.backward(do)
            moved = sum(f.launches - before[n] for n, f in K.WRAPPERS.items())
            if moved != (3 if impl == "cuda" else 0):
                _fail(f"prefix {impl}: {moved} kernel launches")
            res[impl] = (out.detach(),) + tuple(x.grad for x in leaves)
        err = 0.0
        for want in (res["torch"], res["ref"]):
            for idx, (got, w) in enumerate(zip(res["cuda"], want)):
                err = max(err, _close(f"prefix {'out dq dk dv'.split()[idx]}",
                                      got, w, tol_out if idx == 0
                                      else tol_grad))
        return err

    errs = [run(64, lambda t, impl, p=p: OPS.triangular_attention(
        *t, prefix=p, impl=impl, block=16)) for p in (64, 100)]
    psched = OPS.make_packed_sched([32, 64], block=16, prefix=[48, 0])
    errs.append(run(96, lambda t, impl: OPS.packed_prefill_attention(
        *t, psched, impl=impl)))
    print(f"prefix: a prefix past its sequence (dense 64 and 100 over 64 "
          f"tokens, packed member prefix 48 over 32): tri_fwd/tri_bwd and "
          f"packed_fwd/packed_bwd forward and grads match the plain "
          f"versions and the oracle (max abs err {max(errs):.3g})",
          flush=True)


RWKV_SHAPE = (4, 2048, 32, 64)  # the kernel at full width: B, L, H, hd
RWKV_PROMPTS = (4, 2048)  # offline serving: prompts x tokens
RWKV_NEW = 32  # tokens generate decodes after the prefill
RWKV_ENGINE = dict(slots=4, requests=8, lens=(16, 128), max_new=16)
# bf16 full-width logits of one token computed by two paths: the repo's
# bf16 policy (tests/oracles.py "attn" bf16), whose absolute part
# tests/test_torch_models.py scales by the largest logit where the two
# paths round their matmuls at other shapes through every layer
RWKV_LOGIT_TOL = dict(atol=2e-2, rtol=2e-2)
# the same invariant in float32 at full width: reassociation only
RWKV_F32_TOL = dict(atol=1e-3, rtol=1e-3)
WKV_REL = 1e-4  # f32 kernel against its plain version, relative


def _logit_tol(want) -> dict:
    """RWKV_LOGIT_TOL with its absolute part scaled by the largest logit
    (the bf16 policy of tests/test_torch_models.py)."""
    scale = max(1.0, float(want.float().abs().max()))
    return dict(RWKV_LOGIT_TOL, atol=RWKV_LOGIT_TOL["atol"] * scale)


# idle host time at each end of a profiler window: launches near its ends
# went missing from the trace
PROFILE_PAD_S = 0.2


def _device_ms(fn, count: int, kernel: str, windows: int = 3) -> float:
    """Device time of one launch of the kernel whose name holds ``kernel``,
    from torch.profiler windows over ``fn()`` (``count`` calls of its
    wrapper, one launch each), so the wrapper's host time stays out.
    Inside this script's runs on the H100 a window has recorded 0, 17 or
    18 of its launches (a lone window, all of them), and the sum over
    ``count`` then read low. So each window is padded with PROFILE_PAD_S
    of idle host time at both ends, and up to ``windows`` windows are
    opened until one records all ``count``; failing that, the device time is the mean
    over the launches of the fullest window (each recorded launch carries
    its own duration), and a line says so. Fails when no window recorded
    a launch, or one recorded more than ``count``."""
    from torch.profiler import ProfilerActivity, profile

    best = (0, 0.0)  # (launches, device us) of the fullest window
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        rows = [ev for ev in prof.key_averages()
                if kernel in ev.key and str(ev.device_type).endswith("CUDA")]
        launches = sum(ev.count for ev in rows)
        if launches > count:
            _fail(f"profiler: {launches} launches of {kernel} in a window "
                  f"of {count} calls: " + "; ".join(
                      f"{ev.key[:80]} x{ev.count}" for ev in rows))
        if launches > best[0]:
            best = (launches, sum(getattr(ev, "self_device_time_total",
                                          getattr(ev, "self_cuda_time_total",
                                                  0)) for ev in rows))
        if launches == count:
            break
    launches, us = best
    if launches == 0:
        _fail(f"profiler: {windows} windows of {count} calls recorded no "
              f"launch of {kernel}")
    if launches < count:
        print(f"profiler: the fullest of {windows} windows recorded "
              f"{launches} of {count} launches of {kernel}; its device time "
              f"is their mean", flush=True)
    return us / 1e3 / launches


def _wkv_close(name, got, want, rel=WKV_REL):
    """Within rel of the plain version's largest magnitude, elementwise
    (atol) and relative (rtol)."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=rel * scale,
                          rtol=rel):
        _fail(f"{name}: kernel disagrees with its plain version (max abs "
              f"err {err}, scale {scale}, relative tolerance {rel})")
    return err


def wkv_kernel_phase(dev):
    """wkv_scan.wkv at full rwkv6-1.6b width against its plain version
    (ref.py) on the card: f32, halves chained equal to the whole, an L = 1
    step with its state aliased (s0 = s_L), bf16 inputs; timed beside the
    plain version. No PyTorch call computes WKV6 (library: none)."""
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    b, l, h, hd = RWKV_SHAPE
    rng = np.random.default_rng(17)

    def rand(*shape):
        return torch.as_tensor(0.5 * rng.standard_normal(shape, np.float32),
                               device=dev)

    r, k, v = rand(b, l, h, hd), rand(b, l, h, hd), rand(b, l, h, hd)
    lw = -torch.exp(rand(b, l, h, hd))
    u, s0 = rand(h, hd), rand(b, h, hd, hd)
    with torch.no_grad():
        out, s_l = WK.wkv(r, k, v, lw, u, s0)
        want_o, want_s = WR.wkv_ref(r, k, v, lw, u, s0)
        err = max(_wkv_close("wkv f32 out", out, want_o),
                  _wkv_close("wkv f32 state", s_l, want_s))
        again = WK.wkv(r, k, v, lw, u, s0)
        counters = BUILD.arrival_counters(r, 1 + b * h)
        torch.cuda.synchronize()
        if not (torch.equal(again[0], out) and torch.equal(again[1], s_l)):
            _fail("wkv: two runs of the chunked walk differ")
        if int(counters.abs().sum()):
            _fail("wkv: a chain counter is left nonzero")
        del again, want_o
        m = l // 2
        o1, s1 = WK.wkv(r[:, :m].contiguous(), k[:, :m].contiguous(),
                        v[:, :m].contiguous(), lw[:, :m].contiguous(), u, s0)
        o2, s2 = WK.wkv(r[:, m:].contiguous(), k[:, m:].contiguous(),
                        v[:, m:].contiguous(), lw[:, m:].contiguous(), u, s1)
        _wkv_close("wkv halves", torch.cat([o1, o2], 1), out)
        _wkv_close("wkv halves state", s2, s_l)
        one = [t[:, :1].contiguous() for t in (r, k, v, lw)]
        cache = s0.clone()
        o, s = WK.wkv(*one, u, cache, state_out=cache)
        w_o, w_s = WR.wkv_ref(*one, u, s0)
        if s is not cache:
            _fail("wkv: state_out is not the aliased cache")
        _wkv_close("wkv L=1 aliased", o, w_o)
        _wkv_close("wkv L=1 aliased state", cache, w_s)
        bf = [t.bfloat16() for t in (r, k, v, lw)]
        o_bf, _ = WK.wkv(*bf, u, s0)
        w_bf, _ = WR.wkv_ref(*bf, u, s0)
        if o_bf.dtype != torch.bfloat16:
            _fail(f"wkv bf16: output dtype {o_bf.dtype}")
        err_bf = _close("wkv bf16", o_bf, w_bf.bfloat16(),
                        dict(atol=2e-2, rtol=2e-2))
        torch.cuda.synchronize()
        ms = _median_ms(lambda: WK.wkv(r, k, v, lw, u, s0), 20)
        ms_bf16 = _median_ms(lambda: WK.wkv(*bf, u, s0), 20)
        ms_step = _median_ms(lambda: WK.wkv(*one, u, cache, state_out=cache),
                             50)
        dev_step = _device_ms(lambda: [WK.wkv(*one, u, cache, state_out=cache)
                                       for _ in range(50)], 50,
                              "wkv_walk_kernel")
        dev_ms = _device_ms(lambda: [WK.wkv(r, k, v, lw, u, s0)
                                     for _ in range(5)], 5, "wkv_kernel")
        plain_ms = _median_ms(lambda: WK.wkv_torch(r, k, v, lw, u, s0), 3, 1)
    n = b * l * h * hd
    bound = RF.bound(*RF.wkv_work(b, l, h, hd), torch.float32)
    blocks = b * h * -(-l // WK.WKV_CHUNK)
    print(f"wkv: B={b} L={l} H={h} hd={hd} f32 {ms:.4f} ms (bound "
          f"{bound[0]:.4f} by {bound[1]}, plain {plain_ms:.2f}), bf16 inputs "
          f"{ms_bf16:.4f} ms; on the device (profiler, L2 cold: each launch "
          f"streams {4 * 4 * n / 1e6:.0f} MB of inputs through the 50 MB "
          f"L2) {dev_ms:.4f} ms, {bound[0] / dev_ms:.1%} of the bound, "
          f"{blocks} blocks of {WK.WKV_CHUNK} steps; one L=1 step at B={b} "
          f"(the one-chunk walk) {ms_step:.4f} ms through the wrapper, "
          f"{dev_step:.4f} ms on the device; max abs err {err:.3g} (f32), {err_bf:.3g} (bf16); two "
          f"runs bitwise equal, no counter left; halves chained and the "
          f"aliased L=1 state agree", flush=True)
    return {"name": "wkv_scan.wkv", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv_scan.cu",
            "replaces": "src/repro/kernels/wkv_scan/kernel.py:61",
            "max_abs_err": err, "max_abs_err_bf16": err_bf, "ms": ms,
            "ms_bf16": ms_bf16, "ms_device": dev_ms, "ms_step_l1": ms_step,
            "ms_step_l1_device": dev_step, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "library": None, "blocks": blocks, "chunk": WK.WKV_CHUNK,
            "shape": {"B": b, "L": l, "H": h, "hd": hd, "dtype": "float32"}}


def _rwkv_prompts(rng, n, lens, vocab):
    return [rng.integers(0, vocab, size=int(rng.integers(lens[0],
                                                        lens[1] + 1)))
            for _ in range(n)]


def rwkv_serving_phase(dev, card):
    """rwkv6-1.6b at its published widths, all 24 layers, random seeded
    bf16 weights: (b) make_prefill_step on 4 x 2048 tokens and generate,
    the reference's prefill + decode == forward invariant, 24 launches a
    prefill and a token and no plain version; (c) the engine, 4 slots and
    8 requests, every request done, each request's first-token logits
    against a batch-1 prefill + serve step; then smoke-size f32 engine
    tokens equal to batch-1 generate on the card (reused slots, a 1-token
    prompt). Returns (launches of the engine run, of the offline run)."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs import rwkv6_1_6b
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.serve import decode as D
    from repro_torch.serve.engine import Engine
    from repro_torch.train import train_step as TS

    cfg = rwkv6_1_6b.CONFIG
    layers = cfg.n_layers
    params = MD.init_params(cfg, seed=0, device=dev)
    prefill = TS.make_prefill_step(cfg)
    serve = TS.make_serve_step(cfg)
    rng = np.random.default_rng(18)
    nb, nl = RWKV_PROMPTS
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (nb, nl)),
                           device=dev)

    # -- (b) offline serving, counted ---------------------------------------
    _reset_launches(WK)
    reg = MET.Registry("rwkv_offline")
    with MET.scope(reg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_full, cache = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if WK.wkv.launches != layers:
            _fail(f"rwkv prefill: {WK.wkv.launches} wkv launches != {layers}")
        _, cache_m1 = prefill(params, {"tokens": toks[:, :-1]})
        logits_dec, _ = serve(params, cache_m1, toks[:, -1:], nl - 1)
        del cache_m1
        first = D.sample_logits(logits_full, vocab_size=cfg.vocab_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, _, _ = D.generate(params, cfg, cache, first[:, None], nl,
                               RWKV_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    offline = _check_launches("rwkv offline", WK, reg, {
        "wkv_scan.wkv": layers * (2 + 1 + RWKV_NEW)})
    scale = float(logits_full.abs().max())
    err = _close("rwkv prefill + decode vs forward (bf16)", logits_dec,
                 logits_full, _logit_tol(logits_full))
    if gen.shape != (nb, RWKV_NEW) or not bool(
            ((gen >= 0) & (gen < cfg.vocab_size)).all()):
        _fail(f"rwkv generate: tokens {tuple(gen.shape)} out of range")
    profile_window(lambda: D.generate(params, cfg, cache, gen[:, -1:],
                                      nl + RWKV_NEW, 4), 4, "token",
                   f"rwkv generate tokens at B {nb}", card)
    del cache
    torch.cuda.empty_cache()
    first_prefill_s = prefill_s  # cuBLAS's first calls at these shapes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    profile_window(lambda: prefill(params, {"tokens": toks}), 1, "prefill",
                   f"rwkv prefill of {nb} x {nl} tokens", card)
    print(f"rwkv offline: prefill {nb} x {nl} tokens in {prefill_s:.4f} s "
          f"({nb * nl / prefill_s:.1f} tok/s; the first, counted one "
          f"{first_prefill_s:.4f} s), generate {RWKV_NEW} tokens "
          f"for {nb} in {gen_s:.4f} s ({nb * RWKV_NEW / gen_s:.1f} tok/s); "
          f"wkv launches {layers} a prefill and a token, no plain version; "
          f"prefill {nl - 1} + decode vs forward last logits (bf16) max abs "
          f"err {err:.4g}, largest logit {scale:.4g} (tol {RWKV_LOGIT_TOL}, "
          f"atol x max(1, largest))", flush=True)
    err32 = _rwkv_f32_invariant(dev, cfg, toks)
    print(f"rwkv offline: float32 at full width, prefill {nl - 1} + decode "
          f"vs forward last logits max abs err {err32:.4g} (tol "
          f"{RWKV_F32_TOL})", flush=True)

    # -- (c) the engine at full width, counted ------------------------------
    class Probe(Engine):
        """Keeps each request's first-token logits."""
        first = {}

        def _decode_round(self, live, kv_lens, rnd, mode):
            logits, cache = super()._decode_round(live, kv_lens, rnd, mode)
            for s in live:
                req = self.slot_req[s]
                if not req.out:
                    self.first[req.uid] = logits[s, 0].float()
            return logits, cache

    ek = RWKV_ENGINE
    prompts = _rwkv_prompts(rng, ek["requests"], ek["lens"], cfg.vocab_size)
    max_new = [ek["max_new"]] * len(prompts)
    _reset_launches(WK)
    reg = MET.Registry("rwkv_engine")
    with MET.scope(reg):
        eng = Probe(params, cfg, slots=ek["slots"], max_len=256, device=dev)
        results, dt = _serve(eng, prompts, max_new)
    st = _check_served("rwkv engine", eng, results, range(len(prompts)),
                       max_new, cfg)
    engine_launches = _check_launches("rwkv engine", WK, reg, {
        "wkv_scan.wkv": layers * (st["prefill_launches"]
                                  + st["decode_rounds"])})
    if st["prefill_launches"] != sum(len(p) - 1 for p in prompts):
        _fail(f"rwkv engine: {st['prefill_launches']} admission steps")
    errs, errs_pf, same = [], [], 0
    for uid, p in enumerate(prompts):
        # batch-1 greedy decode, the prompt fed token by token (the
        # engine's own semantics, and the CPU tests' reference)
        pt = torch.as_tensor(p, device=dev)[None]
        c1 = MD.init_cache(cfg, 1, 256, torch.float32, dev)
        for t in range(len(p)):
            want, c1 = serve(params, c1, pt[:, t:t + 1], t)
        errs.append(_close(f"rwkv engine request {uid} first-token logits",
                           eng.first[uid][None], want, RWKV_LOGIT_TOL))
        first = D.sample_logits(want, vocab_size=cfg.vocab_size)
        out, _, _ = D.generate(params, cfg, c1, first[:, None], len(p),
                               ek["max_new"] - 1)
        same += [int(first[0])] + out[0].tolist() == results[uid]
        # the same first token through a prefill of the prompt (one launch
        # a layer over its L tokens): other matmul shapes, reported
        pf, _ = prefill(params, {"tokens": pt})
        errs_pf.append(float((pf - eng.first[uid][None]).abs().max()))
    n_tok = sum(len(v) for v in results.values())
    print(f"rwkv engine: {len(prompts)} requests ({ek['lens'][0]}-"
          f"{ek['lens'][1]} prompt tokens, {ek['max_new']} new) on "
          f"{ek['slots']} slots, all done, {n_tok} tokens in {dt:.3f} s "
          f"({n_tok / dt:.2f} tok/s, {st['decode_rounds']} lockstep rounds, "
          f"{st['prefill_launches']} admission steps); first-token logits "
          f"within {RWKV_LOGIT_TOL} of a batch-1 greedy decode (max abs err "
          f"{max(errs):.4g}; against a batch-1 prefill of the prompt "
          f"{max(errs_pf):.4g}, not asserted); {same}/{len(prompts)} token "
          f"streams equal the batch-1 greedy decode in bf16 (not asserted: "
          f"near-ties flip)", flush=True)
    del params, eng
    torch.cuda.empty_cache()

    # -- smoke size, float32: tokens identical to batch-1 generate ---------
    scfg = REG.smoke_config("rwkv6-1.6b")
    sparams = MD.init_params(scfg, seed=3, device=dev)
    sprompts = [np.asarray(p, np.int32) for p in
                ([3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4, 4, 2],
                 [7])] + _rwkv_prompts(rng, 3, (16, 40), scfg.vocab_size)
    smax = [6] * len(sprompts)
    eng = Engine(sparams, scfg, slots=2, max_len=64, device=dev)
    got, _ = _serve(eng, sprompts, smax)
    _check_served("rwkv smoke engine", eng, got, range(len(sprompts)), smax,
                  scfg)
    sprefill = TS.make_prefill_step(scfg, cache_dtype=torch.float32)
    for uid, p in enumerate(sprompts):
        pt = torch.as_tensor(p, device=dev)[None].long()
        cache = sprefill(sparams, {"tokens": pt[:, :-1]})[1] if len(p) > 1 \
            else MD.init_cache(scfg, 1, 64, torch.float32, dev)
        out, _, _ = D.generate(sparams, scfg, cache, pt[:, -1:], len(p) - 1,
                               smax[uid])
        if out[0].tolist() != got[uid]:
            _fail(f"rwkv smoke: engine request {uid} {got[uid]} != batch-1 "
                  f"generate {out[0].tolist()}")
    print(f"rwkv smoke: float32 engine (2 slots, {len(sprompts)} requests, "
          f"slots reused, a 1-token prompt) emits batch-1 generate's tokens "
          f"on the card", flush=True)
    return engine_launches["wkv_scan.wkv"], offline["wkv_scan.wkv"]


def _rwkv_f32_invariant(dev, cfg, toks) -> float:
    """The prefill + decode == forward invariant of rwkv6-1.6b at full
    width in float32 (random seeded weights, 6.4 GB): a wrong state or a
    doubled token moves logits by O(1), reassociation by far less than
    RWKV_F32_TOL."""
    import dataclasses

    from repro_torch.models import model as MD
    from repro_torch.train import train_step as TS

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = MD.init_params(cfg32, seed=0, device=dev)
    prefill = TS.make_prefill_step(cfg32, cache_dtype=torch.float32)
    full, _ = prefill(params, {"tokens": toks})
    _, cache = prefill(params, {"tokens": toks[:, :-1]})
    dec, _ = TS.make_serve_step(cfg32)(params, cache, toks[:, -1:],
                                       toks.shape[1] - 1)
    err = _close("rwkv prefill + decode vs forward (f32)", dec, full,
                 RWKV_F32_TOL)
    del params, cache
    torch.cuda.empty_cache()
    return err


def rwkv_cli_phase():
    """launch/serve.py --arch rwkv6-1.6b on the card: every request done
    through the WKV kernel."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.launch import serve as SERVE

    _reset_launches(WK)
    results, eng = SERVE.main(["--arch", "rwkv6-1.6b", "--requests", "6",
                               "--max-new", "8"])
    report = eng.report()
    if sorted(results) != list(range(6)) or any(
            r["status"] != "done" or r["tokens"] != 8
            for r in report.values()) or not WK.wkv.launches:
        _fail(f"serve CLI (rwkv6-1.6b): {report}, launches {_launches(WK)}")
    print("serve CLI: python -m repro_torch.launch.serve --arch rwkv6-1.6b "
          "served 6 requests through the WKV kernel", flush=True)


SSM_SHAPE = (4, 2048, 16384, 16)  # the kernel at full width: B, L, D, N
SSM_TEST_SHAPES = ((1, 8, 16, 4), (3, 16, 32, 32), (2, 128, 256, 16))
SSM_REL = 1e-4  # f32 kernel against its plain version, relative
# bf16 inputs: both run in f32 and round y to bf16 once (the reference
# test's bf16 tolerance)
SSM_BF16_TOL = dict(atol=5e-2, rtol=5e-2)
# jamba-1.5-large-398b at its published widths, cut to one superlayer
# (7 Mamba + 1 attention layers) and 4 of its 16 experts (the
# reference's reduced() expert cut): 32.26 GB of bf16 weights
JAMBA_CUT = dict(n_layers=8, n_experts=4)
JAMBA_PROMPTS = (4, 2048)  # offline serving: prompts x tokens
JAMBA_NEW = 32  # tokens generate decodes after the prefill
JAMBA_ENGINE = dict(slots=4, requests=8, lens=(16, 128), max_new=16)


def _max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _ssm_inputs(gen, dev, b, l, d, n, dtype=torch.float32):
    """The reference test's distributions: x, Bt, Ct ~ N(0, 1), dt =
    softplus(N(0, 1) - 1), A = -exp(0.3 N(0, 1)); h0 ~ N(0, 1)."""
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = rand(b, l, d)
    dt = torch.nn.functional.softplus(rand(b, l, d) - 1)
    a = -torch.exp(0.3 * rand(d, n))
    bt, ct, h0 = rand(b, l, n), rand(b, l, n), rand(b, d, n)
    return [t.to(dtype) for t in (x, dt)] + [a] + \
        [t.to(dtype) for t in (bt, ct)] + [h0]


def ssm_kernel_phase(dev):
    """ssm_scan.selective_scan at the model's prefill shape (B 4, L 2048,
    D 16384, N 16) against its plain version (ref.py) on the card: f32,
    bf16 inputs, the reference test's shapes, halves chained equal to the
    whole, an L = 1 step at B 4 with its state aliased (h0 = h_L); timed
    beside the plain version. No PyTorch call computes a selective scan
    (library: none)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR

    gen = torch.Generator(device=dev).manual_seed(19)
    b, l, d, n = SSM_SHAPE
    with torch.no_grad():
        for shape in SSM_TEST_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                xs = _ssm_inputs(gen, dev, *shape, dtype)
                y, h = SK.selective_scan(*xs)
                wy, wh = SR.selective_scan_ref(*xs)
                if dtype == torch.float32:
                    _wkv_close(f"ssm {shape} f32", y, wy, SSM_REL)
                else:
                    _close(f"ssm {shape} bf16", y, wy.bfloat16(),
                           SSM_BF16_TOL)
                _wkv_close(f"ssm {shape} {dtype} state", h, wh, SSM_REL)
        x, dt, a, bt, ct, h0 = _ssm_inputs(gen, dev, *SSM_SHAPE)
        y, h_l = SK.selective_scan(x, dt, a, bt, ct, h0)
        want_y, want_h = SR.selective_scan_ref(x, dt, a, bt, ct, h0)
        err = max(_wkv_close("ssm f32 y", y, want_y, SSM_REL),
                  _wkv_close("ssm f32 state", h_l, want_h, SSM_REL))
        del want_y
        again = SK.selective_scan(x, dt, a, bt, ct, h0)
        if not (torch.equal(again[0], y) and torch.equal(again[1], h_l)):
            _fail("ssm: two runs differ")
        del again
        m = l // 2
        half = lambda t, s: t[:, s].contiguous()
        y1, h1 = SK.selective_scan(half(x, slice(0, m)), half(dt, slice(0, m)),
                                   a, half(bt, slice(0, m)),
                                   half(ct, slice(0, m)), h0)
        y2, h2 = SK.selective_scan(half(x, slice(m, l)), half(dt, slice(m, l)),
                                   a, half(bt, slice(m, l)),
                                   half(ct, slice(m, l)), h1)
        _wkv_close("ssm halves", torch.cat([y1, y2], 1), y, SSM_REL)
        _wkv_close("ssm halves state", h2, h_l, SSM_REL)
        del y1, y2
        one = [t[:, :1].contiguous() for t in (x, dt)] + [a] + \
            [t[:, :1].contiguous() for t in (bt, ct)]
        cache = h0.clone()
        o, s = SK.selective_scan(*one, cache, state_out=cache)
        w_o, w_s = SR.selective_scan_ref(*one, h0)
        if s is not cache:
            _fail("ssm: state_out is not the aliased cache")
        _wkv_close("ssm L=1 aliased", o, w_o, SSM_REL)
        _wkv_close("ssm L=1 aliased state", cache, w_s, SSM_REL)
        bf = [t.bfloat16() for t in (x, dt, bt, ct)]
        bf_args = (bf[0], bf[1], a, bf[2], bf[3], h0)
        y_bf, _ = SK.selective_scan(*bf_args)
        w_bf, _ = SR.selective_scan_ref(*bf_args)
        if y_bf.dtype != torch.bfloat16:
            _fail(f"ssm bf16: output dtype {y_bf.dtype}")
        err_bf = _close("ssm bf16", y_bf, w_bf.bfloat16(), SSM_BF16_TOL)
        del w_bf
        torch.cuda.synchronize()
        ms = _median_ms(lambda: SK.selective_scan(x, dt, a, bt, ct, h0), 20)
        ms_bf16 = _median_ms(lambda: SK.selective_scan(*bf_args), 20)
        ms_step = _median_ms(
            lambda: SK.selective_scan(*one, cache, state_out=cache), 50)
        dev_step = _device_ms(
            lambda: [SK.selective_scan(*one, cache, state_out=cache)
                     for _ in range(50)], 50, "ssm_kernel")
        dev_ms = _device_ms(lambda: [SK.selective_scan(x, dt, a, bt, ct, h0)
                                     for _ in range(5)], 5, "ssm_kernel")
        plain_ms = _median_ms(
            lambda: SK.selective_scan_torch(x, dt, a, bt, ct, h0), 3, 1)
    # the least time: x, dt, y (B, L, D) and Bt, Ct, A, h0, h_L once each,
    # against 6 N + 1 f32 flops and N exponentials a (b, t, d) on the
    # SFUs at the card's largest SM clock
    clock = _max_sm_clock_hz()
    sb = RF.ssm_bound(b, l, d, n, clock)
    bound_bytes, bound_flops, bound_exp = sb["bytes"], sb["flops"], sb["exp"]
    bound, bound_by = sb["bound"], sb["by"]
    print(f"ssm: B={b} L={l} D={d} N={n} f32 {ms:.4f} ms (bound "
          f"{bound:.4f} by {bound_by}: bytes {bound_bytes:.4f}, f32 flops "
          f"{bound_flops:.4f}, exponentials on the SFUs at "
          f"{clock / 1e6:.0f} MHz {bound_exp:.4f}; plain {plain_ms:.2f}), "
          f"bf16 inputs {ms_bf16:.4f} ms; on the device (profiler, L2 "
          f"cold: each launch streams {8 * b * l * d / 1e9:.2f} GB of x and "
          f"dt through the 50 MB L2) {dev_ms:.4f} ms, {bound / dev_ms:.1%} "
          f"of the bound; one L=1 step at B={b} {ms_step:.4f} ms "
          f"through the wrapper, {dev_step:.4f} ms on the device; max abs "
          f"err {err:.3g} (f32), {err_bf:.3g} (bf16); two runs bitwise "
          f"equal; the reference test's shapes, halves chained and the "
          f"aliased L=1 state agree", flush=True)
    return {"name": "ssm_scan.selective_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:67",
            "max_abs_err": err, "max_abs_err_bf16": err_bf, "ms": ms,
            "ms_bf16": ms_bf16, "ms_device": dev_ms, "ms_step_l1": ms_step,
            "ms_step_l1_device": dev_step, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "bound_bytes_ms": bound_bytes, "bound_flops_ms": bound_flops,
            "bound_exp_ms": bound_exp, "library_ms": None, "library": None,
            "shape": {"B": b, "L": l, "D": d, "N": n, "dtype": "float32"}}


def jamba_serving_phase(dev, card):
    """jamba-1.5-large-398b at its published widths, one superlayer (7
    Mamba layers, 1 attention layer) and 4 of 16 experts, random seeded
    bf16 weights: make_prefill_step on 4 x 2048 tokens (7 ssm launches
    and 1 tri_attn.fwd, no plain version), generate 32 tokens (7 a
    token), prefill of 2047 + one decode step against the forward's last
    logits (the bf16 policy); the engine (4 slots, 8 requests of 16-128
    prompt tokens, 16 new each): every request done, launches = 7 x
    (admission steps + lockstep rounds), each slot's state after its
    admission equal to a batch-1 decode of the prompt bit for bit (the
    first-token logits against it reported); profiler windows over the
    prefill and 4 tokens. Then at smoke size in f32: the engine on the
    kernels and on the plain versions emit the same tokens. Returns the
    ssm launches of the engine run and of the offline run."""
    import types

    from repro_torch.configs import jamba_1_5_large_398b
    from repro_torch.configs import registry as REG
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.serve import decode as D
    from repro_torch.serve.engine import Engine
    from repro_torch.train import train_step as TS

    both = types.SimpleNamespace(WRAPPERS={**K.WRAPPERS, **SK.WRAPPERS})
    cfg = dataclasses.replace(jamba_1_5_large_398b.CONFIG, **JAMBA_CUT)
    mamba = sum(k == "mamba" for k in cfg.layer_kinds)
    torch.cuda.reset_peak_memory_stats()
    params = MD.init_params(cfg, seed=0, device=dev)
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    counts = cfg.param_counts()
    print(f"jamba: {cfg.n_layers} layers ({mamba} Mamba), {cfg.n_experts} "
          f"experts top-{cfg.experts_per_token}, d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner}, d_ff {cfg.d_ff}: {gb:.2f} GB of bf16 "
          f"weights loaded ({counts['total'] / 1e9:.2f} B parameters, "
          f"{counts['active'] / 1e9:.2f} B active a token)", flush=True)
    nb, nl = JAMBA_PROMPTS
    # the attention layer's cache holds the tokens generate adds
    prefill = TS.make_prefill_step(cfg, max_len=nl + JAMBA_NEW + 4)
    serve = TS.make_serve_step(cfg)
    rng = np.random.default_rng(20)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (nb, nl)),
                           device=dev)

    # -- offline serving, counted --------------------------------------------
    _reset_launches(both)
    reg = MET.Registry("jamba_prefill")
    with MET.scope(reg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_full, cache = prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        first_prefill_s = time.perf_counter() - t0
    _check_launches("jamba prefill", both, reg, {
        "ssm_scan.selective_scan": mamba, "tri_attn.fwd": 1})
    _reset_launches(both)
    reg = MET.Registry("jamba_generate")
    with MET.scope(reg):
        first = D.sample_logits(logits_full, vocab_size=cfg.vocab_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, _, _ = D.generate(params, cfg, cache, first[:, None], nl,
                               JAMBA_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    offline = _check_launches("jamba generate", both, reg, {
        "ssm_scan.selective_scan": mamba * JAMBA_NEW})
    if gen.shape != (nb, JAMBA_NEW) or not bool(
            ((gen >= 0) & (gen < cfg.vocab_size)).all()):
        _fail(f"jamba generate: tokens {tuple(gen.shape)} out of range")
    profile_window(lambda: D.generate(params, cfg, cache, gen[:, -1:],
                                      nl + JAMBA_NEW, 4), 4, "token",
                   f"jamba generate tokens at B {nb}", card)
    del cache
    _, cache_m1 = prefill(params, {"tokens": toks[:, :-1]})
    logits_dec, _ = serve(params, cache_m1, toks[:, -1:], nl - 1)
    del cache_m1
    scale = float(logits_full.abs().max())
    err = _close("jamba prefill + decode vs forward (bf16)", logits_dec,
                 logits_full, _logit_tol(logits_full))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    profile_window(lambda: prefill(params, {"tokens": toks}), 1, "prefill",
                   f"jamba prefill of {nb} x {nl} tokens", card)
    print(f"jamba offline: prefill {nb} x {nl} tokens in {prefill_s:.4f} s "
          f"({nb * nl / prefill_s:.1f} tok/s; the first, counted one "
          f"{first_prefill_s:.4f} s), generate {JAMBA_NEW} tokens for {nb} "
          f"in {gen_s:.4f} s ({nb * JAMBA_NEW / gen_s:.1f} tok/s); ssm "
          f"launches {mamba} a prefill (with 1 tri_attn.fwd) and a token, no "
          f"plain version; prefill {nl - 1} + decode vs forward last logits "
          f"(bf16) max abs err {err:.4g}, largest logit {scale:.4g} (tol "
          f"{RWKV_LOGIT_TOL}, atol x max(1, largest)); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    # -- the engine at full width, counted ------------------------------------
    class Probe(Engine):
        """Keeps each request's slot state right after its admission and
        its first-token logits."""
        admitted, first = {}, {}

        def _prefill_recurrent(self, slot, req):
            super()._prefill_recurrent(slot, req)
            self.admitted[req.uid] = {
                (name, leaf): t[:, slot].clone()
                for name, leaves in self.cache.items()
                for leaf, t in leaves.items()}

        def _decode_round(self, live, kv_lens, rnd, mode):
            logits, cache = super()._decode_round(live, kv_lens, rnd, mode)
            for s in live:
                req = self.slot_req[s]
                if not req.out:
                    self.first[req.uid] = logits[s, 0].float()
            return logits, cache

    ek = JAMBA_ENGINE
    prompts = _rwkv_prompts(rng, ek["requests"], ek["lens"], cfg.vocab_size)
    max_new = [ek["max_new"]] * len(prompts)
    _reset_launches(both)
    reg = MET.Registry("jamba_engine")
    with MET.scope(reg):
        eng = Probe(params, cfg, slots=ek["slots"], max_len=256, device=dev)
        results, dt = _serve(eng, prompts, max_new)
    st = _check_served("jamba engine", eng, results, range(len(prompts)),
                       max_new, cfg)
    engine_launches = _check_launches("jamba engine", both, reg, {
        "ssm_scan.selective_scan": mamba * (st["prefill_launches"]
                                            + st["decode_rounds"])})
    if st["prefill_launches"] != sum(len(p) - 1 for p in prompts):
        _fail(f"jamba engine: {st['prefill_launches']} admission steps")
    errs = []
    for uid, p in enumerate(prompts):
        # a batch-1 greedy decode, the prompt fed token by token (the
        # engine's own semantics, and the CPU tests' reference): after
        # prompt[:-1] the slot's state (h, conv, k/v) is bit for bit the
        # engine's after admission (a fresh slot, each token applied
        # once); the last token's logits come from a batch-4 round in the
        # engine, whose GEMMs round at other places in bf16: reported
        pt = torch.as_tensor(p, device=dev)[None]
        c1 = MD.init_cache(cfg, 1, 256, torch.float32, dev)
        for t in range(len(p) - 1):
            _, c1 = serve(params, c1, pt[:, t:t + 1], t)
        for (name, leaf), got in eng.admitted[uid].items():
            if not torch.equal(got, c1[name][leaf][:, 0]):
                _fail(f"jamba engine request {uid}: {name}.{leaf} after "
                      "admission differs from a batch-1 decode of the "
                      "prompt")
        want, _ = serve(params, c1, pt[:, -1:], len(p) - 1)
        errs.append(float((eng.first[uid][None] - want).abs().max()))
    n_tok = sum(len(v) for v in results.values())
    print(f"jamba engine: {len(prompts)} requests ({ek['lens'][0]}-"
          f"{ek['lens'][1]} prompt tokens, {ek['max_new']} new) on "
          f"{ek['slots']} slots, all done, {n_tok} tokens in {dt:.3f} s "
          f"({n_tok / dt:.2f} tok/s, {st['decode_rounds']} lockstep rounds, "
          f"{st['prefill_launches']} admission steps, "
          f"{engine_launches['ssm_scan.selective_scan']} ssm launches); "
          f"each slot's state after admission equals a batch-1 decode of "
          f"its prompt bit for bit; first-token logits against the batch-1 "
          f"decode's: max abs err {max(errs):.4g} (not asserted: a batch-4 "
          f"round's bf16 GEMMs); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del params, eng
    torch.cuda.empty_cache()

    # -- smoke size, float32: kernel and plain engines emit the same tokens --
    scfg = REG.smoke_config("jamba-1.5-large-398b")
    sparams = MD.init_params(scfg, seed=3, device=dev)
    sprompts = [np.asarray(p, np.int32) for p in
                ([3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4, 4, 2],
                 [7])] + _rwkv_prompts(rng, 3, (16, 40), scfg.vocab_size)
    smax = [6] * len(sprompts)
    got = {}
    for impl in ("cuda", "torch"):
        _reset_launches(SK)
        eng = Engine(sparams, scfg, slots=2, max_len=64, prefill_impl=impl,
                     decode_impl=impl, device=dev)
        got[impl], _ = _serve(eng, sprompts, smax)
        _check_served(f"jamba smoke engine ({impl})", eng, got[impl],
                      range(len(sprompts)), smax, scfg)
        if (SK.selective_scan.launches > 0) != (impl == "cuda"):
            _fail(f"jamba smoke ({impl}): {SK.selective_scan.launches} ssm "
                  "launches")
    if got["cuda"] != got["torch"]:
        _fail(f"jamba smoke: kernel engine {got['cuda']} != plain engine "
              f"{got['torch']}")
    print(f"jamba smoke: float32 engine (2 slots, {len(sprompts)} requests, "
          f"slots reused, a 1-token prompt) on the kernels emits the plain "
          f"versions' tokens on the card", flush=True)
    return engine_launches["ssm_scan.selective_scan"], \
        offline["ssm_scan.selective_scan"]


def jamba_cli_phase():
    """launch/serve.py --arch jamba-1.5-large-398b on the card: every
    request done through the selective-scan kernel."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.launch import serve as SERVE

    _reset_launches(SK)
    results, eng = SERVE.main(["--arch", "jamba-1.5-large-398b",
                               "--requests", "6", "--max-new", "8"])
    report = eng.report()
    if sorted(results) != list(range(6)) or any(
            r["status"] != "done" or r["tokens"] != 8
            for r in report.values()) or not SK.selective_scan.launches:
        _fail(f"serve CLI (jamba): {report}, launches {_launches(SK)}")
    print("serve CLI: python -m repro_torch.launch.serve --arch "
          "jamba-1.5-large-398b served 6 requests through the "
          "selective-scan kernel", flush=True)


# the other architectures (phase 7e): the serving engine's settings of
# phase 4, depth cuts with dataclasses.replace (never reduced(), which
# shrinks the widths)
ARCH_ENGINE = dict(slots=4, max_len=2048, prefill_block=64, decode_block=64,
                   prefill_impl="cuda", decode_impl="cuda",
                   decode_mode="packed")
ARCH_PROMPTS = (1000, 90, 500, 250, 700, 60, 380, 150)
ARCH_BUDGETS = (8, 40, 16, 32, 24, 12, 36, 20)  # fused mode, staggered
MIXTRAL_CUT = 8  # of 32 layers: 23.7 GB of bf16 weights (all 32: 93.4 GB)
MIXTRAL_PROMPTS = (4500, 60, 230, 500)  # the first crosses the 4096 window
MIXTRAL_NEW = 64
MIXTRAL_MAX_LEN = 4608  # slots of min(4096, 4608) rolling rows
MIXTRAL_REF = 4544  # tokens of the plain reference forward (71 x 64)
# a top-k router breaks a near-tie of its logits either way under bf16
# rounding, and a token sent to another expert moves its logits by O(1),
# so each reference run below routes every position of a request to the
# experts the engine routed it to (_Routing's replay) and is held to the
# tolerance at every token
WIDE_CUTS = {"granite-34b": 4, "llama3-405b": 2}  # of 88 and 126 layers
WIDE_ENGINE = dict(slots=2, requests=4, lens=(16, 256), max_new=16)
# nemotron-4-340b: 4 of 96 layers, 23.25 B parameters, 46.51 GB of bf16
# weights; fused budgets all different, so whichever two requests the
# engine admits first, one ends first and the next admission meets the
# other live (a mixed round); one attention layer at this seq for the
# tri_fwd / fwd_bb rows
NEMOTRON_CUT = 4
NEMOTRON_BUDGETS = (16, 8, 12, 4)
NEMOTRON_SEQ = 2048
# the packed train phase's eight documents scaled to one NEMOTRON_SEQ row
# (1900 real tokens, padded to blk 64: 704 + 512 + 320 + 192 + 128 + 3 x 64)
NEMOTRON_DOCS = (700, 500, 300, 180, 100, 60, 40, 20)
# nemotron's training: depth cut to 1 of 96 layers (12.89 B parameters,
# 25.8 GB of bf16 weights and as much of grads; Adafactor's factored state
# is O(rows + cols), where AdamW's moments would add 103 GB), 3 steps of
# one row, dense then packed, through the reference's Adafactor
NEMOTRON_TRAIN_CUT = 1
NEMOTRON_TRAIN_STEPS = 3
# one row repeated, so the loss must fall: Adafactor's update is unit RMS
# whatever the grad's size, and at these widths on the H100 an lr of 1e-4
# took the loss 13.02 -> 70.05, 3e-5 and 1e-5 up and down; 3e-6 falls at
# every step (PERF.md section 6)
NEMOTRON_OPT = dict(kind="adafactor", lr=3e-6, warmup_steps=1,
                    total_steps=100)
# the bf16 policy of a whole step against its oracle-attention twin: the
# loss within PAD_LOSS_RTOL, the attention weights' grads within
# BF16_GRAD_TOL with the absolute part scaled by the leaf's largest grad
# (tests/test_torch_train.py's bf16 grads)
NEMOTRON_ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")
FRONTEND_TRAIN = {"musicgen-large": 2048, "internvl2-1b": 4096}  # seq


class _Routing:
    """The experts models/moe.route picks, one (T, k) tensor (sorted) a
    call, while the recorder is open. Given ``replay`` (one (T, k) tensor
    a call, in layer order), each call's tokens go to those experts
    instead, weighted by this run's own router (a softmax over their
    logits); ``moved`` counts the token-layers whose own top-k differs."""

    def __init__(self, replay=None):
        self.replay, self.calls, self.moved = replay, [], 0

    def __enter__(self):
        from repro_torch.models import moe as MOE

        self.MOE, self.orig = MOE, MOE.route

        def route(params, xf, cfg, *, full_capacity=False):
            out = self.orig(params, xf, cfg, full_capacity=full_capacity)
            picked = out[1].sort(dim=-1).values
            if self.replay is not None:
                want = self.replay[len(self.calls)]
                if want.shape != picked.shape or not bool(out[2].all()):
                    _fail(f"route replay: {tuple(want.shape)} experts for "
                          f"{tuple(picked.shape)} slots, all kept "
                          f"{bool(out[2].all())}")
                self.moved += int((want != picked).any(dim=-1).sum())
                logits = (xf.float() @ params["router"]).gather(-1, want)
                out = (torch.softmax(logits, dim=-1), want) + out[2:]
                picked = want
            self.calls.append(picked)
            return out

        MOE.route = route
        return self

    def __exit__(self, *exc):
        self.MOE.route = self.orig
        if exc[0] is None and self.replay is not None and \
                len(self.calls) != len(self.replay):
            _fail(f"route replay: {len(self.replay)} layers recorded, "
                  f"{len(self.calls)} routed")


def _probe_engine(Engine, *args, **kw):
    """An Engine that records, while ``record`` is set, each request's
    logits at every token it samples (``logits[uid, step]``) and the
    experts each MoE layer routed every position of it to
    (``experts(uid, n)``), over packed admits, decode rounds and fused
    rounds."""
    import collections

    from repro_torch.serve import decode as D

    class Probe(Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.record, self.logits = True, {}
            self.routed = collections.defaultdict(list)
            self._admits = []

        def _routes(self, req, pos0, calls, rows):
            if calls:
                self.routed[req.uid].append(
                    (pos0, torch.stack([c[rows] for c in calls])))

        def _decoded(self, live, logits, calls):
            pos = self.pos.clone()
            for s in live:
                req = self.slot_req[s]
                self.logits[req.uid, len(req.out)] = logits[s].float().clone()
                self._routes(req, pos[s], calls, slice(s, s + 1))

        def _take_admits(self):
            pairs = super()._take_admits()
            self._admits = [req for _, req in pairs]
            return pairs

        def _admit_packed(self, pairs, rnd):
            if not self.record:
                return super()._admit_packed(pairs, rnd)
            with _Routing() as r:
                super()._admit_packed(pairs, rnd)
            starts = D._pack_prompts([req.feed for _, req in pairs],
                                     self.prefill_block)[2]
            for (_, req), st in zip(pairs, starts):
                self._routes(req, 0, r.calls, slice(st, st + len(req.feed)))

        def _decode_round(self, live, kv_lens, rnd, mode):
            if not self.record:
                return super()._decode_round(live, kv_lens, rnd, mode)
            with _Routing() as r:
                logits, cache = super()._decode_round(live, kv_lens, rnd,
                                                      mode)
            self._decoded(live, logits[:, 0], r.calls)
            return logits, cache

        def step_fused(self):
            orig = D.fused_step

            def fused_step(params, cfg, cache, prompts, tokens, pos, kv_lens,
                           slots, **k):
                with _Routing() as r:
                    out = orig(params, cfg, cache, prompts, tokens, pos,
                               kv_lens, slots, **k)
                # each MoE layer routes the pack, then the decode rows
                for req, row, st in zip(self._admits, out[0], out[5]):
                    self.logits[req.uid, len(req.out)] = row.float().clone()
                    self._routes(req, 0, r.calls[0::2],
                                 slice(st, st + len(req.feed)))
                self._decoded(slots, out[1], r.calls[1::2])
                return out

            if self.record:
                D.fused_step = fused_step
            try:
                super().step_fused()
            finally:
                D.fused_step = orig

        def experts(self, uid, n):
            """(MoE layers, n, k): the experts of request uid's positions
            [0, n), each as last routed (a decode round reroutes the last
            prompt token its admit routed); None for a dense arch."""
            chunks = self.routed[uid]
            if not chunks:
                return None
            e = chunks[0][1]
            out = torch.full((e.shape[0], n, e.shape[2]), -1,
                             dtype=e.dtype, device=e.device)
            for pos0, e in chunks:
                pos0 = int(pos0)
                m = min(e.shape[1], n - pos0)
                if m > 0:
                    out[:, pos0:pos0 + m] = e[:, :m]
            if bool((out < 0).any()):
                _fail(f"request {uid}: positions of [0, {n}) never routed")
            return out

    return Probe(*args, **kw)


def _host_syncs(fn) -> dict:
    """The synchronizing CUDA calls ``fn()`` makes, counted by the source
    file that made each (torch.cuda.set_sync_debug_mode)."""
    import collections
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        Path(w.filename).name for w in rec
        if "synchroniz" in str(w.message)))


def _arch_params(cfg, dev, label, card):
    from repro_torch.models import model as MD

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = MD.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    counts = cfg.param_counts()
    print(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, H "
          f"{cfg.n_heads} over Hkv {cfg.n_kv_heads} (g "
          f"{cfg.n_heads // cfg.n_kv_heads}), head dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff} ({cfg.mlp_activation}), experts {cfg.n_experts} top-"
          f"{cfg.experts_per_token}, window {cfg.sliding_window}, vocab "
          f"{cfg.vocab_size}: {gb:.2f} GB of bf16 weights "
          f"({counts['total'] / 1e9:.3f} B parameters, "
          f"{counts['active'] / 1e9:.3f} B active a token) in "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    return params


def _first_token_check(label, eng, params, cfg, prompts, tol=None):
    """Each request's first-token logits (``eng`` a _probe_engine) against
    a batch-1 prefill of its prompt on the same weights, its attention the
    masked full-matrix oracle (impl "ref", plain PyTorch: the plain tile
    walk halves its tile until it divides a ragged prompt, to 2 tokens
    and minutes a request), its MoE layers routing every position to the
    experts the engine routed it to, within ``tol`` (default the bf16
    policy). Returns (largest error, token-layers the prefill's own router
    would have sent elsewhere, token-layers routed)."""
    from repro_torch.train import train_step as TS

    prefill = TS.make_prefill_step(cfg, attn_impl="ref",
                                   cache_dtype=torch.float32)
    errs, moved, routed = [], 0, 0
    for uid, p in enumerate(prompts):
        experts = eng.experts(uid, len(p))
        with _Routing(experts) as r:
            want, _ = prefill(params, {"tokens": torch.as_tensor(
                np.asarray(p, np.int64)[None],
                device=params["embed"].device)})
        moved += r.moved
        routed += 0 if experts is None else experts.shape[0] * len(p)
        errs.append(_close(f"{label}: request {uid}'s first-token logits "
                           "vs a batch-1 prefill", eng.logits[uid, 0][None],
                           want, tol or _logit_tol(want)))
    return max(errs), moved, routed


def _served_line(label, st, results, prompt_lens, wall, card, extra=""):
    new_tokens = sum(len(v) for v in results.values())
    print(f"{label}: {len(results)} requests, {sum(prompt_lens)} prompt + "
          f"{new_tokens} generated tokens in {wall:.3f} s "
          f"({new_tokens / wall:.1f} generated tokens/s), admit rounds "
          f"{st['admit_rounds']}, decode rounds {st['decode_rounds']}, fused "
          f"rounds {st['fused_rounds']}{extra}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}",
          flush=True)


def _f32_engine(cfg, dev, prompts, budgets, max_len):
    """Float32 weights from the same seed (the draws before their bf16
    rounding) and a split probe engine on the kernels serving
    ``prompts``; returns (cfg, params, engine, results)."""
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = MD.init_params(cfg32, seed=0, device=dev)
    eng = _probe_engine(Engine, params, cfg32, device=dev,
                        **dict(ARCH_ENGINE, max_len=max_len))
    results, _ = _serve(eng, prompts, budgets)
    _check_served(f"{cfg.name} float32", eng, results, range(len(prompts)),
                  budgets, cfg32)
    return cfg32, params, eng, results


def granite_moe_phase(dev, card, K):
    """granite-moe-3b-a800m at its published widths and all 32 layers:
    split then fused serving on the kernels (launches = 32 x the engine's,
    no plain version, first-token logits against a batch-1 prefill through
    the attention oracle routed as the engine routed), a profiler window
    over decode rounds and the host syncs a round; the same prompts' first
    tokens in float32 at full width."""
    from repro_torch.configs import registry as REG
    from repro_torch.obs import metrics as MET
    from repro_torch.serve.engine import Engine

    cfg = REG.get_config("granite-moe-3b-a800m")
    params = _arch_params(cfg, dev, "granite-moe", card)
    n_l = cfg.n_layers
    rng = np.random.default_rng(26)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in ARCH_PROMPTS]
    errs = {}
    for mode, budgets in (("split", [32] * len(prompts)),
                          ("fused", list(ARCH_BUDGETS))):
        eng = _probe_engine(Engine, params, cfg, step_mode=mode, device=dev,
                            **ARCH_ENGINE)
        reg = MET.Registry(f"granite_moe_{mode}")
        _reset_launches(K)
        with MET.scope(reg):
            results, wall = _serve(eng, prompts, budgets)
        st = _check_served(f"granite-moe {mode}", eng, results,
                           range(len(prompts)), budgets, cfg)
        want = {"tri_attn.packed_decode_fwd":
                n_l * st["decode_packed_launches"]}
        if mode == "split":
            want["tri_attn.packed_fwd"] = n_l * st["prefill_launches"]
        else:
            want["tri_attn.fused_step_fwd"] = n_l * st["fused_launches"]
            mixed = st["decode_rounds"] - st["decode_packed_launches"]
            if st["fused_fallbacks"] or mixed < 2:
                _fail(f"granite-moe fused: fallbacks "
                      f"{st['fused_fallbacks']}, mixed rounds {mixed}")
        if not all(want.values()):
            _fail(f"granite-moe {mode}: a kernel of the path never ran: "
                  f"{want}")
        launches = _check_launches(f"granite-moe {mode}", K, reg, want)
        err, moved, routed = _first_token_check(
            f"granite-moe {mode}", eng, params, cfg, prompts)
        errs[mode] = err
        _served_line(f"granite-moe {mode}", st, results, ARCH_PROMPTS, wall,
                     card, f"; launches {launches} (= {n_l} layers x the "
                     f"engine's); first-token logits of all {len(prompts)} "
                     f"requests vs batch-1 prefills through the oracle "
                     f"attention routed as the engine routed: max abs err "
                     f"{err:.4g} (bf16 policy); their own router would have "
                     f"sent {moved} of {routed} token-layers elsewhere")
        if mode == "split":
            eng.record = False
            for uid, n in enumerate((900, 40, 600, 200)):
                eng.submit(rng.integers(1, cfg.vocab_size, size=n),
                           max_new=10, uid=1000 + uid)
            eng.round()  # admit + first decode round, outside the window
            profile_rounds(eng, 4, "granite-moe packed decode rounds (4 "
                           "live slots)", card)
            syncs = _host_syncs(lambda: [eng.round() for _ in range(2)])
            print(f"granite-moe host syncs a decode round, by source file: "
                  f"{ {f: n / 2 for f, n in syncs.items()} } ({n_l} MoE "
                  f"layers); card {card}", flush=True)
            eng.run()
        del eng
    del params
    torch.cuda.empty_cache()
    # float32 at full width: every request's first token at RWKV_F32_TOL
    cfg32, params, eng, _ = _f32_engine(
        cfg, dev, prompts, [1] * len(prompts), ARCH_ENGINE["max_len"])
    err32, moved, routed = _first_token_check(
        "granite-moe float32", eng, params, cfg32, prompts, RWKV_F32_TOL)
    del eng
    print(f"granite-moe float32 at full width: first tokens on the kernels "
          f"vs batch-1 prefills through the oracle attention routed as the "
          f"engine routed, all {len(prompts)} requests: max abs err "
          f"{err32:.4g} (tol {RWKV_F32_TOL}); their own router would have "
          f"sent {moved} of {routed} token-layers elsewhere; card {card}",
          flush=True)
    errs["float32"] = err32
    del params
    torch.cuda.empty_cache()
    return errs


def mixtral_phase(dev, card, K):
    """mixtral-8x7b at its published widths cut to MIXTRAL_CUT layers:
    slots of 4096 rolling rows, a prompt of 4500 tokens past the window
    (band members in its admission prefill) whose 64 decode steps wrap
    its slot; its logits at the first 45 steps against the plain
    versions' forward over the same 4544 tokens (band attention of window
    4096), routed as the engine routed them: in bf16 and in float32 (the
    same seed's weights, 47.5 GB)."""
    from repro_torch.configs import mixtral_8x7b
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(mixtral_8x7b.CONFIG, n_layers=MIXTRAL_CUT)
    params = _arch_params(cfg, dev, f"mixtral (cut to {MIXTRAL_CUT} of "
                          f"{mixtral_8x7b.CONFIG.n_layers} layers)", card)
    rng = np.random.default_rng(27)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in MIXTRAL_PROMPTS]
    n_ref = MIXTRAL_REF - len(prompts[0]) + 1  # steps the reference covers

    def window_check(label, eng, params, cfg, results, tol_fn):
        """The long request's logits vs the plain versions' forward;
        returns (largest error, token-layers its own router would have
        sent elsewhere)."""
        toks = np.concatenate([prompts[0], np.asarray(
            results[0][:n_ref - 1], np.int32)])
        with torch.no_grad(), _Routing(eng.experts(0, MIXTRAL_REF)) as r:
            hidden, _, _ = MD.forward(params, cfg, {"tokens": torch.as_tensor(
                toks[None].astype(np.int64), device=dev)},
                attn_impl="torch", block=64, full_capacity=True)
            want = MD.logits_from_hidden(params, cfg,
                                         hidden[0, len(prompts[0]) - 1:])
        errs = [_close(f"{label}: the long request's logits at step {i} vs "
                       "the plain versions' forward", eng.logits[0, i],
                       want[i], tol_fn(want[i])) for i in range(n_ref)]
        return max(errs), r.moved

    budgets = [MIXTRAL_NEW] * len(prompts)
    eng = _probe_engine(Engine, params, cfg, device=dev, **dict(
        ARCH_ENGINE, max_len=MIXTRAL_MAX_LEN))
    if eng.s_cache != cfg.sliding_window or not eng._rolling:
        _fail(f"mixtral: slots of {eng.s_cache} rows, rolling "
              f"{eng._rolling}")
    reg = MET.Registry("mixtral")
    _reset_launches(K)
    with MET.scope(reg):
        results, wall = _serve(eng, prompts, budgets)
    st = _check_served("mixtral", eng, results, range(len(prompts)), budgets,
                       cfg)
    launches = _check_launches("mixtral", K, reg, {
        "tri_attn.packed_fwd": cfg.n_layers * st["prefill_launches"],
        "tri_attn.packed_decode_fwd": cfg.n_layers *
        st["decode_packed_launches"]})
    err, moved = window_check("mixtral", eng, params, cfg, results,
                              _logit_tol)
    s_cache = eng.s_cache
    del eng
    routed = cfg.n_layers * MIXTRAL_REF
    _served_line("mixtral", st, results, MIXTRAL_PROMPTS, wall, card,
                 f"; launches {launches} (= {cfg.n_layers} layers x the "
                 f"engine's); the {MIXTRAL_PROMPTS[0]}-token request: band "
                 f"members past the {cfg.sliding_window}-token window in its "
                 f"admission prefill, {MIXTRAL_NEW} decode steps at "
                 f"positions {MIXTRAL_PROMPTS[0] - 1}-"
                 f"{MIXTRAL_PROMPTS[0] + MIXTRAL_NEW - 2} through slots of "
                 f"{s_cache} rolling rows; its logits at all {n_ref} steps "
                 f"vs the plain versions' forward over {MIXTRAL_REF} tokens "
                 f"(impl torch, band) routed as the engine routed: max abs "
                 f"err {err:.4g} (bf16 policy); its own router would have "
                 f"sent {moved} of {routed} token-layers elsewhere")
    del params
    torch.cuda.empty_cache()
    # float32 (the same seed's draws, unrounded): every step
    cfg32, params, eng, results = _f32_engine(
        cfg, dev, prompts, [n_ref] * len(prompts), MIXTRAL_MAX_LEN)
    err32, moved32 = window_check("mixtral float32", eng, params, cfg32,
                                  results, lambda want: RWKV_F32_TOL)
    del eng
    print(f"mixtral float32 ({cfg.n_layers} layers, "
          f"{sum(x.numel() for x in _leaves(params)) * 4 / 1e9:.1f} GB): "
          f"the long request's logits at all {n_ref} steps vs the plain "
          f"versions' forward routed as the engine routed, max abs err "
          f"{err32:.4g} (tol {RWKV_F32_TOL}); its own router would have "
          f"sent {moved32} of {routed} token-layers elsewhere; card {card}",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return {"bfloat16": err, "float32": err32}


def wide_gqa_phase(dev, card, K):
    """granite-34b (g 48: six decode head slices a kv head; gelu) and
    llama3-405b (g 16) at published widths, depth cut: an engine of 2
    slots, 4 requests, every request done on the kernels, first-token
    logits within the bf16 policy of a batch-1 prefill through the
    attention oracle."""
    from repro_torch.configs import registry as REG
    from repro_torch.obs import metrics as MET
    from repro_torch.serve.engine import Engine

    errs = {}
    for arch, cut in WIDE_CUTS.items():
        full = REG.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=cut)
        params = _arch_params(cfg, dev, f"{arch} (cut to {cut} of "
                              f"{full.n_layers} layers)", card)
        ek = WIDE_ENGINE
        rng = np.random.default_rng(28)
        prompts = [p.astype(np.int32) for p in _rwkv_prompts(
            rng, ek["requests"], ek["lens"], cfg.vocab_size)]
        budgets = [ek["max_new"]] * len(prompts)
        eng = _probe_engine(Engine, params, cfg, device=dev, **dict(
            ARCH_ENGINE, slots=ek["slots"], max_len=512))
        reg = MET.Registry(arch)
        _reset_launches(K)
        with MET.scope(reg):
            results, wall = _serve(eng, prompts, budgets)
        st = _check_served(arch, eng, results, range(len(prompts)), budgets,
                           cfg)
        launches = _check_launches(arch, K, reg, {
            "tri_attn.packed_fwd": cut * st["prefill_launches"],
            "tri_attn.packed_decode_fwd": cut *
            st["decode_packed_launches"]})
        errs[arch], _, _ = _first_token_check(arch, eng, params, cfg,
                                              prompts)
        _served_line(arch, st, results, [len(p) for p in prompts], wall,
                     card, f"; launches {launches}; first-token logits of "
                     f"all {len(prompts)} requests vs batch-1 prefills "
                     f"through the oracle attention: max abs err "
                     f"{errs[arch]:.4g} (bf16 policy)")
        del eng, params
        torch.cuda.empty_cache()
    return errs


def frontend_training_phase(dev, card, K):
    """musicgen-large (audio frames, MHA, gelu) and internvl2-1b (a vision
    prefix of 256 patches, g 7) at published widths and depth: 2 training
    steps of batch 1 on SyntheticLM's frontend batches through tri_fwd
    (the prefix schedule for internvl2) and tri_bwd, launches asserted;
    then one smoke-size float32 step on the kernels against the plain
    versions."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.obs import metrics as MET
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    steps = 2
    for arch, seq in FRONTEND_TRAIN.items():
        cfg = REG.get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = OPT.OptConfig()
        state = TS.init_state(cfg, opt, seed=0, device=dev)
        ds = DATA.SyntheticLM(cfg, ShapeConfig(arch, seq, 1, "train"),
                              seed=0, device=dev)
        step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                                  block=64)
        times = []
        reg = MET.Registry(arch)
        _reset_launches(K)
        with MET.scope(reg):
            state, log = FT.run_training(state, _timed(step, times),
                                         ds.batch, steps)
        n_l = cfg.n_layers
        launches = _check_launches(f"{arch} train", K, reg, {
            "tri_attn.fwd": 2 * n_l * steps, "tri_attn.bwd_dq": n_l * steps,
            "tri_attn.bwd_dkv": n_l * steps})
        losses = [m["loss"] for m in log]
        if len(losses) != steps or not all(np.isfinite(losses)) or \
                min(losses) <= 0:
            _fail(f"{arch} train: losses {losses}")
        shapes = ", ".join(f"{k} {tuple(v.shape)}"
                           for k, v in ds.batch(0).items())
        prefix = cfg.n_patches if cfg.frontend == "vision_patches" else 0
        print(f"{arch} train: {n_l} layers, {steps} steps of batch 1, seq "
              f"{seq} ({shapes}; prefix {prefix}), "
              f"losses {losses}, step times {times} s, "
              f"{seq / times[-1]:.1f} tokens/s (the second); peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
              f"{launches}, no plain version; card {card}", flush=True)
        del state, step
        torch.cuda.empty_cache()
        scfg = REG.smoke_config(arch)
        sopt = OPT.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
        base = TS.init_state(scfg, sopt, seed=0, device=dev)
        sds = DATA.SyntheticLM(scfg, ShapeConfig("t", 64, 2, "train"),
                               seed=0, device=dev)
        mets = {impl: FT.run_training(copy.deepcopy(base), TS.make_train_step(
            scfg, sopt, attn_impl=impl, block=16), sds.batch, 2)[1]
            for impl in ("cuda", "torch")}
        for key in ("loss", "grad_norm"):
            a = [m[key] for m in mets["cuda"]]
            b = [m[key] for m in mets["torch"]]
            if not np.allclose(a, b, rtol=1e-5, atol=0):
                _fail(f"{arch} smoke training: kernel {key} {a} != plain {b}")
        print(f"{arch} smoke training: float32, 2 steps on the kernels "
              f"{[m['loss'] for m in mets['cuda']]} vs the plain versions "
              f"{[m['loss'] for m in mets['torch']]} (rtol 1e-5)", flush=True)


def nemotron_dense_rows(dev, K, SC, h, hkv, d, s_len):
    """tri_attn.fwd and tri_attn.fwd_bb at one attention layer of (B 1,
    H h, Hkv hkv, S s_len, D d, ltm, blk 64, bf16): each against its plain
    version, in turns with SDPA's causal forward, beside its bound (the
    forward's, over the causal pairs: fwd_bb launches the whole n x n grid
    but computes the same function). Returns {name: reading}."""
    import torch.nn.functional as F
    from repro_torch.kernels.tri_attn import ops as OPS

    rng = np.random.default_rng(27)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(torch.bfloat16)
               for shape in ((1, h, s_len, d), (1, hkv, s_len, d),
                             (1, hkv, s_len, d)))
    sched = OPS.make_sched(s_len, block=64)
    scale = d ** -0.5
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 enable_gqa=True)
    bound, by = RF.attn_bounds(q, k, h * s_len * (s_len + 1) // 2)["fwd"]
    rows = {}
    for name, fn, plain in (
            ("tri_attn.fwd", K.fwd, SC.fwd_torch),
            ("tri_attn.fwd_bb", K.fwd_bb, SC.fwd_bb_torch)):
        out, lse = fn(q, k, v, sched)
        again = fn(q, k, v, sched)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            _fail(f"{name} at D {d}: two runs on the same inputs differ")
        w_out, w_lse = plain(q, k, v, sched, scale)
        err = max(_close(f"{name} D {d} out", out, w_out),
                  _close(f"{name} D {d} lse", lse, w_lse, LSE_TOL))
        _close(f"{name} D {d} vs SDPA", out, lib())
        turns = _in_turns({"kernel": lambda: fn(q, k, v, sched),
                           "sdpa": lib}, 10)
        rows[name] = {
            "ms": turns["kernel"][0], "ms_turns": turns["kernel"][1],
            "library_ms": turns["sdpa"][0],
            "library_ms_turns": turns["sdpa"][1],
            "library": "SDPA is_causal forward, in turns",
            "device_ms": _device_ms(lambda: [fn(q, k, v, sched)
                                             for _ in range(10)], 10,
                                    name.split(".")[1]),
            "plain_ms": _median_ms(lambda: plain(q, k, v, sched, scale), 2,
                                   1),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "path": K.tile_body(q.dtype, 64, "fwd"),
            "shape": {"B": 1, "H": h, "Hkv": hkv, "S": s_len, "D": d,
                      "blk": 64, "kind": "ltm"}}
        del out, lse, again, w_out, w_lse
        torch.cuda.empty_cache()
    return rows


def _sdpa_backend(q, k, v, **kw) -> str:
    """The backend SDPA picks for these operands (PyTorch's own choice,
    torch._fused_sdp_choice), or why it could not be read."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not read ({type(e).__name__}: {e})"


def nemotron_train_rows(dev, K, SC, h, hkv, d, s_len):
    """Rows 6-9 of the kernel table at nemotron-4's attention shape: bwd dq
    and dk/dv at one dense layer (B 1, H h, Hkv hkv, S s_len, D d, ltm,
    blk 64, bf16) and packed_bwd dq and dk/dv on one s_len-row row of
    NEMOTRON_DOCS: each against its plain version at BF16_GRAD_TOL, twice
    bitwise, in turns with SDPA's autograd backward (causal, or the
    block-diagonal causal mask), its device time beside its bound (over
    the pairs the mask keeps). Returns {name: reading}."""
    import torch.nn.functional as F
    from repro_torch.kernels.tri_attn import ops as OPS

    rng = np.random.default_rng(28)
    blk, scale = 64, d ** -0.5
    q, do = (torch.as_tensor(rng.standard_normal((1, h, s_len, d),
                                                 np.float32),
                             device=dev).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((1, hkv, s_len, d),
                                                np.float32),
                            device=dev).to(torch.bfloat16) for _ in range(2))
    lens = [-(-n // blk) * blk for n in NEMOTRON_DOCS]
    if sum(lens) != s_len:
        _fail(f"nemotron documents pad to {sum(lens)} rows, not {s_len}")
    sched = OPS.make_sched(s_len, block=blk)
    psched = OPS.make_packed_sched(lens, block=blk)
    mask = torch.zeros((s_len, s_len), dtype=torch.bool, device=dev)
    base = 0
    for n_tok in lens:
        mask[base:base + n_tok, base:base + n_tok] = torch.ones(
            (n_tok, n_tok), dtype=torch.bool, device=dev).tril()
        base += n_tok
    cases = {
        "tri_attn.bwd": (K.fwd, K.bwd_dq, K.bwd_dkv, SC.dq_torch,
                         SC.dkv_torch, sched, dict(is_causal=True),
                         h * s_len * (s_len + 1) // 2, "tri_bwd",
                         {"kind": "ltm"}),
        "tri_attn.packed_bwd": (
            K.packed_fwd, K.packed_bwd_dq, K.packed_bwd_dkv,
            SC.packed_dq_torch, SC.packed_dkv_torch, psched,
            dict(attn_mask=mask), h * int(mask.sum()), "packed_bwd",
            {"kind": "ltm", "docs": list(NEMOTRON_DOCS),
             "member_lens": lens, "steps": psched.steps})}
    rows = {}
    for name, (fwd, dq_fn, dkv_fn, dq_plain, dkv_plain, sc, sdpa_kw, pairs,
               kern, extra) in cases.items():
        out, lse = fwd(q, k, v, sc)
        delta = (do.float() * out.float()).sum(dim=-1)
        del out
        run = {"dq": lambda: dq_fn(q, k, v, do, lse, delta, sc),
               "dkv": lambda: dkv_fn(q, k, v, do, lse, delta, sc)}
        got = {key: fn() for key, fn in run.items()}
        again = {key: fn() for key, fn in run.items()}
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(
                [got["dq"], *got["dkv"]], [again["dq"], *again["dkv"]])):
            _fail(f"{name} at D {d}: two runs on the same inputs differ")
        del again
        want = {"dq": dq_plain(q, k, v, do, lse, delta, sc, scale),
                "dkv": dkv_plain(q, k, v, do, lse, delta, sc, scale)}
        err = {"dq": _close(f"{name} D {d} dq", got["dq"], want["dq"],
                            BF16_GRAD_TOL),
               "dkv": max(_close(f"{name} D {d} dk", got["dkv"][0],
                                 want["dkv"][0], BF16_GRAD_TOL),
                          _close(f"{name} D {d} dv", got["dkv"][1],
                                 want["dkv"][1], BF16_GRAD_TOL))}
        plain = {"dq": _median_ms(lambda: dq_plain(q, k, v, do, lse, delta,
                                                   sc, scale), 2, 1),
                 "dkv": _median_ms(lambda: dkv_plain(q, k, v, do, lse,
                                                     delta, sc, scale), 2, 1)}
        del got, want
        bw = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        backend = _sdpa_backend(*bw, enable_gqa=True, **sdpa_kw)
        o_lib = F.scaled_dot_product_attention(*bw, enable_gqa=True,
                                               **sdpa_kw)
        sdpa_bwd = lambda: torch.autograd.grad(o_lib, bw, do,
                                               retain_graph=True)
        turns = _in_turns(dict(run, sdpa=sdpa_bwd), 10)
        bounds = RF.attn_bounds(q, k, pairs)
        for key in ("dq", "dkv"):
            row_name = f"{name}_{key}"
            rows[row_name] = {
                "ms": turns[key][0], "ms_turns": turns[key][1],
                "library_ms": turns["sdpa"][0],
                "library_ms_turns": turns["sdpa"][1],
                "library": f"SDPA autograd backward (dq, dk and dv "
                           f"together), backend {backend}",
                "device_ms": _device_ms(lambda: [run[key]()
                                                 for _ in range(10)], 10,
                                        f"{kern}_{key}"),
                "plain_ms": plain[key], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "max_abs_err": err[key],
                "path": K.tile_body(q.dtype, blk, "bwd"),
                "grid": list((K.bwd_grid if kern == "tri_bwd"
                              else K.packed_bwd_grid)(
                    key, sc, h if key == "dq" else hkv, 1, q.dtype)),
                "shape": dict({"B": 1, "H": h, "Hkv": hkv, "S": s_len,
                               "D": d, "blk": blk, "pairs": pairs},
                              **extra)}
        del o_lib, bw, lse, delta
        torch.cuda.empty_cache()
    return rows


def nemotron_phase(dev, card, K, tc_build):
    """nemotron-4-340b at its published widths (d_model 18432, 96 heads
    over 8 kv heads, head dim 192, relu2 d_ff 73728, vocab 256000), depth
    cut to NEMOTRON_CUT layers: first rows 1-9 of the kernel table at its
    attention shape (H 96, Hkv 8, D 192, bf16, blk 64; the serving
    members of the kernel phase, one layer at seq NEMOTRON_SEQ, the
    dense and packed backward at the training shapes) against their plain
    versions, timed beside SDPA and their bounds; then an engine of 2
    slots and 4 requests of 16-256 tokens, 16 new, split then fused
    (staggered budgets), every request done on the kernels, launches =
    NEMOTRON_CUT x the engine's, first-token logits within the bf16
    policy of a batch-1 prefill through the attention oracle; a
    make_prefill_step batch through tri_attn.fwd against the oracle's;
    then nemotron trained on the kernels (nemotron_training). Returns
    ({kernel name: its D 192 reading}, first-token errors, the training's
    readings)."""
    from repro_torch.configs import registry as REG
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.kernels.tri_attn import scan_impl as SC
    from repro_torch.obs import metrics as MET
    from repro_torch.serve import decode as D
    from repro_torch.serve.engine import Engine
    from repro_torch.train import train_step as TS

    full = REG.get_config("nemotron-4-340b")
    h, hkv, d = full.n_heads, full.n_kv_heads, full.head_dim
    t0 = time.perf_counter()
    ctx, rows = kernel_phase(dev, K, OPS, SC, h=h, hkv=hkv, d=d,
                             tag=f"nemotron D {d}")
    rows.append(fused_kernel_phase(dev, K, OPS, SC, D, ctx,
                                   tag=f"nemotron D {d}"))
    del ctx
    torch.cuda.empty_cache()
    readings = {row["name"]: row for row in rows}
    readings.update(nemotron_dense_rows(dev, K, SC, h, hkv, d,
                                        NEMOTRON_SEQ))
    readings.update(nemotron_train_rows(dev, K, SC, h, hkv, d,
                                        NEMOTRON_SEQ))
    for name, kern in (("tri_attn.packed_fwd", "packed_fwd_tc_kernel"),
                       ("tri_attn.fused_step_fwd",
                        "fused_step_kernel f32 cache"),
                       ("tri_attn.fwd", "tri_fwd_tc_kernel"),
                       ("tri_attn.fwd_bb", "fwd_bb_tc_kernel"),
                       ("tri_attn.bwd_dq", "tri_bwd_dq_tc_kernel"),
                       ("tri_attn.bwd_dkv", "tri_bwd_dkv_tc_kernel"),
                       ("tri_attn.packed_bwd_dq", "packed_bwd_dq_tc_kernel"),
                       ("tri_attn.packed_bwd_dkv",
                        "packed_bwd_dkv_tc_kernel")):
        readings[name]["ptxas"] = tc_build[(kern, 64, d)]
    torch.cuda.empty_cache()
    print(f"nemotron D {d} kernels ({time.perf_counter() - t0:.1f} s): "
          + "; ".join(
              f"{n} {r['ms']:.4f} ms (device {r.get('device_ms', 0):.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.6f} by "
              f"{r['bound_by']}, plain {r['plain_ms']:.2f}) err "
              f"{r['max_abs_err']:.3g}" for n, r in readings.items())
          + f"; card {card}", flush=True)

    cut = NEMOTRON_CUT
    cfg = dataclasses.replace(full, n_layers=cut)
    params = _arch_params(cfg, dev, f"nemotron-4-340b (cut to {cut} of "
                          f"{full.n_layers} layers)", card)
    ek = WIDE_ENGINE
    rng = np.random.default_rng(30)
    prompts = [p.astype(np.int32) for p in _rwkv_prompts(
        rng, ek["requests"], ek["lens"], cfg.vocab_size)]
    errs = {}
    for mode, budgets in (("split", [ek["max_new"]] * len(prompts)),
                          ("fused", list(NEMOTRON_BUDGETS))):
        eng = _probe_engine(Engine, params, cfg, step_mode=mode, device=dev,
                            **dict(ARCH_ENGINE, slots=ek["slots"],
                                   max_len=512))
        reg = MET.Registry(f"nemotron_{mode}")
        _reset_launches(K)
        with MET.scope(reg):
            results, wall = _serve(eng, prompts, budgets)
        st = _check_served(f"nemotron {mode}", eng, results,
                           range(len(prompts)), budgets, cfg)
        want = {"tri_attn.packed_decode_fwd":
                cut * st["decode_packed_launches"]}
        if mode == "split":
            want["tri_attn.packed_fwd"] = cut * st["prefill_launches"]
        else:
            want["tri_attn.fused_step_fwd"] = cut * st["fused_launches"]
            mixed = st["decode_rounds"] - st["decode_packed_launches"]
            if st["fused_fallbacks"] or mixed < 1:
                _fail(f"nemotron fused: fallbacks {st['fused_fallbacks']}, "
                      f"mixed rounds {mixed}")
        if not all(want.values()):
            _fail(f"nemotron {mode}: a kernel of the path never ran: "
                  f"{want}")
        launches = _check_launches(f"nemotron {mode}", K, reg, want)
        errs[mode], _, _ = _first_token_check(f"nemotron {mode}", eng,
                                              params, cfg, prompts)
        _served_line(f"nemotron {mode}", st, results,
                     [len(p) for p in prompts], wall, card,
                     f"; launches {launches} (= {cut} layers x the "
                     f"engine's); first-token logits of all {len(prompts)} "
                     f"requests vs batch-1 prefills through the oracle "
                     f"attention: max abs err {errs[mode]:.4g} (bf16 "
                     f"policy)")
        if mode == "split":
            eng.record = False
            for uid, n in enumerate((250, 40)):
                eng.submit(rng.integers(1, cfg.vocab_size, size=n),
                           max_new=12, uid=1000 + uid)
            eng.round()  # admit + first decode round, outside the window
            profile_rounds(eng, 4, "nemotron packed decode rounds (2 live "
                           "slots)", card)
            syncs = _host_syncs(lambda: [eng.round() for _ in range(2)])
            print(f"nemotron host syncs a decode round, by source file: "
                  f"{ {f: n / 2 for f, n in syncs.items()} }; card {card}",
                  flush=True)
            eng.run()
        del eng

    # the prefill step on the kernels (tri_attn.fwd at D 192) against the
    # attention oracle's, on one batch
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(2, 256)),
                           device=dev)
    reg = MET.Registry("nemotron_prefill")
    _reset_launches(K)
    with MET.scope(reg):
        got, _ = TS.make_prefill_step(cfg, attn_impl="cuda",
                                      cache_dtype=torch.float32)(
            params, {"tokens": toks})
        torch.cuda.synchronize()
    launches = _check_launches("nemotron prefill step", K, reg,
                               {"tri_attn.fwd": cut})
    want, _ = TS.make_prefill_step(cfg, attn_impl="ref",
                                   cache_dtype=torch.float32)(
        params, {"tokens": toks})
    errs["prefill_step"] = _close("nemotron prefill step logits", got, want,
                                  _logit_tol(want))
    del params
    torch.cuda.empty_cache()

    print(f"nemotron-4-340b: prefill step of 2 x 256 tokens on the kernels, "
          f"launches {launches}, logits vs the oracle attention's max abs "
          f"err {errs['prefill_step']:.4g} (bf16 policy); card {card}",
          flush=True)
    train = nemotron_training(dev, card, K, full)
    print(f"nemotron phase {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    return readings, errs, train


def _attn_weight_grads(grads) -> dict:
    """Copies of the attention weights' per-layer grads of a train-step
    grad tree (``train_step.trainable``'s layout)."""
    out = {}
    for kind, layer in grads["layers"].items():
        for name in NEMOTRON_ATTN_WEIGHTS:
            for l, g in enumerate(layer["mixer"][name]):
                out[f"{kind}.{l}.{name}"] = g.detach().clone()
    return out


def _adafactor_whole_leaf(opt, p, g):
    """The reference's Adafactor step at step 0 (beta2_t = 0) of one
    factored (rows, cols) leaf alone, in float32 on whole tensors: its own
    global clip, row and column means, the RMS clip, weight decay.
    Returns (u, vr, vc), u the step in units of the learning rate (p
    becomes p - lr u)."""
    g = g.float()
    norm = torch.sqrt(torch.sum(g * g))
    g = g * torch.clamp(opt.grad_clip / torch.clamp(norm, min=1e-12),
                        max=1.0)
    g2 = g * g + 1e-30
    vr, vc = g2.mean(dim=-1), g2.mean(dim=-2)
    del g2
    u = g / (torch.sqrt(vr / vr.mean())[:, None] * torch.sqrt(vc)[None, :]
             + 1e-30)
    del g
    rms = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp(rms / opt.clip_threshold, min=1.0)
    return u + opt.weight_decay * p, vr, vc


def nemotron_training(dev, card, K, full):
    """nemotron-4-340b at published widths, depth cut to NEMOTRON_TRAIN_CUT
    layers, bf16 weights, blk 64, remat, Adafactor, microbatches 1: 3
    dense steps of one NEMOTRON_SEQ-token row through tri_attn.fwd and the
    D 192 bwd dq and dk/dv, then 3 packed steps of one row of
    NEMOTRON_DOCS through packed_fwd and the packed dq and dk/dv. Before
    each run, the same first step through impl "ref" (the masked oracle
    attention) from the same weights: its loss and attention weights'
    grads against the kernels' first step at the bf16 policy. Launches
    asserted, losses finite and falling, step times, real tokens/s and
    peak memory, a profiler window over a fourth step (outside the
    launch counts; the dense run's attributed by region,
    roofline/attribution.py); then the first step's chunked Adafactor
    update of the layer's attention wo against a whole-leaf float32
    Adafactor on the card. Returns the readings."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.roofline import attribution as ATTR
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    t0 = time.perf_counter()
    cut, steps, blk = NEMOTRON_TRAIN_CUT, NEMOTRON_TRAIN_STEPS, 64
    cfg = dataclasses.replace(full, n_layers=cut)
    opt = OPT.OptConfig(**NEMOTRON_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(state.params))
    state_gb = torch.cuda.memory_allocated() / 1e9
    opt_mb = sum(x.numel() * 4 for x in _leaves(state.opt_state)) / 1e6
    print(f"nemotron train: {cut} of {full.n_layers} layers at published "
          f"widths, {n_params / 1e9:.3f} B parameters, {state_gb:.2f} GB of "
          f"bf16 weights and Adafactor state ({opt_mb:.1f} MB of it the "
          f"factored statistics) in {time.perf_counter() - t0:.1f} s; "
          f"{NEMOTRON_OPT}, microbatches 1, remat, blk {blk}", flush=True)
    dense = DATA.SyntheticLM(cfg, ShapeConfig("nemotron_train", NEMOTRON_SEQ,
                                              1, "train"),
                             seed=0, device=dev).batch(0)
    docs = DATA.PackedDocsLM(cfg, NEMOTRON_DOCS, block=blk, seed=0,
                             device=dev)
    psched = OPS.make_packed_sched(docs.member_lens, block=blk)
    runs = {"dense": (dense, None, NEMOTRON_SEQ,
                      {"tri_attn.fwd": 2 * cut * steps,
                       "tri_attn.bwd_dq": cut * steps,
                       "tri_attn.bwd_dkv": cut * steps}),
            "packed": (docs.batch(0), psched, sum(NEMOTRON_DOCS),
                       {"tri_attn.packed_fwd": 2 * cut * steps,
                        "tri_attn.packed_bwd_dq": cut * steps,
                        "tri_attn.packed_bwd_dkv": cut * steps})}
    seen, readings = {}, {}
    real_apply = OPT.apply_updates
    wo_of = lambda t: t["layers"]["l0"]["mixer"]["wo"][0]

    def spy(opt_, params, grads, opt_state, step, **kw):
        if "grads" not in seen:  # the run's first step
            seen["grads"] = _attn_weight_grads(grads)
            seen.setdefault("wo", (wo_of(params).detach().float().clone(),
                                   wo_of(grads).detach().clone(), step))
        return real_apply(opt_, params, grads, opt_state, step, **kw)

    for run, (batch, packed, real, want) in runs.items():
        # the first step through the oracle attention, from the same weights
        views = TS.trainable(state.params)
        ref_loss = MD.loss_fn(views, cfg, batch, attn_impl="ref",
                              remat=True, block=blk, packed=packed)[0]
        ref_loss.backward()
        ref_grads = _attn_weight_grads(TS.grads_of(views))
        # the graph's leaves hold every grad (25.8 GB): nothing may keep it
        ref_loss = float(ref_loss.detach())
        del views
        torch.cuda.empty_cache()
        step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                                  block=blk, packed=packed)
        times, first = [], int(state.step)
        seen.pop("grads", None)
        reg = MET.Registry(f"nemotron_train_{run}")
        OPT.apply_updates = spy
        # the peak since the phase began (the oracle pass's included), and
        # the steps' own, which the dry-run reckons (roofline_phase); of
        # this script's check tensors, the oracle's grads and the spy's
        # copies live through the steps beside the step's own (checks_gb)
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            _reset_launches(K)
            with MET.scope(reg):
                state, log = FT.run_training(state, _timed(step, times),
                                             lambda i: batch, first + steps)
            launches = _check_launches(f"nemotron {run} train", K, reg, want)
        finally:
            OPT.apply_updates = real_apply
        steps_peak = torch.cuda.max_memory_allocated() / 1e9
        peak = max(before / 1e9, steps_peak)
        checks = sum(x.numel() * x.element_size() for x in
                     [*ref_grads.values(), *seen["grads"].values(),
                      *seen["wo"][:2]])
        losses = [m["loss"] for m in log]
        if len(losses) != steps or not all(np.isfinite(losses)) or not all(
                b < a for a, b in zip(losses, losses[1:])):
            _fail(f"nemotron {run} train: losses {losses} not finite and "
                  f"falling")
        if not np.isclose(losses[0], ref_loss, rtol=PAD_LOSS_RTOL, atol=0):
            _fail(f"nemotron {run} train: first loss {losses[0]} against "
                  f"the oracle attention's {ref_loss} (rtol "
                  f"{PAD_LOSS_RTOL})")
        errs = {}
        for key, want_g in ref_grads.items():
            scale = max(1e-30, float(want_g.float().abs().max()))
            tol = dict(BF16_GRAD_TOL, atol=BF16_GRAD_TOL["atol"] * scale)
            errs[key] = _close(f"nemotron {run} first-step grad {key}",
                               seen["grads"][key], want_g, tol) / scale
        del ref_grads
        seen.pop("grads")
        readings[run] = {
            "losses": losses, "oracle_first_loss": ref_loss,
            "grad_norms": [m["grad_norm"] for m in log],
            "step_s": times, "real_tokens": real,
            "tokens_per_s": real / statistics.median(times),
            "peak_gb": peak, "steps_peak_gb": steps_peak,
            "checks_gb": checks / 1e9,
            "launches": launches,
            "attn_grad_err_over_max": errs}
        print(f"nemotron {run} train: {steps} Adafactor steps on one "
              f"{batch['tokens'].shape[1]}-token row ({real} real tokens"
              + (f", {len(NEMOTRON_DOCS)} documents, {psched.steps} tiles "
                 f"a head" if packed is not None else "")
              + f"), losses {losses} (the oracle attention's first "
              f"{ref_loss:.6f}), grad norms {readings[run]['grad_norms']}; "
              f"first-step attention grads vs the oracle's, max abs err / "
              f"max |grad|: { {k: round(v, 5) for k, v in errs.items()} }; "
              f"step times {times} s, {readings[run]['tokens_per_s']:.1f} "
              f"real tokens/s (median step); peak memory {peak:.2f} GB "
              f"(the steps' own {steps_peak:.2f}) of "
              f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f};"
              f" launches {launches}; card {card}", flush=True)
        if run == "dense":
            # the attribution of one more step, in this process (the
            # window is held to the wrappers' launches or refused)
            prof, counts, wall_ms = ATTR.window(lambda: step(state, batch),
                                                K.WRAPPERS)
            try:
                readings[run]["attribution"] = ATTR.attribute(prof, counts,
                                                              wall_ms)
            except ATTR.WindowRefused as e:
                _fail(f"nemotron dense train: attribution refused: {e}")
            del prof
        else:
            profile_window(lambda: step(state, batch), 1, "step",
                           f"nemotron {run} training step", card)
    p0, g0, step0 = seen.pop("wo")
    del state
    torch.cuda.empty_cache()
    # the first dense step's update of the layer's wo: the port's chunked
    # Adafactor (CHUNK elements a temporary) against the whole leaf. The
    # step itself is held, in units of the learning rate: at the run's lr
    # (lr u about 3e-6 against |p| about 0.02) p's own rounding would hide
    # a wrong clip or rfac, so this update runs at a learning rate of
    # about 1, where p - lr u rounds to 1e-7 of the step
    p = {"layers": {"wo": p0[None].clone()}}
    st = OPT.init_opt_state(p, opt)
    unit = dataclasses.replace(opt, lr=opt.lr / OPT.schedule(opt, step0))
    lr1 = OPT.schedule(unit, step0)
    OPT.apply_updates(unit, p, {"layers": {"wo": [g0]}}, st, step0)
    want_u, want_vr, want_vc = _adafactor_whole_leaf(opt, p0, g0)
    got_u = (p0 - p["layers"]["wo"][0]) / lr1
    wo_err = max(
        _close("nemotron wo Adafactor step vs the whole leaf's", got_u,
               want_u, dict(atol=1e-6, rtol=1e-5)),
        _close("nemotron wo vr", st["vr"]["layers"]["wo"][0], want_vr,
               dict(atol=0, rtol=1e-5)),
        _close("nemotron wo vc", st["vc"]["layers"]["wo"][0], want_vc,
               dict(atol=0, rtol=1e-5)))
    chunks = -(-p0.shape[0] // max(1, OPT.CHUNK // p0.shape[1]))
    readings["wo_adafactor"] = {"shape": list(p0.shape), "chunks": chunks,
                                "max_abs_err": wo_err}
    readings["seconds"] = time.perf_counter() - t0
    print(f"nemotron Adafactor: the first step's update of wo "
          f"{tuple(p0.shape)} in {chunks} chunks of rows against the whole "
          f"leaf in float32 on the card: max abs err {wo_err:.3g} of the "
          f"step (in units of lr), vr and vc (f32 "
          f"tolerance); training {readings['seconds']:.1f} s; card {card}",
          flush=True)
    del p, st, got_u, want_u, p0, g0
    torch.cuda.empty_cache()
    return readings


def smoke_archs_phase(dev):
    """Each new arch's smoke config in float32, and nemotron's at head dim
    192 (2 layers, 2 heads of 192 over 1 kv head): an engine on the
    kernels emits the plain versions' tokens on the card (nemotron's relu2
    and granite-moe's experts included)."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine

    done = []
    archs = [(arch, REG.smoke_config(arch)) for arch in (
        "granite-moe-3b-a800m", "mixtral-8x7b", "granite-34b",
        "llama3-405b", "musicgen-large", "internvl2-1b", "nemotron-4-340b")]
    # nemotron's head dim on the forward and decode bodies at smoke size
    archs.append(("nemotron-4-340b D 192", dataclasses.replace(
        archs[-1][1], n_layers=2, n_heads=2, n_kv_heads=1, head_dim=192)))
    for arch, cfg in archs:
        params = MD.init_params(cfg, seed=3, device=dev)
        rng = np.random.default_rng(29)
        # the mixtral prompt crosses its smoke window of 64
        lens = (80, 5, 30, 1, 12) if cfg.sliding_window else (20, 5, 30, 1)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        budgets = [6] * len(prompts)
        got = {}
        for impl in ("cuda", "torch"):
            eng = Engine(params, cfg, slots=2, max_len=128,
                         prefill_impl=impl, decode_impl=impl,
                         decode_mode="packed", device=dev)
            got[impl], _ = _serve(eng, prompts, budgets)
            _check_served(f"{arch} smoke engine ({impl})", eng, got[impl],
                          range(len(prompts)), budgets, cfg)
        if got["cuda"] != got["torch"]:
            _fail(f"{arch} smoke: kernel engine {got['cuda']} != plain "
                  f"engine {got['torch']}")
        done.append(arch)
    print(f"smoke archs: float32 engines (2 slots, slots reused, a 1-token "
          f"prompt) on the kernels emit the plain versions' tokens for "
          f"{', '.join(done)}", flush=True)


def other_archs_phase(dev, card, K, tc_build):
    """Phase 7e: the registry's other seven architectures on the card.
    Returns nemotron's D 192 kernel readings and its training's."""
    t0 = time.perf_counter()
    moe_errs = granite_moe_phase(dev, card, K)
    mix_errs = mixtral_phase(dev, card, K)
    wide_errs = wide_gqa_phase(dev, card, K)
    frontend_training_phase(dev, card, K)
    d192, nem_errs, nem_train = nemotron_phase(dev, card, K, tc_build)
    smoke_archs_phase(dev)
    arch_cli_phase(K)
    print(json.dumps({"other_archs": {
        "seconds": round(time.perf_counter() - t0, 1),
        "first_token_max_abs_err": dict(
            {f"granite-moe {m}": e for m, e in moe_errs.items()},
            **{f"nemotron {m}": e for m, e in nem_errs.items()},
            **wide_errs), "mixtral_window_max_abs_err": mix_errs,
        "nemotron_train": nem_train}}), flush=True)
    return d192, nem_train


def arch_cli_phase(K):
    """launch/serve.py --arch granite-moe-3b-a800m on the card."""
    from repro_torch.launch import serve as SERVE

    _reset_launches(K)
    results, eng = SERVE.main(["--arch", "granite-moe-3b-a800m",
                               "--requests", "6", "--max-new", "8"])
    report = eng.report()
    if sorted(results) != list(range(6)) or any(
            r["status"] != "done" or r["tokens"] != 8
            for r in report.values()) or not (
            K.packed_fwd.launches and K.packed_decode_fwd.launches):
        _fail(f"serve CLI (granite-moe): {report}, launches {_launches(K)}")
    print("serve CLI: python -m repro_torch.launch.serve --arch "
          "granite-moe-3b-a800m served 6 requests through the kernels",
          flush=True)


def serve_cli_phase():
    """The serving CLI (launch/serve.py) on the card at smoke size: in both
    step modes on its default decode mode (auto), and in split mode with
    --decode-mode packed. Every request done, admission through the
    kernels, one packed_decode_fwd launch a layer for each round sent
    packed (the others on the lockstep einsum); the packed run must
    launch the decode kernel every round; no plain version. Prints each
    run's packed and lockstep rounds."""
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.launch import serve as SERVE

    rounds = {}
    for mode, decode, kernel in (
            ("split", "auto", "tri_attn.packed_fwd"),
            ("fused", "auto", "tri_attn.fused_step_fwd"),
            ("split", "packed", "tri_attn.packed_fwd")):
        label = f"serve CLI ({mode}, decode {decode})"
        _reset_launches(K)
        results, eng = SERVE.main(["--requests", "6", "--max-new", "8",
                                   "--step-mode", mode]
                                  + (["--decode-mode", decode]
                                     if decode != "auto" else []))
        report = eng.report()
        st = eng.stats
        if sorted(results) != list(range(6)) or any(
                r["status"] != "done" or r["tokens"] != 8
                for r in report.values()):
            _fail(f"{label}: {report}")
        packed = st["decode_packed_launches"]
        if eng.decode_mode != decode or not K.WRAPPERS[kernel].launches or \
                K.packed_decode_fwd.launches != eng.cfg.n_layers * packed or \
                (decode == "packed" and not 0 < packed == st["decode_rounds"]):
            _fail(f"{label}: launches {_launches(K)}, decode "
                  f"{eng.decode_mode} packed {packed} lockstep "
                  f"{st['decode_lockstep_launches']} of "
                  f"{st['decode_rounds']} rounds")
        rounds[f"{mode}/{decode}"] = (packed, st["decode_lockstep_launches"])
    print("serve CLI: python -m repro_torch.launch.serve served 6 requests "
          "through the kernels in split and fused step modes (decode auto) "
          "and split with --decode-mode packed; decode rounds (packed, "
          f"lockstep): {rounds}", flush=True)


def _timed(step, times: list):
    """``step`` with its wall time (synchronized) appended to ``times``."""
    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    return timed_step


def _check_launches(label, K, reg, want_nonzero: dict) -> dict:
    """Every wrapper's count equals ``want_nonzero`` (0 for the others)
    and no plain version ran; returns the nonzero counts."""
    launches = _launches(K)
    want = dict.fromkeys(launches, 0)
    want.update(want_nonzero)
    plain = {n: reg.counter_value("launches_total", {"name": n,
                                                     "impl": "torch"})
             for n in want}
    if launches != want or any(plain.values()):
        _fail(f"{label}: kernel launches {launches} != {want}, or plain "
              f"versions ran {plain}")
    return dict(want_nonzero)


def train_phase(dev, layers: int, card, K, OPS):
    """yi-9b at full width, ``layers`` deep, for 3 training steps of seq
    4096 through the kernels, then 3 packed document steps on the same
    state; returns each kernel's launches on the dense and on the packed
    path."""
    from repro_torch.configs import yi_9b
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.obs import metrics as MET
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(yi_9b.CONFIG, n_layers=layers)
    seq, steps = 4096, 3
    print(f"train: depth cut to {layers} of {yi_9b.CONFIG.n_layers} layers "
          f"(12 bytes a parameter of bf16 weights and grads and f32 AdamW "
          f"moments: all 48 layers need ~106 GB)", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = OPT.OptConfig()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, opt, seed=0, device=dev)
    n_params = sum(x.numel() for x in _leaves(state.params))
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"train: yi-9b {layers}L d_model={cfg.d_model} H={cfg.n_heads} "
          f"Hkv={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B params, {state_gb:.2f} GB of weights and "
          f"AdamW moments in {time.perf_counter() - t0:.1f} s", flush=True)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("train_4k", seq, 1, "train"),
                          seed=0, device=dev)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                              block=64)
    times = []
    reg = MET.Registry("train_phase")
    _reset_launches(K)
    with MET.scope(reg):
        state, log = FT.run_training(state, _timed(step, times), ds.batch,
                                     steps)
    launches = _check_launches(
        "train", K, reg, {"tri_attn.fwd": 2 * layers * steps,
                          "tri_attn.bwd_dq": layers * steps,
                          "tri_attn.bwd_dkv": layers * steps})
    losses = [m["loss"] for m in log]
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            min(losses) <= 0:
        _fail(f"train: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train: {steps} steps of {seq} tokens, losses {losses}, grad "
          f"norms {[m['grad_norm'] for m in log]}; step times {times} s, "
          f"{seq / statistics.median(times):.1f} trained tokens/s (median "
          f"step); peak memory {peak_gb:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} "
          f"(state {state_gb:.2f}); launches {launches}; card {card}",
          flush=True)
    profile_window(lambda: step(state, ds.batch(steps)), 1, "step",
                   "training step", card)
    packed_launches = packed_train(cfg, opt, state, card, K, OPS)
    del state
    torch.cuda.empty_cache()
    return launches, packed_launches


def packed_train(cfg, opt, state, card, K, OPS):
    """Packed document training on the train phase's state (the 24-layer
    state is reused: a second one does not fit): 3 steps of PackedDocsLM
    rows of TRAIN_DOCS through packed_fwd and the packed dq and dk/dv, a
    profiler window over a fourth, then one forward+backward of the packed
    row and of the pad-to-max batch on the same parameters. Returns the
    kernels' launches over the 3 steps."""
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import train_step as TS

    layers, blk, steps = cfg.n_layers, 64, 3
    dev = state.params["embed"].device
    docs = DATA.PackedDocsLM(cfg, TRAIN_DOCS, block=blk, seed=0, device=dev)
    psched = OPS.make_packed_sched(docs.member_lens, block=blk)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                              block=blk, packed=psched)
    real = sum(TRAIN_DOCS)
    times = []
    first = int(state.step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reg = MET.Registry("packed_train")
    _reset_launches(K)
    with MET.scope(reg):
        state, log = FT.run_training(state, _timed(step, times), docs.batch,
                                     first + steps)
    launches = _check_launches(
        "packed train", K, reg,
        {"tri_attn.packed_fwd": 2 * layers * steps,
         "tri_attn.packed_bwd_dq": layers * steps,
         "tri_attn.packed_bwd_dkv": layers * steps})
    losses = [m["loss"] for m in log]
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            min(losses) <= 0:
        _fail(f"packed train: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"packed train: {steps} steps of one {docs.s_total}-row packed "
          f"row ({len(TRAIN_DOCS)} documents, {real} real tokens, "
          f"{psched.steps} tiles a head against {len(TRAIN_DOCS)} x "
          f"{max(docs.member_lens) // blk}^2 = "
          f"{len(TRAIN_DOCS) * (max(docs.member_lens) // blk) ** 2} "
          f"pad-to-max), losses {losses}; step times {times} s, "
          f"{real / statistics.median(times):.1f} real tokens/s (median "
          f"step); peak memory {peak_gb:.2f} GB; launches {launches}; card "
          f"{card}", flush=True)
    profile_window(lambda: step(state, docs.batch(first + steps)), 1,
                   "step", "packed training step", card)

    def fwd_bwd(batch, packed):
        views = TS.trainable(state.params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = MD.loss_fn(views, cfg, batch, attn_impl="cuda",
                             remat=True, block=blk, packed=packed)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    packed_loss, packed_s = fwd_bwd(docs.batch(first + steps + 1), psched)
    padded = docs.padded_batch(first + steps + 1)
    reg = MET.Registry("padded")
    _reset_launches(K)
    with MET.scope(reg):
        padded_loss, padded_s = fwd_bwd(padded, None)
    _check_launches("padded fwd+bwd", K, reg,
                          {"tri_attn.fwd": 2 * layers,
                           "tri_attn.bwd_dq": layers,
                           "tri_attn.bwd_dkv": layers})
    if not np.isclose(packed_loss, padded_loss, rtol=PAD_LOSS_RTOL, atol=0):
        _fail(f"packed loss {packed_loss} != pad-to-max loss {padded_loss} "
              f"(rtol {PAD_LOSS_RTOL})")
    print(f"packed vs pad-to-max, same parameters and documents: forward+"
          f"backward {packed_s:.4f} s packed ({docs.s_total} rows) against "
          f"{padded_s:.4f} s pad-to-max ({tuple(padded['tokens'].shape)}); "
          f"losses {packed_loss} and {padded_loss} (rtol {PAD_LOSS_RTOL}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"card {card}", flush=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def smoke_training(dev):
    """Smoke-size float32 training on the card: the kernels against the
    plain versions over 3 steps, the loss falling over 20, and a resumed
    run bitwise equal to an unbroken one."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("t", 64, 4, "train"), seed=0,
                          device=dev)
    base = TS.init_state(cfg, opt, seed=0, device=dev)
    steps = {impl: TS.make_train_step(cfg, opt, attn_impl=impl, block=16)
             for impl in ("cuda", "torch")}
    losses = {impl: [m["loss"] for m in FT.run_training(
        copy.deepcopy(base), fn, ds.batch, 3)[1]]
        for impl, fn in steps.items()}
    # f32 on both sides, sums in other orders: 1e-5 relative at most
    if not np.allclose(losses["cuda"], losses["torch"], rtol=1e-5, atol=0):
        _fail(f"smoke training: kernel losses {losses['cuda']} != plain "
              f"{losses['torch']}")
    _, log = FT.run_training(copy.deepcopy(base), steps["cuda"], ds.batch,
                             20)
    if not log[-1]["loss"] < log[0]["loss"] - 0.5:
        _fail(f"smoke training: 20 steps did not lower the loss: "
              f"{[m['loss'] for m in log]}")
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    straight, _ = FT.run_training(copy.deepcopy(base), steps["cuda"],
                                  ds.batch, 6)
    FT.run_training(copy.deepcopy(base), steps["cuda"], ds.batch, 3,
                    manager=CKPT.CheckpointManager(str(ckpt), every=3))
    resumed, _ = CKPT.restore(str(ckpt), base, device=dev)
    resumed, _ = FT.run_training(resumed, steps["cuda"], ds.batch, 6)
    shutil.rmtree(ckpt)
    pairs = list(zip(_leaves({"p": straight.params, "o": straight.opt_state}),
                     _leaves({"p": resumed.params, "o": resumed.opt_state})))
    if resumed.step != straight.step or \
            not all(torch.equal(a, b) for a, b in pairs):
        _fail("smoke training: 3 + checkpoint + restore + 3 steps differ "
              "from 6 straight steps")
    print(f"smoke training: float32, 3 steps kernels {losses['cuda']} vs "
          f"plain {losses['torch']}; 20 steps {log[0]['loss']:.4f} -> "
          f"{log[-1]['loss']:.4f}; 6 steps straight == 3 + checkpoint + "
          f"restore + 3, bitwise over {len(pairs)} tensors", flush=True)
    smoke_packed_training(dev, cfg, opt, base)


def smoke_packed_training(dev, cfg, opt, base):
    """Smoke-size float32 packed document training on the card: 3 steps
    with the kernels and with the plain versions agree, and the packed
    row's loss equals the pad-to-max batch's on the same parameters."""
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.models import model as MD
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import train_step as TS

    blk = 16
    docs = DATA.PackedDocsLM(cfg, (61, 9, 30, 17, 3), block=blk, seed=0,
                             device=dev)
    psched = OPS.make_packed_sched(docs.member_lens, block=blk)
    losses = {impl: [m["loss"] for m in FT.run_training(
        copy.deepcopy(base), TS.make_train_step(
            cfg, opt, attn_impl=impl, block=blk, packed=psched),
        docs.batch, 3)[1]] for impl in ("cuda", "torch")}
    # f32 on both sides, sums in other orders: 1e-5 relative at most
    if not np.allclose(losses["cuda"], losses["torch"], rtol=1e-5, atol=0):
        _fail(f"smoke packed training: kernel losses {losses['cuda']} != "
              f"plain {losses['torch']}")
    with torch.no_grad():
        packed, padded = (MD.loss_fn(base.params, cfg, batch, block=blk,
                                     packed=ps)[0].item()
                          for batch, ps in ((docs.batch(0), psched),
                                            (docs.padded_batch(0), None)))
    if not np.isclose(packed, padded, rtol=1e-5, atol=0):
        _fail(f"smoke packed training: packed loss {packed} != pad-to-max "
              f"{padded}")
    print(f"smoke packed training: float32, 3 steps kernels "
          f"{losses['cuda']} vs plain {losses['torch']}; packed loss "
          f"{packed} == pad-to-max {padded} (rtol 1e-5)", flush=True)


# phase 8b: yi-9b's depth for compressed training, cut to this many of
# its 48 layers; the dry-run must reckon the compressed step within
# COMPRESSED_FIT_BYTES of the card's 80 GB (bf16 params, float32 grads
# (the hook takes float32 grads), AdamW moments and err_state: 18 bytes a
# parameter), or the script fails
COMPRESSED_LAYERS = 16
COMPRESSED_FIT_BYTES = 72e9
# the stacked leaves whose codes the first compressed step checks: one
# attention and one MLP leaf
CODEC_LEAVES = ("layers.l0.mixer.wk", "layers.l0.ffn.wo")


def _leaf(tree, key: str):
    for part in key.split("."):
        tree = tree[part]
    return tree


class _CodecSpy:
    """A compressed_allreduce hook around ``hook``: CUDA events around
    each call (the codec and its all-reduce), and on the first call host
    copies of CODEC_LEAVES' grads and errors before it and of their
    dequantized grads and new errors after it (on the host, so the
    device's peak is the step's own)."""

    def __init__(self, hook):
        self.hook, self.events, self.copies = hook, [], None

    def __call__(self, grads, err):
        first = self.copies is None
        if first:
            self.copies = {k: {"g": [g.to("cpu", copy=True)
                                     for g in _leaf(grads, k)],
                               "e": _leaf(err, k).to("cpu", copy=True)}
                           for k in CODEC_LEAVES}
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        grads, err = self.hook(grads, err)
        ev[1].record()
        self.events.append(ev)
        if first:
            for k, c in self.copies.items():
                c["deq"] = [g.to("cpu", copy=True) for g in _leaf(grads, k)]
                c["new_e"] = _leaf(err, k).to("cpu", copy=True)
        return grads, err

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _check_codes(key: str, c: dict, dev) -> dict:
    """The first compressed step's code of one stacked leaf, layer by
    layer on the card from the host copies, with the scale max|g + err|
    over the whole stack / 127: every dequantized grad is q x that scale
    (bitwise) for an integer q within +-127 (127 reached; so the leaf was
    coded with that one scale), |new err| <= scale / 2 (+ the rounding of
    q x scale), and dequant + new err equals g + err within one float32
    ulp."""
    amax = None
    for g, e in zip(c["g"], c["e"]):
        m = torch.max(torch.abs(g.to(dev) + e.to(dev)))
        amax = m if amax is None else torch.maximum(amax, m)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    s = float(scale)
    bound = s / 2 + float(np.finfo(np.float32).eps) * 127 * s
    q_max, err_max, ulps = 0.0, 0.0, 0.0
    for g, e, deq, ne in zip(c["g"], c["e"], c["deq"], c["new_e"]):
        t = g.to(dev) + e.to(dev)
        deq, ne = deq.to(dev), ne.to(dev)
        q = torch.round(deq / scale)
        if not torch.equal(q * scale, deq) or float(q.abs().max()) > 127:
            _fail(f"compressed train: {key}: a dequantized grad is not q x "
                  f"scale for an integer q within +-127")
        q_max = max(q_max, float(q.abs().max()))
        err_max = max(err_max, float(ne.abs().max()))
        ulp = torch.nextafter(t.abs(), torch.tensor(float("inf"),
                                                    device=dev)) - t.abs()
        ulps = max(ulps, float(((deq + ne - t).abs() / ulp).max()))
    if q_max != 127 or err_max > bound or ulps > 1:
        _fail(f"compressed train: {key}: max |q| {q_max}, max |new err| "
              f"{err_max} against {bound}, dequant + new err off g + err "
              f"by {ulps} ulps")
    return {"scale": s, "layers": len(c["g"]), "max_err_over_scale":
            err_max / s, "max_ulps": ulps}


def compressed_train_phase(dev, card, K) -> dict:
    """Phase 8b: data-parallel training over an NCCL group of one rank
    (launch/mesh.init_data_group) with the int8 error-feedback grad
    all-reduce (parallel/compression.py): yi-9b at full width, cut to
    COMPRESSED_LAYERS (the dry-run's reckoning printed first), 3 plain then
    3 compressed steps on one state; the launches, the first compressed
    step's codes, the peak against the dry-run's; then smoke-size float32
    runs and the trainer CLI with --compress-grads. Returns the compressed
    steps' launches."""
    import torch.distributed as dist

    from repro_torch.configs import yi_9b
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch import mesh as MESH
    from repro_torch.obs import metrics as MET
    from repro_torch.parallel import compression as C
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    t0 = time.perf_counter()
    seq, steps = 4096, 3
    shape = ShapeConfig("train_4k", seq, 1, "train")
    opt = OPT.OptConfig()
    layers = COMPRESSED_LAYERS
    cfg = dataclasses.replace(yi_9b.CONFIG, n_layers=layers)
    reckoned = DRY.count_cell(cfg, shape, opt=opt,
                              compression=True)["analysis"]["memory"]
    print(f"compressed train: the dry-run reckons yi-9b {layers} of "
          f"{yi_9b.CONFIG.n_layers} layers, seq {seq}, batch 1, AdamW, int8 "
          f"EF at {reckoned['peak_bytes_per_device'] / 1e9:.2f} GB "
          f"({_split_gb(reckoned['peak_split'])})", flush=True)
    if reckoned["peak_bytes_per_device"] > COMPRESSED_FIT_BYTES:
        _fail(f"compressed train: the dry-run reckons "
              f"{reckoned['peak_bytes_per_device'] / 1e9:.2f} GB, over "
              f"{COMPRESSED_FIT_BYTES / 1e9:.0f} GB")
    group = MESH.init_data_group(dev)
    try:
        torch.cuda.empty_cache()
        state = TS.init_state(cfg, opt, seed=0, device=dev, compression=True)
        n_params = sum(x.numel() for x in _leaves(state.params))
        ds = DATA.SyntheticLM(cfg, shape, seed=0, device=dev)
        spy = _CodecSpy(C.make_compressed_allreduce(group))
        runs = {}
        want = {"tri_attn.fwd": 2 * layers * steps,
                "tri_attn.bwd_dq": layers * steps,
                "tri_attn.bwd_dkv": layers * steps}
        for mode, hook in (("plain", None), ("compressed", spy)):
            step = TS.make_train_step(cfg, opt, attn_impl="cuda",
                                      remat=True, block=64,
                                      compressed_allreduce=hook)
            times = []
            reg = MET.Registry(f"{mode}_dp_train")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(K)
            with MET.scope(reg):
                state, log = FT.run_training(state, _timed(step, times),
                                             ds.batch, state.step + steps)
            launches = _check_launches(f"{mode} DP train", K, reg, want)
            losses = [m["loss"] for m in log]
            if len(losses) != steps or not all(np.isfinite(losses)):
                _fail(f"{mode} DP train: losses {losses}")
            runs[mode] = {"times": times, "losses": losses,
                          "peak": torch.cuda.max_memory_allocated(),
                          "launches": launches}
        codes = {k: _check_codes(k, spy.copies[k], dev)
                 for k in CODEC_LEAVES}
        spy.copies = {}
        if not any(float(t.abs().max()) > 0
                   for t in _leaves(state.err_state)):
            _fail("compressed train: the error state stayed zero")
        codec_ms = spy.ms()
        del state
        torch.cuda.empty_cache()
        comp = runs["compressed"]
        ratio = _peak_line(f"yi-9b {layers}L compressed DP step", reckoned,
                           comp["peak"], card)
        print(f"compressed train: yi-9b {layers}L, {n_params / 1e9:.3f} B "
              f"params, NCCL group of {dist.get_world_size(group)}: median "
              f"step {statistics.median(runs['plain']['times']):.4f} s plain "
              f"(times {runs['plain']['times']}), "
              f"{statistics.median(comp['times']):.4f} s compressed (times "
              f"{comp['times']}; the first copies two leaves to the host); "
              f"the codec and its all-reduce {statistics.median(codec_ms):.2f}"
              f" ms a step (CUDA events, {codec_ms}); losses "
              f"{runs['plain']['losses']} then {comp['losses']}; peak "
              f"{runs['plain']['peak'] / 1e9:.2f} / {comp['peak'] / 1e9:.2f} "
              f"GB (ratio {ratio:.4f}); launches {comp['launches']} a mode, "
              f"no plain version; codes {codes}; card {card}", flush=True)
        smoke_compressed_training(dev, group)
    finally:
        dist.destroy_process_group()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--compress-grads",
         "--steps", "4"], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                            / "src")))
    if run.returncode or "[int8-EF grad AR]" not in run.stdout or \
            "done: 4 steps" not in run.stdout:
        _fail(f"train CLI --compress-grads failed (rc {run.returncode}): "
              f"{run.stdout[-2000:]} {run.stderr[-3000:]}")
    print(f"train CLI: python -m repro_torch.launch.train --compress-grads "
          f"--steps 4 on the kernels: {run.stdout.strip().splitlines()[-1]}; "
          f"compressed train phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return comp["launches"]


def smoke_compressed_training(dev, group):
    """Smoke-size float32 compressed training on the card: 3 steps on the
    kernels and on the plain versions agree (rtol 1e-5); over the
    one-rank group and over no group the states end bitwise equal; 3 +
    save_async (with extra) + restore + 3 equals 6 straight, err_state
    included."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel import compression as C
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("t", 64, 4, "train"), seed=0,
                          device=dev)
    base = TS.init_state(cfg, opt, seed=0, device=dev, compression=True)

    def step(impl, g=group):
        return TS.make_train_step(
            cfg, opt, attn_impl=impl, block=16,
            compressed_allreduce=C.make_compressed_allreduce(g))

    losses = {impl: [m["loss"] for m in FT.run_training(
        copy.deepcopy(base), step(impl), ds.batch, 3)[1]]
        for impl in ("cuda", "torch")}
    # f32 on both sides, sums in other orders: 1e-5 relative at most
    if not np.allclose(losses["cuda"], losses["torch"], rtol=1e-5, atol=0):
        _fail(f"smoke compressed training: kernel losses {losses['cuda']} "
              f"!= plain {losses['torch']}")

    def trees(st):
        return list(_leaves({"p": st.params, "o": st.opt_state,
                             "e": st.err_state}))

    def same(a, b):
        return a.step == b.step and all(
            torch.equal(x, y) for x, y in zip(trees(a), trees(b)))

    grouped, _ = FT.run_training(copy.deepcopy(base), step("cuda"),
                                 ds.batch, 3)
    alone, _ = FT.run_training(copy.deepcopy(base), step("cuda", None),
                               ds.batch, 3)
    if not same(grouped, alone):
        _fail("smoke compressed training: the one-rank group's states "
              "differ from no group's")
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    straight, _ = FT.run_training(copy.deepcopy(base), step("cuda"),
                                  ds.batch, 6)
    half, _ = FT.run_training(copy.deepcopy(base), step("cuda"), ds.batch,
                              3)
    mgr = CKPT.CheckpointManager(str(ckpt))
    mgr.save_async(half, 3, extra={"compressed": True})
    mgr.wait()
    resumed, manifest = CKPT.restore(str(ckpt), base, device=dev)
    resumed, _ = FT.run_training(resumed, step("cuda"), ds.batch, 6)
    shutil.rmtree(ckpt)
    if manifest["extra"] != {"compressed": True} or \
            not same(straight, resumed):
        _fail("smoke compressed training: 3 + save_async + restore + 3 "
              "steps differ from 6 straight steps (err_state included)")
    print(f"smoke compressed training: float32, 3 steps kernels "
          f"{losses['cuda']} vs plain {losses['torch']}; one-rank NCCL "
          f"group == no group, bitwise; 6 steps straight == 3 + save_async "
          f"(extra) + restore + 3, bitwise over {len(trees(straight))} "
          f"tensors (err_state included)", flush=True)


# the dry-run's reckoned peak against the card's max_memory_allocated of
# the same step: within this share of the measured
PEAK_RTOL = 0.10
# the yi-9b dense step of the train phase, reckoned and measured in a
# fresh process (roofline/attribution.py): its timed steps before the
# profiler window
ROOFLINE_STEPS = 3


def _split_gb(split: dict) -> str:
    return ", ".join(f"{k} {v / 1e9:.2f}" for k, v in split.items() if v)


def _peak_line(label, reckoned: dict, measured: float, card,
               checks: float = 0.0) -> float:
    """Print the reckoned and the measured peak; fail past PEAK_RTOL.
    ``checks``: bytes of this script's own check tensors that lived
    through the measured steps beside the step's (added to the
    reckoning)."""
    peak = reckoned["peak_bytes_per_device"]
    ratio = (peak + checks) / measured
    own = f" + the checks' own tensors {checks / 1e9:.2f} GB" \
        if checks else ""
    print(f"roofline: {label}: the dry-run's peak {peak / 1e9:.2f} GB "
          f"({_split_gb(reckoned['peak_split'])}){own} against "
          f"max_memory_allocated over the steps {measured / 1e9:.2f} GB, "
          f"ratio {ratio:.4f}; card {card}", flush=True)
    if abs(ratio - 1) > PEAK_RTOL:
        _fail(f"roofline: {label}: reckoned peak {peak} against measured "
              f"{measured}: ratio {ratio:.4f} past {PEAK_RTOL}")
    return ratio


def _attribution_lines(label, att: dict, card):
    """Print a window's attribution (roofline/attribution.py): its groups,
    then the elementwise time by port module and the top aten ops."""
    print(f"roofline: {label}: busy {att['busy_ms']:.1f} of "
          f"{att['wall_ms']:.1f} ms; " + "; ".join(
              f"{g} {v['ms']:.2f} ms x{v['launches']} ({v['share']:.1%})"
              for g, v in att["groups"].items())
          + f"; region launches held to the wrappers' {att['launches_held']}"
          f"; card {card}", flush=True)
    print(f"roofline: {label}: elementwise by module (linked to their ops: "
          f"{att['elementwise_linked_ms']:.2f} ms): " + "; ".join(
        f"{m} {ms:.2f} ms" for m, ms in att["elementwise_by_module"].items())
        + "; top ops: " + "; ".join(
            f"{r['module']} {r['op']} {r['ms']:.2f} ms x{r['launches']}"
            for r in att["elementwise_by_op"][:8]), flush=True)


def roofline_phase(card, layers: int, nem_train: dict):
    """Phase 9: the dry-run's reckonings against what the card's training
    steps take. yi-9b's dense step of the train phase (``layers`` deep,
    seq 4096, batch 1, remat, AdamW) in a fresh process
    (``python -m repro_torch.roofline.attribution``): its steps' time and
    peak, the dry-run's count of the same cell on meta, and one profiler
    window over one more step attributed by region (the window's region
    launches held to the wrappers' counts, or the process fails); then
    nemotron's 1-of-96 dense step, reckoned here and set against the peak
    and step times nemotron_training read, and the attribution of its
    window (taken in this process); then the dry-run's tri_3body
    cell at the reference's defaults and rows 13-14's bounds through
    roofline/model.py."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import compat
    from repro_torch.launch import dryrun as DRY
    from repro_torch.train import optimizer as OPT

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    out = root / "build" / "roofline"
    out.mkdir(parents=True, exist_ok=True)
    reading = out / "yi_9b_dense.json"
    reading.unlink(missing_ok=True)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.attribution", "--arch",
         "yi-9b", "--n-layers", str(layers), "--seq", "4096", "--batch", "1",
         "--steps", str(ROOFLINE_STEPS), "--json", str(reading)],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    if run.returncode or not reading.exists():
        _fail(f"roofline: the yi-9b window failed (rc {run.returncode}): "
              f"{run.stderr[-3000:]}")
    rec = json.loads(reading.read_text())
    rk = rec["reckoned"]
    _peak_line(f"yi-9b {layers}L dense step", rk["memory"], rec["peak_bytes"],
               card)
    rf = rk["roofline"]
    step_s = statistics.median(rec["step_s"])
    print(f"roofline: yi-9b {layers}L dense step: model_flops "
          f"{rec['model_flops']:.6g} (6 N D), step {step_s:.4f} s (times "
          f"{rec['step_s']}), MFU {rec['mfu']:.4f}; reckoned compute "
          f"{rf['compute_s']:.4f} s, memory {rf['memory_s']:.4f} s, "
          f"dominant {rf['dominant']}, mfu_at_bound {rf['mfu_at_bound']:.4f}"
          f", useful flops {rf['useful_flops_ratio']:.4f}; the dry-run's "
          f"count {rk['seconds']:.1f} s on the host; card {card}", flush=True)
    _attribution_lines("yi-9b window", rec["attribution"], card)

    # nemotron's 1-of-96 dense step, as nemotron_training ran it
    cfg = dataclasses.replace(REG.get_config("nemotron-4-340b"),
                              n_layers=NEMOTRON_TRAIN_CUT)
    shape = ShapeConfig("nemotron_train", NEMOTRON_SEQ, 1, "train")
    cnt = DRY.count_cell(cfg, shape, opt=OPT.OptConfig(**NEMOTRON_OPT))
    dense = nem_train["dense"]
    _peak_line(f"nemotron {NEMOTRON_TRAIN_CUT} of 96 layers dense step",
               cnt["analysis"]["memory"], dense["steps_peak_gb"] * 1e9, card,
               checks=dense["checks_gb"] * 1e9)
    mf = RF.model_flops(cfg, shape)
    terms = RF.terms_from_analysis(cnt["analysis"], n_chips=1,
                                   model_flops=mf)
    nem_s = statistics.median(dense["step_s"])
    print(f"roofline: nemotron dense step: model_flops {mf:.6g}, step "
          f"{nem_s:.4f} s, MFU {RF.mfu(mf, nem_s):.4f}; reckoned compute "
          f"{terms.compute_s:.4f} s, memory {terms.memory_s:.4f} s, "
          f"dominant {terms.dominant}, mfu_at_bound "
          f"{terms.mfu_at_bound:.4f}; card {card}", flush=True)
    _attribution_lines("nemotron window (in the smoke's process)",
                       dense["attribution"], card)

    # the reference's tri_3body dry-run cell, and rows 13-14's bounds
    tb = DRY.run_tri_3body_cell(str(out), force=True)
    if not tb.get("ok"):
        _fail(f"roofline: the tri_3body cell failed: {tb.get('error')}")
    rows = {name: compat.work(name, *TB_HEADLINE).bound_ms
            for name in ("tri_3body.tet", "tri_3body.bb3")}
    print(f"roofline: tri_3body cell N {tb['n_rows']} blk {tb['block']} d "
          f"{tb['d']}: tiles {tb['tiles_tet']} / {tb['tiles_bb3']}, launched "
          f"flops bb3 / tet {tb['flops_ratio_bb3_over_tet']:.4f}, bounds "
          f"{tb['tet']['bound_ms']:.6f} / {tb['bb3']['bound_ms']:.6f} ms; "
          f"rows 13-14 at N {TB_HEADLINE[0]} d {TB_HEADLINE[1]} blk "
          f"{TB_HEADLINE[2]}: " + ", ".join(f"{n} {ms:.4f} ms"
                                            for n, ms in rows.items())
          + f"; roofline phase {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="cut the served model's depth (default: all 48)")
    ap.add_argument("--train-layers", type=int, default=24,
                    help="depth of the trained model (default 24: the "
                         "48-layer AdamW state does not fit 80 GB)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: no CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if RF is None:
        _fail(f"cannot load the repro_torch package from {src}")
    try:
        from repro_torch.kernels import build as BUILD
        from repro_torch.kernels.tri_attn import kernel as K
        from repro_torch.kernels.tri_attn import ops as OPS
        from repro_torch.kernels.tri_attn import scan_impl as SC
        from repro_torch.serve import decode as D
    except ImportError as e:
        _fail(f"cannot load the repro_torch package from {src}: {e}")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {card}", flush=True)
    build_s = BUILD.build_all()
    print(f"build: {build_s:.1f} s (nvcc, sm_90a) into {BUILD.build_dir()}",
          flush=True)
    tc_build = tensor_core_build(BUILD, K)
    dec_build = decode_build(BUILD)
    scans = scan_build(BUILD)
    checker_phase()
    ctx, kernels = kernel_phase(dev, K, OPS, SC)
    kernels[1]["ptxas"] = dec_build[("bf16", "f32", 64, 128)]
    kernels.append(fused_kernel_phase(dev, K, OPS, SC, D, ctx))
    del ctx
    kernels[0]["ptxas"] = tc_build[("packed_fwd_tc_kernel", 64, 128)]
    kernels[-1]["ptxas"] = tc_build[("fused_step_kernel f32 cache", 64, 128)]
    kernels += train_kernel_phase(dev, K, OPS, SC)
    for row, kern in zip(kernels[-3:], ("tri_fwd_tc_kernel",
                                        "tri_bwd_dq_tc_kernel",
                                        "tri_bwd_dkv_tc_kernel")):
        row["ptxas"] = tc_build[(kern, 64, 128)]
    packed_rows, packed_fwd_train = packed_train_kernel_phase(dev, K, OPS,
                                                              SC)
    for row, kern in zip(packed_rows, ("packed_bwd_dq_tc_kernel",
                                       "packed_bwd_dkv_tc_kernel")):
        row["ptxas"] = tc_build[(kern, 64, 128)]
    kernels += packed_rows
    torch.cuda.empty_cache()
    kernels += paper_phase(dev, K, OPS, SC)
    kernels[-1]["ptxas"] = tc_build[("fwd_bb_tc_kernel", 64, 128)]
    torch.cuda.empty_cache()
    kernels += three_body_phase(dev)
    torch.cuda.empty_cache()
    wkv_row = wkv_kernel_phase(dev)
    wkv_row["ptxas"] = scans[("wkv_kernel", "f32", 64)]
    wkv_row["ptxas_step"] = scans[("wkv_walk_kernel", "f32", 64)]
    kernels.append(wkv_row)
    wkv_row["launches"], wkv_row["launches_offline"] = rwkv_serving_phase(
        dev, card)
    rwkv_cli_phase()
    torch.cuda.empty_cache()
    ssm_row = ssm_kernel_phase(dev)
    ssm_row["ptxas"] = scans[("ssm_kernel", "f32", 16)]
    kernels.append(ssm_row)
    torch.cuda.empty_cache()
    ssm_row["launches"], ssm_row["launches_offline"] = jamba_serving_phase(
        dev, card)
    jamba_cli_phase()
    torch.cuda.empty_cache()
    d192, nem_train = other_archs_phase(dev, card, K, tc_build)
    d192["tri_attn.packed_decode_fwd"]["ptxas"] = dec_build[
        ("bf16", "f32", 64, 192)]
    for k in kernels:
        if k["name"] in d192:
            k["at_d192"] = d192[k["name"]]
    torch.cuda.empty_cache()
    prefix_phase(dev)
    print("kernels: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, library "
        + ("none" if k["library_ms"] is None else f"{k['library_ms']:.4f}")
        + f", bound {k['bound_ms']:.4f} by {k['bound_by']}) err "
        f"{k['max_abs_err']:.3g}" for k in kernels), flush=True)
    launches, auto_launches = serving_phase(dev, args.layers, card, K)
    smoke_identity(dev)
    serve_cli_phase()
    examples_phase(K)
    dense, packed = train_phase(dev, args.train_layers, card, K, OPS)
    compressed = compressed_train_phase(dev, card, K)
    launches.update(dense)
    launches.update({n: c for n, c in packed.items()
                     if n != "tri_attn.packed_fwd"})
    packed_fwd_train["launches"] = packed["tri_attn.packed_fwd"]
    smoke_training(dev)
    roofline_phase(card, args.train_layers, nem_train)
    for k in kernels:
        if "launches" in k:  # the paper and 3-body phases counted theirs
            continue
        k["launches"] = launches[k["name"]]
        if k["name"] in auto_launches:
            # the same rows on the engine's default decode mode (phase 4b)
            k["launches_auto_default"] = auto_launches[k["name"]]
        if k["name"] in compressed:
            k["launches_compressed_dp"] = compressed[k["name"]]
        if k["name"] == "tri_attn.packed_fwd":
            # its serving reading and launches above, its packed-training
            # ones here
            k["at_train_shape"] = packed_fwd_train
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
