"""Time candidate forms of the port's two recurrent scans on one card.

    python3 scripts/scan_variants.py [--parent DIR] [--out FILE]

``wkv_scan.wkv`` (src/repro_torch/csrc/wkv_scan.cu) splits each stream
of more than one chunk into chunks of WKV_CHUNK = 64 steps, a block
each, chained in the launch by decoupled look-back; it stages its steps
16 at a time through a 2-stage cp.async ring and runs 4 threads a
column, its step loop unrolled by 2. A call of one chunk (the decode
step) runs the sequential walk. ``ssm_scan.selective_scan`` (ssm_scan.cu)
runs 128 channels a block, reads h0 and A and writes h_L coalesced
through shared memory, stages Bt and Ct 16 steps at a time by plain
loads and takes each decay as one ex2.approx.ftz. This script builds
copies of the checkout's sources under ``build/scan_variants/`` with one
of those choices changed and, with ``--parent`` pointing at an unpacked
``git archive`` of another commit under ``build/``, that commit's
wkv_scan.cu and ssm_scan.cu. WKV candidates: chunks of 32 and 128; the
last-arrival chain; 3 stages; stages of 8 steps; the step loop not
unrolled; 3 blocks an SM (stages of 8 steps, at most 85 registers); 8
threads a column at hd 64 (512 threads, at most 64 registers); scalar
loads of r, k, e^lw in place of float4 broadcasts. Scan candidates: the
denormal-safe exp2f; each thread's N floats of h0, A and h_L read and
written directly (N strided accesses, as before the redesign); the
first redesign's body, whose cp.async ring staged the next chunks (x and
dt too) while the current one ran, with that strided state and plain
loads for a call of one chunk; 64 threads a block (256 no longer fit:
the block's state rows at N 32 take 64 KB of static shared memory);
chunks of 32 steps. It times each against
the tree's build in turns, through the C entry point (no wrapper) with
CUDA events and on the device (profiler), at the kernel phases' shapes
of chip_smoke.py (WKV: B 4, L 2048, H 32, hd 64; the scan: B 4, L 2048,
D 16384, N 16; f32; the inputs, 268 MB and 1.2 GB, stream through the
50 MB L2, so every launch finds it cold), and the L = 1 step at B 4 on
the device in turns, every other round reversed (WKV: the tree and the
parent; the scan: the tree, exp2f, strided state, the ring and the
parent). Every candidate is held against the plain version
(WKV_REL, SSM_REL of chip_smoke.py); those that keep the tree's
arithmetic must give its bits, and each is run twice for the same bits.
A diagnostic build whose blocks do not wait for their predecessors
(wrong, so not held to the plain version) shows what the chain's waits
cost.

With ``--parent`` it then times the rwkv6-1.6b and jamba prefills of
chip_smoke.py (4 x 2048 tokens, random seeded bf16 weights; jamba cut to
one superlayer and 4 experts) with the parent's wkv_scan or ssm_scan
library in place of the tree's, in the order parent, change, change,
parent, twice: each prefill's CUDA-event time, the device's busy time in
a profiler window and the scan kernel's share of it. The bf16 models'
last logits, parent against change, are reported (the kernels' f32
rounding flips bf16 roundings, which random layers carry on); rwkv6 is
also run in float32, where parent and change must agree within
chip_smoke.py's RWKV_F32_TOL.

Prints one JSON object (and writes it to --out). Needs a CUDA card and
nvcc; exits 1 without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

import _variants as V

ROOT = V.ROOT
_P, _I = ctypes.c_void_p, ctypes.c_int

WKV_CHAIN = ("  int* flag = counters + 1 + bh;\n",
             "// A call of one chunk (L <= WKV_CHUNK)")
# the last-arrival chain: every block leaves its local state, P_c, rp and
# local outputs in the scratch; the block of a stream that arrives last
# chains the states and corrects every chunk's outputs itself, then sets
# the stream's counter back to 0
LAST_ARRIVAL = r"""  int* count = counters + 1 + bh;
  constexpr size_t CS = static_cast<size_t>(HD) * HD + HD + 2 * WKV_CHUNK * HD;
  float* mine = slot + (static_cast<size_t>(bh) * nchunks + c) * CS;
  if (tid < HD) pc[tid] = prow;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < R; ++m) mine[(i0 + m) * HD + j] = s[m];
  for (int e = tid; e < HD; e += NT) mine[HD * HD + e] = pc[e];
  for (int e = tid; e < n * HD; e += NT) {
    mine[HD * HD + HD + e] = rp[e];
    mine[HD * HD + HD + WKV_CHUNK * HD + e] = so[e];
  }
  __threadfence();
  __syncthreads();
  __shared__ int arrived_last;
  if (tid == 0) {
    arrived_last = atomicAdd(count, 1) == nchunks - 1;
    if (arrived_last) atomicExch(count, 0);
  }
  __syncthreads();
  if (!arrived_last) return;
  __threadfence();
  const float* first = slot + static_cast<size_t>(bh) * nchunks * CS;
  for (int e = tid; e < HD * HD; e += NT) sprev[e] = __ldcg(first + e);
  __syncthreads();
  for (int cc = 1; cc < nchunks; ++cc) {
    const float* ch = first + cc * CS;
    const int nn = min(WKV_CHUNK, L - cc * WKV_CHUNK);
    const size_t ob = (static_cast<size_t>(b) * L * H + h) * HD +
                      static_cast<size_t>(cc) * WKV_CHUNK * step;
    float acc[S::XN];
#pragma unroll
    for (int x = 0; x < S::XN; ++x) acc[x] = 0.f;
#pragma unroll
    for (int ib = 0; ib < HD; ib += S::IB) {
      float col[S::IB];
#pragma unroll
      for (int i = 0; i < S::IB; ++i) col[i] = sprev[(ib + i) * HD + j];
#pragma unroll
      for (int x = 0; x < S::XN; ++x) {
        const float* rt = ch + HD * HD + HD + (q + P * x) * HD + ib;
        if (q + P * x < nn) {
#pragma unroll
          for (int i = 0; i < S::IB; i += 4) {
            const float4 r4 = __ldcg(reinterpret_cast<const float4*>(rt + i));
            acc[x] = fmaf(r4.x, col[i], acc[x]);
            acc[x] = fmaf(r4.y, col[i + 1], acc[x]);
            acc[x] = fmaf(r4.z, col[i + 2], acc[x]);
            acc[x] = fmaf(r4.w, col[i + 3], acc[x]);
          }
        }
      }
    }
#pragma unroll
    for (int x = 0; x < S::XN; ++x) {
      const int tt = q + P * x;
      if (tt < nn)
        out[ob + static_cast<size_t>(tt) * step + j] = tri::from_f32<T>(
            __ldcg(ch + HD * HD + HD + WKV_CHUNK * HD + tt * HD + j) + acc[x]);
    }
    __syncthreads();  // every column of S_{cc-1} is read
    for (int e = tid; e < HD * HD; e += NT)
      sprev[e] = fmaf(__ldcg(ch + HD * HD + e / HD), sprev[e], __ldcg(ch + e));
    __syncthreads();
  }
  for (int e = tid; e < HD * HD; e += NT) s_l[sbase + e] = sprev[e];
}

"""


WKV_C = "constexpr int WKV_CHUNK = 64;"
WKV_SUB = "constexpr int WKV_SUB = 16;"
WKV_ST = "constexpr int WKV_STAGES = 2;"
WKV_STEPS = ("    for (int tt = 0; tt < nk; ++tt) {\n"
             "      const float* rt = wr + tt * HD + i0;")
SSM_T = "constexpr int SSM_THREADS = 128;"
SSM_C = "constexpr int SSM_CHUNK = 16;"
# ssm_scan.cu's kernel and launch, and the ring kernel that replaced them
# in a first redesign: x, dt, Bt and Ct of the next chunks staged by
# cp.async while the current one runs (plain loads for one chunk or rows
# that are no whole 16-byte pieces), the same arithmetic
SSM_BODY = ("template <typename T, int N>\n__global__", "}  // namespace")
SSM_RING = r"""constexpr int SSM_STAGES = 3;  // ring stages

template <typename T, int N>
struct Ssm {
  static constexpr int VEC = 16 / sizeof(T);  // elements a cp.async
  // a stage: x and dt (SSM_CHUNK x SSM_THREADS), Bt and Ct (SSM_CHUNK x N)
  static constexpr int XS = SSM_CHUNK * SSM_THREADS, BS = SSM_CHUNK * N;
  static constexpr int STAGE = 2 * XS + 2 * BS;
};

// Four consecutive staged elements as f32 (p 8- or 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(SSM_THREADS)
    ssm_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bt,
               const T* __restrict__ Ct, const float* h0, T* __restrict__ y,
               float* h_l, int L, int D) {
  using S = Ssm<T, N>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int nblk = (D + SSM_THREADS - 1) / SSM_THREADS;
  const int b = blockIdx.x / nblk;
  const int d0 = (blockIdx.x % nblk) * SSM_THREADS, tid = threadIdx.x;
  const int d = d0 + tid;
  const bool live = d < D;
  const size_t row0 = static_cast<size_t>(b) * L;  // row (b, t) = row0 + t
  const size_t hbase = (static_cast<size_t>(b) * D + d) * N;
  const int nchunks = (L + SSM_CHUNK - 1) / SSM_CHUNK;

  // Fills the stage of chunk kk (if there is one) and closes a group.
  auto issue = [&](int kk) {
    if (kk < nchunks) {
      const int t0 = kk * SSM_CHUNK, steps = min(SSM_CHUNK, L - t0);
      T* st = ring + (kk % SSM_STAGES) * S::STAGE;
      if constexpr (VEC) {
        constexpr int XP = SSM_THREADS / S::VEC, BP = N / S::VEC;  // pieces a row
        for (int e = tid; e < 2 * steps * XP; e += SSM_THREADS) {
          const int a = e / (steps * XP), rem = e % (steps * XP);
          const int row = rem / XP, dd = (rem % XP) * S::VEC;
          if (d0 + dd < D)
            tri::cp_async16(st + a * S::XS + row * SSM_THREADS + dd,
                             (a == 0 ? x : dt) + (row0 + t0 + row) * D + d0 + dd);
        }
        for (int e = tid; e < 2 * steps * BP; e += SSM_THREADS) {
          const int a = e / (steps * BP), rem = e % (steps * BP);
          tri::cp_async16(st + 2 * S::XS + a * S::BS + rem * S::VEC,
                           (a == 0 ? Bt : Ct) + (row0 + t0) * N + rem * S::VEC);
        }
      } else {
        for (int row = 0; row < steps && live; ++row) {
          const size_t g = (row0 + t0 + row) * D + d;
          st[row * SSM_THREADS + tid] = x[g];
          st[S::XS + row * SSM_THREADS + tid] = dt[g];
        }
        for (int e = tid; e < steps * N; e += SSM_THREADS) {
          st[2 * S::XS + e] = Bt[(row0 + t0) * N + e];
          st[2 * S::XS + S::BS + e] = Ct[(row0 + t0) * N + e];
        }
      }
    }
    tri::cp_async_commit();
  };
#pragma unroll
  for (int kk = 0; kk < SSM_STAGES - 1; ++kk) issue(kk);

  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h0[hbase + n] : 0.f;
    a2[n] = live ? A[static_cast<size_t>(d) * N + n] * LOG2E : 0.f;
  }

  for (int kk = 0; kk < nchunks; ++kk) {
    const int t0 = kk * SSM_CHUNK, steps = min(SSM_CHUNK, L - t0);
    tri::cp_async_wait<SSM_STAGES - 2>();
    __syncthreads();  // chunk kk landed; every thread is done with kk - 1
    issue(kk + SSM_STAGES - 1);  // into the stage of chunk kk - 1
    const T* st = ring + (kk % SSM_STAGES) * S::STAGE;
    const T* sb = st + 2 * S::XS;
    const T* sc = sb + S::BS;
#pragma unroll
    for (int r = 0; r < SSM_CHUNK; ++r) {
      if (r < steps) {
        const float dtr = tri::to_f32(st[S::XS + r * SSM_THREADS + tid]);
        const float u = dtr * tri::to_f32(st[r * SSM_THREADS + tid]);
        float y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 b4 = load4(sb + r * N + n);
          const float4 c4 = load4(sc + r * N + n);
          h[n] = fmaf(ex2_ftz(dtr * a2[n]), h[n], u * b4.x);
          h[n + 1] = fmaf(ex2_ftz(dtr * a2[n + 1]), h[n + 1], u * b4.y);
          h[n + 2] = fmaf(ex2_ftz(dtr * a2[n + 2]), h[n + 2], u * b4.z);
          h[n + 3] = fmaf(ex2_ftz(dtr * a2[n + 3]), h[n + 3], u * b4.w);
          y0 = fmaf(h[n], c4.x, y0);
          y1 = fmaf(h[n + 1], c4.y, y1);
          y0 = fmaf(h[n + 2], c4.z, y0);
          y1 = fmaf(h[n + 3], c4.w, y1);
        }
        if (live) y[(row0 + t0 + r) * D + d] = tri::from_f32<T>(y0 + y1);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_l[hbase + n] = h[n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bt, const void* Ct,
           const void* h0, void* y, void* h_l, int B, int L, int D, int N,
           cudaStream_t stream) {
  // the ring only where there is a next chunk to overlap, and where every
  // row of x, dt (D) and of Bt, Ct (N) is whole 16-byte pieces
  const int nchunks = (L + SSM_CHUNK - 1) / SSM_CHUNK;
  const bool vec = nchunks > 1 && tri::aligned16(x, dt, Bt, Ct) &&
                   (D * sizeof(T)) % 16 == 0 && (N * sizeof(T)) % 16 == 0;
  auto go = [&](auto n_c, auto vec_c) -> int {
    constexpr int NS = decltype(n_c)::value;
    constexpr bool V = decltype(vec_c)::value;
    const long long blocks = static_cast<long long>(B) * ((D + SSM_THREADS - 1) / SSM_THREADS);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto kern = ssm_kernel<T, NS, V>;
    // the stages a call uses: chunk kk takes stage kk % SSM_STAGES
    const size_t smem = sizeof(T) * Ssm<T, NS>::STAGE * min(SSM_STAGES, nchunks);
    if (int err = tri::set_smem(kern, smem)) return err;
    kern<<<static_cast<unsigned>(blocks), SSM_THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(Bt), static_cast<const T*>(Ct), static_cast<const float*>(h0),
        static_cast<T*>(y), static_cast<float*>(h_l), L, D);
    return static_cast<int>(cudaGetLastError());
  };
  auto by_n = [&](auto n_c) -> int {
    return vec ? go(n_c, std::true_type{}) : go(n_c, std::false_type{});
  };
  switch (N) {
    case 4: return by_n(std::integral_constant<int, 4>{});
    case 8: return by_n(std::integral_constant<int, 8>{});
    case 16: return by_n(std::integral_constant<int, 16>{});
    case 32: return by_n(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

"""
# the tree reads the block's rows of h0 and A and writes those of h_L
# coalesced through shared memory; the kernel before it had each thread
# read and write its N floats directly (N strided accesses)
SSM_STATE_IN = ("  // The block's rows of h0 and of A are each one run",
                "\n  for (int t0 = 0; t0 < L; t0 += SSM_CHUNK) {")
SSM_STRIDED_IN = r"""  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h0[sbase + tid * N + n] : 0.f;
    a2[n] = live ? A[static_cast<size_t>(d) * N + n] * LOG2E : 0.f;
  }
"""
SSM_STATE_OUT = ("  // h_L the same way back",
                 "}\n\ntemplate <typename T>\nint launch(")
SSM_STRIDED_OUT = r"""  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_l[sbase + tid * N + n] = h[n];
  }
"""
# name -> (same arithmetic as the tree's, scratch floats a stream-chunk
# beyond the tree's slot (None: the tree's), edits of the source)
WKV_VARIANTS = {
    "chunk 32": (False, None, [V.swap(WKV_C, "constexpr int WKV_CHUNK = 32;")]),
    "chunk 128": (False, None, [V.swap(WKV_C, "constexpr int WKV_CHUNK = 128;")]),
    "last arrival": (True, 64 * 64 + 64 + 2 * 64 * 64,
                     [V.between(*WKV_CHAIN, LAST_ARRIVAL)]),
    "3 stages": (True, None, [V.swap(WKV_ST, "constexpr int WKV_STAGES = 3;")]),
    # a stage's steps set the lanes that sum a step's u-bonus: other bits
    "stages of 8 steps": (False, None,
                          [V.swap(WKV_SUB, "constexpr int WKV_SUB = 8;")]),
    "steps not unrolled": (True, None, [V.swap("#pragma unroll 2\n" + WKV_STEPS,
                                               "#pragma unroll 1\n" + WKV_STEPS)]),
    # 3 blocks an SM: stages of 8 steps (64.5 KB of shared memory) and
    # at most 85 registers a thread
    "3 blocks an SM": (False, None, [
        V.swap(WKV_SUB, "constexpr int WKV_SUB = 8;"),
        V.swap("__launch_bounds__(Wkv<T, HD>::NT, 1)",
               "__launch_bounds__(Wkv<T, HD>::NT, 3)")]),
    # 8 threads a column at hd 64 (512 threads, 8 rows each), at most 64
    # registers so that two blocks fit an SM: 32 warps an SM, not 16
    "8 threads a column": (False, None, [
        V.swap("static constexpr int P = HD >= 16 ? 4 : 2;",
               "static constexpr int P = HD >= 64 ? 8 : HD >= 16 ? 4 : 2;"),
        V.swap("__launch_bounds__(Wkv<T, HD>::NT, 1)",
               "__launch_bounds__(Wkv<T, HD>::NT, 2)")]),
    # (the one-chunk walk's loads change too; it is not timed here)
    "scalar loads": (True, None, [
        V.swap(f"const float4 {a}4 = *reinterpret_cast<const float4*>({a}t + m);",
               f"const float4 {a}4 = make_float4({a}t[m], {a}t[m + 1], "
               f"{a}t[m + 2], {a}t[m + 3]);", 2) for a in "rkw"]),
}
# a diagnostic, timed but not held to the plain version: no block waits
# for its predecessor (each reads whatever the slot holds), to show what
# the chain's waits cost
WKV_DIAGNOSTICS = {
    "diagnostic: no wait": (False, None, [
        V.swap("    while (ld_acquire(flag) != c) {\n    }\n", "")]),
}
SSM_VARIANTS = {
    "exp2f": (False, [V.swap("fmaf(ex2_ftz(", "fmaf(exp2f(", 4)]),
    "cp.async ring": (True, [V.between(*SSM_BODY, SSM_RING)]),
    "64 threads": (True, [V.swap(SSM_T, "constexpr int SSM_THREADS = 64;")]),
    "chunks of 32 steps": (True, [V.swap(SSM_C, "constexpr int SSM_CHUNK = 32;")]),
    "strided state": (True, [V.between(*SSM_STATE_IN, SSM_STRIDED_IN),
                             V.between(*SSM_STATE_OUT, SSM_STRIDED_OUT)]),
}
# wkv_launch of a parent before the chunked kernel: block_l, no scratch
SEQUENTIAL_WKV_SIG = {"wkv_launch": [_P] * 8 + [_I] * 6 + [_P]}


class _SequentialWkv:
    """A parent's sequential wkv_launch behind the tree's signature (its
    slot and counters dropped, its block_l the wrapper's chunk_len), so
    that the tree's wrapper can launch it."""

    def __init__(self, lib, chunk_len):
        self.lib, self.chunk_len = lib, chunk_len

    def wkv_launch(self, r, k, v, lw, u, s0, out, s_l, slot, counters, b, l,
                   h, hd, dtype, stream):
        return self.lib.wkv_launch(r, k, v, lw, u, s0, out, s_l, b, l, h, hd,
                                   self.chunk_len(l), dtype, stream)


def _steps_in_turns(CS, rows: dict, steps: dict, rounds: int = 3):
    """Device time of one L = 1 step of each build, name -> (fn, the
    kernel's name), 50 steps a profiler window, the builds in turns
    ``rounds`` times, every other round in the reverse order: rows[name]
    gains the median and the rounds."""
    runs = {name: [] for name in steps}
    for turn in range(rounds):
        for name, (fn, kernel) in list(steps.items())[::1 - 2 * (turn % 2)]:
            runs[name].append(CS._device_ms(lambda: [fn() for _ in range(50)],
                                            50, kernel))
    for name, r in runs.items():
        rows[name].update(step_device_ms=statistics.median(r), step_turns=r)


def _window(fn, kernel: str):
    """One profiler window over fn(): (device busy ms, ms and launches of
    the kernels whose names hold ``kernel``)."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(CS.PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(CS.PROFILE_PAD_S)
    busy = k_ms = 0.0
    k_n = 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        busy += ms
        if kernel in ev.key:
            k_ms += ms
            k_n += ev.count
    return busy, k_ms, k_n


def _prefill_windows(BUILD, CS, dev, src, kernel, sides, cfg, prompts,
                     launches):
    """cfg's prefill of ``prompts`` (batch, tokens) with each side's
    ``src`` library in turns (parent, change, change, parent, twice):
    each side's CUDA-event medians and profiler windows."""
    from repro_torch.models import model as MD
    from repro_torch.train import train_step as TS

    params = MD.init_params(cfg, seed=0, device=dev)
    nb, nl = prompts
    prefill = TS.make_prefill_step(cfg)
    toks = torch.as_tensor(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (nb, nl)), device=dev)
    fn = lambda: prefill(params, {"tokens": toks})
    outs = {}
    for side, lib in sides.items():
        BUILD._LIBS[src] = lib
        outs[side] = fn()[0].float()
    # bf16 weights: the kernels' f32 rounding differences flip bf16
    # roundings, which the random layers carry on; reported, not held
    diff = float((outs["change"] - outs["parent"]).abs().max())
    largest = float(outs["parent"].abs().max())
    del outs
    rows = {side: {"ms": [], "busy_ms": [], "kernel_ms": [],
                   "kernel_launches": []} for side in sides}
    for side in ("parent", "change", "change", "parent") * 2:
        BUILD._LIBS[src] = sides[side]
        rows[side]["ms"].append(CS._median_ms(fn, 3, 1))
        busy, k_ms, k_n = _window(fn, kernel)
        rows[side]["busy_ms"].append(busy)
        rows[side]["kernel_ms"].append(k_ms)
        rows[side]["kernel_launches"].append(k_n)
    BUILD._LIBS[src] = sides["change"]
    for row in rows.values():
        row.update({f"median_{key}": statistics.median(row[key])
                    for key in ("ms", "busy_ms", "kernel_ms")},
                   launches_a_prefill=launches)
    rows["bf16 last logits, parent against change"] = {
        "max_abs_diff": diff, "largest_logit": largest}
    del params
    torch.cuda.empty_cache()
    return rows


def _rwkv_f32_sides(BUILD, CS, dev, sides, cfg, prompts) -> float:
    """rwkv6-1.6b in float32 (6.4 GB of random seeded weights): the last
    logits of a prefill with the parent's wkv_scan library against the
    tree's, held to RWKV_F32_TOL (the chunks' sums differ from the walk
    by reassociation only)."""
    import dataclasses

    from repro_torch.models import model as MD
    from repro_torch.train import train_step as TS

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = MD.init_params(cfg32, seed=0, device=dev)
    prefill = TS.make_prefill_step(cfg32, cache_dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(18).integers(
        0, cfg.vocab_size, prompts), device=dev)
    outs = {}
    for side, lib in sides.items():
        BUILD._LIBS["wkv_scan"] = lib
        outs[side] = prefill(params, {"tokens": toks})[0]
    BUILD._LIBS["wkv_scan"] = sides["change"]
    err = CS._close("rwkv6 f32 prefill, parent against change",
                    outs["change"], outs["parent"], CS.RWKV_F32_TOL)
    del params, outs
    torch.cuda.empty_cache()
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an unpacked checkout whose wkv_scan.cu and "
                    "ssm_scan.cu are timed beside the tree's")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("scan_variants: torch.cuda.is_available() is False")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.kernels import build as BUILD
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    card = V.card()
    jobs = {}
    for name, (_, _, edits) in {**WKV_VARIANTS, **WKV_DIAGNOSTICS}.items():
        out = V.patched(BUILD.CSRC, "scan_variants", "wkv " + name,
                        {"wkv_scan.cu": edits})
        jobs["wkv " + name] = (out, "wkv_scan", out)
    for name, (_, edits) in SSM_VARIANTS.items():
        out = V.patched(BUILD.CSRC, "scan_variants", "ssm " + name,
                        {"ssm_scan.cu": edits})
        jobs["ssm " + name] = (out, "ssm_scan", out)
    if args.parent:
        pcsrc = Path(args.parent).resolve() / "src" / "repro_torch" / "csrc"
        parent = V.patched(pcsrc, "scan_variants", "parent", {})
        sequential = "int block_l" in (parent / "wkv_scan.cu").read_text()
        jobs["wkv parent"] = (parent, "wkv_scan", parent,
                              SEQUENTIAL_WKV_SIG if sequential else
                              BUILD.SIGNATURES["wkv_scan"])
        jobs["ssm parent"] = (parent, "ssm_scan", parent)
    BUILD.build_all()
    built = V.build(BUILD, jobs)
    tree_logs = {s: (BUILD.build_dir() / f"{s}.log").read_text()
                 for s in ("wkv_scan", "ssm_scan")}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    report = {"card": card, "wkv": {}, "ssm": {}}
    # --- WKV at the kernel phase's shape ---
    b, l, h, hd = CS.RWKV_SHAPE
    rng = np.random.default_rng(17)
    rand = lambda *s: torch.as_tensor(
        0.5 * rng.standard_normal(s, np.float32), device=dev)
    r, k, v = rand(b, l, h, hd), rand(b, l, h, hd), rand(b, l, h, hd)
    lw = -torch.exp(rand(b, l, h, hd))
    u, s0 = rand(h, hd), rand(b, h, hd, hd)
    want_o, want_s = WR.wkv_ref(r, k, v, lw, u, s0)
    nch = -(-l // 32)  # enough (stream, chunk) scratch for chunks of 32
    wkv_libs = {"tree": (BUILD.load("wkv_scan"), None, True)}
    for name, (same, extra, _) in {**WKV_VARIANTS, **WKV_DIAGNOSTICS}.items():
        wkv_libs[name] = (built["wkv " + name][0], extra, same)
    if args.parent:
        wkv_libs["parent"] = (built["wkv parent"][0], None, False)
    slots = {name: torch.empty(b * h * (hd * hd if extra is None else
                                        nch * extra), device=dev)
             for name, (_, extra, _) in wkv_libs.items()}
    outs = {name: (torch.empty_like(r), torch.empty_like(s0))
            for name in wkv_libs}
    # each build its own counters: a diagnostic's may be left nonzero
    counters = {name: torch.zeros(1 + b * h, dtype=torch.int32, device=dev)
                for name in wkv_libs}

    def wkv_call(name, xs=(r, k, v, lw), state=None):
        lib, _, _ = wkv_libs[name]
        o, s_l = outs[name] if state is None else state
        ptrs = [t.data_ptr() for t in (*xs, u, s0 if state is None else
                                       s_l, o, s_l)]
        ll = xs[0].shape[1]
        if name == "parent" and sequential:
            err = lib.wkv_launch(*ptrs, b, ll, h, hd, min(64, ll), 0, stream)
        else:
            err = lib.wkv_launch(*ptrs, slots[name].data_ptr(),
                                 counters[name].data_ptr(), b, ll, h, hd, 0,
                                 stream)
        if err:
            sys.exit(f"scan_variants: wkv {name}: cudaError {err}")
        return o, s_l

    got = {}
    for name in wkv_libs:
        if name in WKV_DIAGNOSTICS:
            continue
        o1, s1 = (x.clone() for x in wkv_call(name))
        o2, s2 = wkv_call(name)
        torch.cuda.synchronize()
        if int(counters[name].abs().sum()):
            sys.exit(f"scan_variants: wkv {name} left a counter nonzero")
        if not (torch.equal(o1, o2) and torch.equal(s1, s2)):
            sys.exit(f"scan_variants: wkv {name}: two runs differ")
        CS._wkv_close(f"wkv {name}", o1, want_o)
        CS._wkv_close(f"wkv {name} state", s1, want_s)
        got[name] = (o1, s1)
    for name, (_, _, same) in wkv_libs.items():
        if same and name not in WKV_DIAGNOSTICS and not all(torch.equal(a, c) for a, c in
                            zip(got[name], got["tree"])):
            sys.exit(f"scan_variants: wkv {name} differs from the tree")
    del got, want_o
    turns = CS._in_turns({name: (lambda name=name: wkv_call(name))
                          for name in wkv_libs}, 10, rounds=3)
    for name in wkv_libs:
        dev_ms = CS._device_ms(lambda: [wkv_call(name) for _ in range(5)], 5,
                               "wkv_kernel")
        report["wkv"][name] = {"ms": turns[name][0],
                               "ms_turns": turns[name][1],
                               "device_ms": dev_ms}
    one = [t[:, :1].contiguous() for t in (r, k, v, lw)]
    cache, o1 = s0.clone(), torch.empty_like(one[0])
    _steps_in_turns(CS, report["wkv"], {name: (
        lambda name=name: wkv_call(name, one, (o1, cache)),
        "wkv_walk_kernel" if name == "tree" else "wkv_kernel")
        for name in ("tree", "parent") if name in wkv_libs})
    report["wkv"]["ptxas"] = {
        "tree": V.f32_ptxas(tree_logs["wkv_scan"], "wkv_kernel"),
        "tree, the one-chunk walk": V.f32_ptxas(tree_logs["wkv_scan"],
                                                "wkv_walk_kernel"),
        **{name: V.f32_ptxas(built["wkv " + name][1], "wkv_kernel")
           for name in WKV_VARIANTS}}
    print(f"scan_variants: wkv at B={b} L={l} H={h} hd={hd} f32, L2 cold: "
          + "; ".join(f"{name} {row['ms']:.4f} ms (turns {row['ms_turns']}), "
                      f"device {row['device_ms']:.4f}"
                      + (f", L=1 step device {row['step_device_ms']:.4f} "
                         f"(turns {row['step_turns']})"
                         if "step_device_ms" in row else "")
                      for name, row in report["wkv"].items()
                      if name != "ptxas") + f"; card {card}", flush=True)
    del r, k, v, lw, outs, slots

    # --- the selective scan at the kernel phase's shape ---
    gen = torch.Generator(device=dev).manual_seed(19)
    xs = CS._ssm_inputs(gen, dev, *CS.SSM_SHAPE)
    b, l, d, n = CS.SSM_SHAPE
    want_y, want_h = SR.selective_scan_ref(*xs)
    ssm_libs = {"tree": (BUILD.load("ssm_scan"), True)}
    for name, (same, _) in SSM_VARIANTS.items():
        ssm_libs[name] = (built["ssm " + name][0], same)
    if args.parent:
        ssm_libs["parent"] = (built["ssm parent"][0], False)
    y_out = torch.empty_like(xs[0])
    h_out = torch.empty_like(xs[5])

    def ssm_call(name, ins=xs, y=y_out, h_l=h_out):
        lib, _ = ssm_libs[name]
        ll = ins[0].shape[1]
        err = lib.ssm_scan_launch(*(t.data_ptr() for t in ins), y.data_ptr(),
                                  h_l.data_ptr(), b, ll, d, n, 0, stream)
        if err:
            sys.exit(f"scan_variants: ssm {name}: cudaError {err}")
        return y, h_l

    tree = None
    for name, (_, same) in ssm_libs.items():
        y1, h1 = (t.clone() for t in ssm_call(name))
        y2, h2 = ssm_call(name)
        torch.cuda.synchronize()
        if not (torch.equal(y1, y2) and torch.equal(h1, h2)):
            sys.exit(f"scan_variants: ssm {name}: two runs differ")
        CS._wkv_close(f"ssm {name}", y1, want_y, CS.SSM_REL)
        CS._wkv_close(f"ssm {name} state", h1, want_h, CS.SSM_REL)
        if name == "tree":
            tree = (y1, h1)
        elif same and not (torch.equal(y1, tree[0])
                           and torch.equal(h1, tree[1])):
            sys.exit(f"scan_variants: ssm {name} differs from the tree")
        del y1, h1
    del tree, want_y
    turns = CS._in_turns({name: (lambda name=name: ssm_call(name))
                          for name in ssm_libs}, 10, rounds=3)
    for name in ssm_libs:
        dev_ms = CS._device_ms(lambda: [ssm_call(name) for _ in range(5)], 5,
                               "ssm_kernel")
        report["ssm"][name] = {"ms": turns[name][0],
                               "ms_turns": turns[name][1],
                               "device_ms": dev_ms}
    one = [t[:, :1].contiguous() for t in xs[:2]] + [xs[2]] + \
        [t[:, :1].contiguous() for t in xs[3:5]] + [xs[5].clone()]
    y1 = torch.empty_like(one[0])
    _steps_in_turns(CS, report["ssm"], {name: (
        lambda name=name: ssm_call(name, one, y1, one[5]), "ssm_kernel")
        for name in ("tree", "exp2f", "strided state", "cp.async ring",
                     "parent") if name in ssm_libs})
    report["ssm"]["ptxas"] = {
        "tree": V.f32_ptxas(tree_logs["ssm_scan"], "ssm_kernel"),
        **{name: V.f32_ptxas(built["ssm " + name][1], "ssm_kernel")
           for name in SSM_VARIANTS}}
    print(f"scan_variants: ssm at B={b} L={l} D={d} N={n} f32, L2 cold: "
          + "; ".join(f"{name} {row['ms']:.4f} ms (turns {row['ms_turns']}), "
                      f"device {row['device_ms']:.4f}"
                      + (f", L=1 step device {row['step_device_ms']:.4f} "
                         f"(turns {row['step_turns']})"
                         if "step_device_ms" in row else "")
                      for name, row in report["ssm"].items()
                      if name != "ptxas") + f"; card {card}", flush=True)
    if args.parent:
        tree_wkv, tree_ssm = BUILD.load("wkv_scan"), BUILD.load("ssm_scan")
        p_wkv = built["wkv parent"][0]
        if sequential:
            p_wkv = _SequentialWkv(p_wkv, WK.chunk_len)
        import dataclasses

        from repro_torch.configs import jamba_1_5_large_398b, rwkv6_1_6b

        rwkv = rwkv6_1_6b.CONFIG
        jamba = dataclasses.replace(jamba_1_5_large_398b.CONFIG,
                                    **CS.JAMBA_CUT)
        report["rwkv6 f32 last logits, parent against change"] = {
            "max_abs_err": _rwkv_f32_sides(
                BUILD, CS, dev, {"parent": p_wkv, "change": tree_wkv}, rwkv,
                CS.RWKV_PROMPTS), "tolerance": CS.RWKV_F32_TOL}
        print("scan_variants: rwkv6-1.6b f32 prefill, parent against change: "
              "last logits max abs err "
              f"{report['rwkv6 f32 last logits, parent against change']}",
              flush=True)
        report["windows"] = {
            "rwkv6-1.6b prefill": _prefill_windows(
                BUILD, CS, dev, "wkv_scan", "wkv_kernel",
                {"parent": p_wkv, "change": tree_wkv}, rwkv,
                CS.RWKV_PROMPTS, rwkv.n_layers),
            "jamba prefill": _prefill_windows(
                BUILD, CS, dev, "ssm_scan", "ssm_kernel",
                {"parent": built["ssm parent"][0], "change": tree_ssm}, jamba,
                CS.JAMBA_PROMPTS, sum(k == "mamba" for k in jamba.layer_kinds))}
        for label, rows in report["windows"].items():
            print(f"scan_variants: {label} of 4 x 2048 tokens in turns: "
                  + "; ".join(
                      f"{side} {r['median_ms']:.2f} ms {r['ms']}, device busy "
                      f"{r['median_busy_ms']:.2f} ms {r['busy_ms']}, the scan "
                      f"{r['median_kernel_ms']:.2f} ms {r['kernel_ms']} "
                      f"({r['kernel_launches']} of "
                      f"{r['launches_a_prefill']} launches recorded)"
                      for side, r in rows.items() if side in ("parent", "change"))
                  + f"; bf16 last logits, parent against change: max abs "
                  f"diff {rows['bf16 last logits, parent against change']}"
                  f"; card {card}",
                  flush=True)
    text = json.dumps(report)
    print(text)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
