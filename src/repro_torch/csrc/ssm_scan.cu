// The Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/ssm_scan/kernel.py:
//   selective_scan (_ssm_kernel) -> ssm_scan_launch. Per (batch b,
//   channel d) the state h (N floats) runs over t = 0 .. L-1:
//     h[n] <- exp(dt_t A[d][n]) h[n] + (dt_t x_t) B_t[n]
//     y_t   = sum_n h[n] C_t[n]
//   x, dt (B, L, D), Bt, Ct (B, L, N), one dtype, f32 or bf16; A (D, N)
//   f32; h0 and h_L (B, D, N) f32; y (B, L, D) in x's dtype;
//   N in {4, 8, 16, 32}.
//
// The Pallas grid (B, D / block_d, L / block_l) carries h in scratch from
// one chunk to the next, which needs its steps in order. Here one block
// owns one (b, channel block) stream (grid B * ceil(D / 128)) and walks t
// in order itself, so no two blocks share state: no atomics, no
// cross-block order. Thread j of the block owns channel d = 128 * blk + j
// and keeps its N state floats and its row of A log2 e in registers. The
// block's rows of h0 and A (and, at the end, of h_L) are each one
// contiguous run, moved by coalesced loads and stores through shared
// memory: a thread's N strided accesses took most of a decode step's
// time. A chunk of SSM_CHUNK steps at a time: the block stages the
// chunk's Bt and Ct rows in shared memory (every thread reads them, as
// float4 broadcasts), and each thread loads its channel's x and dt of the
// chunk into registers (one coalesced row of the block a step), then
// runs the steps. The block reads its h0 before it writes h_L and touches
// no other (b, d), so h0 and h_L may be the same buffer (the decode step
// updates the cache in place). Any L >= 1 (a last chunk may be short)
// and any D (the threads past D only stage). Each decay exp(dt A) is one
// ex2.approx.ftz of dt (A log2 e): within 2 ulp of exp(dt A), and 0 where
// that is below 2^-126 (the decay of a step that wipes the state). The
// denormal-safe exp2f (the source is built without fast-math) wraps each
// MUFU.EX2 in range fix-ups that share the issue slots with the element's
// 4 FP32 instructions.
//
// Bound on this card. Each (b, t, d) moves x, dt and y (12 bytes in f32)
// against N exponentials and ~7 N flops, so at N 16 the call is bound by
// bytes (3.35 TB/s) and by the exponentials on the SFUs (16 a clock per
// SM) about equally; chip_smoke.py reckons both. Only B * D / 128 blocks
// run (512 at the model's prefill, four warps each), so a block's chunk
// loads are hidden only by the other blocks of its SM; a cp.async ring
// that staged the next chunks while these ran was measured slower
// (scripts/scan_variants.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "packing.cuh"

namespace {

constexpr int SSM_THREADS = 128;  // channels a block
constexpr int SSM_CHUNK = 16;     // steps staged at a time
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the SFU's ex2 with subnormal results flushed to 0: within 2 ulp
// of 2^x, and 0 exactly where 2^x < 2^-126.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int N>
__global__ void __launch_bounds__(SSM_THREADS)
    ssm_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bt,
               const T* __restrict__ Ct, const float* h0, T* __restrict__ y,
               float* h_l, int L, int D) {
  __shared__ __align__(16) float sb[SSM_CHUNK * N];
  __shared__ __align__(16) float sc[SSM_CHUNK * N];
  __shared__ __align__(16) float sh[SSM_THREADS * N], sa[SSM_THREADS * N];
  const int nblk = (D + SSM_THREADS - 1) / SSM_THREADS;
  const int b = blockIdx.x / nblk, tid = threadIdx.x;
  const int d0 = (blockIdx.x % nblk) * SSM_THREADS, d = d0 + tid;
  const int nlive = min(SSM_THREADS, D - d0);  // the block's channels
  const bool live = d < D;
  const size_t row0 = static_cast<size_t>(b) * L;  // row (b, t) = row0 + t
  const size_t sbase = (static_cast<size_t>(b) * D + d0) * N;

  // The block's rows of h0 and of A are each one run of nlive * N floats:
  // read coalesced into shared memory, then a thread's N as float4s (N
  // strided loads a thread were most of a decode step's time). Threads
  // past D take what is there and store nothing.
  for (int e = tid; e < nlive * N; e += SSM_THREADS) {
    sh[e] = h0[sbase + e];
    sa[e] = A[static_cast<size_t>(d0) * N + e] * LOG2E;
  }
  __syncthreads();
  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; n += 4) {
    const float4 h4 = *reinterpret_cast<const float4*>(sh + tid * N + n);
    const float4 a4 = *reinterpret_cast<const float4*>(sa + tid * N + n);
    h[n] = h4.x, h[n + 1] = h4.y, h[n + 2] = h4.z, h[n + 3] = h4.w;
    a2[n] = a4.x, a2[n + 1] = a4.y, a2[n + 2] = a4.z, a2[n + 3] = a4.w;
  }

  for (int t0 = 0; t0 < L; t0 += SSM_CHUNK) {
    const int steps = min(SSM_CHUNK, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < steps * N; e += SSM_THREADS) {
      const size_t g = (row0 + t0) * N + e;
      sb[e] = tri::to_f32(Bt[g]);
      sc[e] = tri::to_f32(Ct[g]);
    }
    float xs[SSM_CHUNK], ds[SSM_CHUNK];
#pragma unroll
    for (int r = 0; r < SSM_CHUNK; ++r) {
      xs[r] = 0.f;
      ds[r] = 0.f;
      if (live && r < steps) {
        const size_t g = (row0 + t0 + r) * D + d;
        xs[r] = tri::to_f32(x[g]);
        ds[r] = tri::to_f32(dt[g]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < SSM_CHUNK; ++r) {
      if (r < steps) {
        const float dtr = ds[r], u = dtr * xs[r];
        const float* br = sb + r * N;
        const float* cr = sc + r * N;
        float y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(br + n);
          const float4 c4 = *reinterpret_cast<const float4*>(cr + n);
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
  // h_L the same way back (sh was last read before the chunks' barriers)
#pragma unroll
  for (int n = 0; n < N; n += 4)
    *reinterpret_cast<float4*>(sh + tid * N + n) = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  __syncthreads();
  for (int e = tid; e < nlive * N; e += SSM_THREADS) h_l[sbase + e] = sh[e];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bt, const void* Ct,
           const void* h0, void* y, void* h_l, int B, int L, int D, int N,
           cudaStream_t stream) {
  auto go = [&](auto n_c) -> int {
    constexpr int NS = decltype(n_c)::value;
    const long long blocks = static_cast<long long>(B) * ((D + SSM_THREADS - 1) / SSM_THREADS);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ssm_kernel<T, NS><<<static_cast<unsigned>(blocks), SSM_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(Bt), static_cast<const T*>(Ct), static_cast<const float*>(h0),
        static_cast<T*>(y), static_cast<float*>(h_l), L, D);
    return static_cast<int>(cudaGetLastError());
  };
  switch (N) {
    case 4: return go(std::integral_constant<int, 4>{});
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
    case 32: return go(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, dt: (B, L, D) and Bt, Ct: (B, L, N) of `dtype` (0 f32, 1 bf16); A
// (D, N) f32; h0, h_l (B, D, N) f32, possibly the same buffer; y (B, L, D)
// of `dtype`. N in {4, 8, 16, 32}.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* A, const void* Bt,
                               const void* Ct, const void* h0, void* y, void* h_l, int B,
                               int L, int D, int N, int dtype, void* stream) {
  if (B < 1 || L < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return tri::dispatch_dtype(dtype, [&](auto t) -> int {
    using T = typename decltype(t)::type;
    return launch<T>(x, dt, A, Bt, Ct, h0, y, h_l, B, L, D, N,
                     static_cast<cudaStream_t>(stream));
  });
}
