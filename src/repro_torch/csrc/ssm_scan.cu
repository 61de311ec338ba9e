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
// and keeps its N state floats and its row of A in registers. A chunk of
// SSM_CHUNK steps at a time: the block stages the chunk's Bt and Ct rows
// in shared memory (every thread reads them, as float4 broadcasts), and
// each thread loads its channel's x and dt of the chunk into registers
// (one coalesced row of the block a step), then runs the steps. The
// block reads its h0 before it writes h_L and touches no other (b, d),
// so h0 and h_L may be the same buffer (the decode step updates the
// cache in place). Any L >= 1 (a last chunk may be short) and any D (the
// threads past D only stage). exp(dt A) is taken as exp2f(dt (A log2 e))
// with A log2 e formed once a channel: one SFU ex2 a state element
// (built without fast-math, like every source here).
//
// Bound on this card. Each (b, t, d) moves x, dt and y (12 bytes in f32)
// against N exponentials and ~7 N flops, so at N 16 the call is bound
// either by bytes (3.35 TB/s) or by the exponentials on the SFUs (16 a
// clock per SM); chip_smoke.py reckons both. Only B * D / 128 blocks run
// (512 at the model's prefill, four warps each), so a block's chunk
// loads are hidden only by the other blocks of its SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "packing.cuh"

namespace {

constexpr int SSM_THREADS = 128;  // channels a block
constexpr int SSM_CHUNK = 16;     // steps staged at a time
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int N>
__global__ void __launch_bounds__(SSM_THREADS)
    ssm_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bt,
               const T* __restrict__ Ct, const float* h0, T* __restrict__ y,
               float* h_l, int L, int D) {
  __shared__ __align__(16) float sb[SSM_CHUNK * N];
  __shared__ __align__(16) float sc[SSM_CHUNK * N];
  const int nblk = (D + SSM_THREADS - 1) / SSM_THREADS;
  const int b = blockIdx.x / nblk;
  const int d = (blockIdx.x % nblk) * SSM_THREADS + threadIdx.x;
  const bool live = d < D;
  const size_t row0 = static_cast<size_t>(b) * L;  // row (b, t) = row0 + t
  const size_t hbase = (static_cast<size_t>(b) * D + d) * N;

  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h0[hbase + n] : 0.f;
    a2[n] = live ? A[static_cast<size_t>(d) * N + n] * LOG2E : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += SSM_CHUNK) {
    const int steps = min(SSM_CHUNK, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < steps * N; e += SSM_THREADS) {
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
          h[n] = fmaf(exp2f(dtr * a2[n]), h[n], u * b4.x);
          h[n + 1] = fmaf(exp2f(dtr * a2[n + 1]), h[n + 1], u * b4.y);
          h[n + 2] = fmaf(exp2f(dtr * a2[n + 2]), h[n + 2], u * b4.z);
          h[n + 3] = fmaf(exp2f(dtr * a2[n + 3]), h[n + 3], u * b4.w);
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
