// The RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/wkv_scan/kernel.py:
//   wkv (_wkv_kernel) -> wkv_launch. Per (batch b, head h) the state
//   S (hd x hd, f32) runs over t = 0 .. L-1:
//     out_t[j] = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//     S[i][j] <- e^{lw_t[i]} S[i][j] + k_t[i] v_t[j]
//   r, k, v, lw (B, L, H, hd) f32 or bf16 (one dtype), u (H, hd) f32,
//   s0 and s_L (B, H, hd, hd) f32, out (B, L, H, hd) in r's dtype;
//   hd in {8, 16, 32, 64}.
//
// The Pallas grid (B, H, L / block_l) carries S in scratch from one chunk
// to the next, which needs its steps in order. Here one block owns one
// (b, h) stream (grid B * H) and walks t in order itself, so no two
// blocks share state: no atomics, no cross-block order. The block has
// P * hd threads (P = 4, or 2 at hd 8): thread (j, q) keeps rows
// q * hd/P .. (q+1) * hd/P - 1 of column j of S in registers, with u of
// those rows. Each step it sums its rows' share of out_t[j] (and of the
// u-bonus), and the P partial sums of a column, held by adjacent lanes,
// meet in log2(P) shuffles. A chunk of block_l time steps is staged in
// shared memory first (r, k, e^{lw}, v; each row one coalesced load,
// e^{lw} computed once per element), then read as float4 broadcasts.
// The block reads its s0 before it writes s_L and touches no other
// (b, h), so s0 and s_L may be the same buffer (the decode step updates
// the cache in place). expf, not __expf: built without fast-math like
// every source here.
//
// Bound on this card. Each (b, t, h) moves 4 hd inputs and hd outputs
// against about 4 hd^2 flops, so at hd 64 the call is bound by bytes
// (3.35 TB/s) over f32 CUDA-core operations (67 TFLOP/s). This kernel is
// latency-bound instead: B * H blocks (128 at rwkv6-1.6b's B 4), one
// step after another, and the chunk loads are not overlapped with the
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "packing.cuh"

namespace {

// Staged chunk: r, k, e^lw, v, block_l x hd floats each.
inline size_t wkv_smem(int block_l, int hd) {
  return 4 * static_cast<size_t>(block_l) * hd * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD*(HD >= 16 ? 4 : 2))
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ lw,
               const float* __restrict__ u, const float* s0, T* __restrict__ out,
               float* s_l, int L, int H, int block_l) {
  constexpr int P = HD >= 16 ? 4 : 2;  // threads a column
  constexpr int R = HD / P;            // rows a thread
  constexpr int NT = HD * P;
  constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;
  float* sk = sr + block_l * HD;
  float* sw = sk + block_l * HD;
  float* sv = sw + block_l * HD;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, j = tid / P, q = tid % P, i0 = q * R;
  const size_t step = static_cast<size_t>(H) * HD;  // between time steps
  const size_t base = (static_cast<size_t>(b) * L * H + h) * HD;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD;

  float s[R], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    s[m] = s0[sbase + static_cast<size_t>(i0 + m) * HD + j];
    uu[m] = u[static_cast<size_t>(h) * HD + i0 + m];
  }

  for (int t0 = 0; t0 < L; t0 += block_l) {
    const int n = min(block_l, L - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 4
    for (int e = tid; e < n * HD; e += NT) {
      const size_t g = base + static_cast<size_t>(t0 + e / HD) * step + e % HD;
      sr[e] = tri::to_f32(r[g]);
      sk[e] = tri::to_f32(k[g]);
      sw[e] = expf(tri::to_f32(lw[g]));
      sv[e] = tri::to_f32(v[g]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* rt = sr + t * HD + i0;
      const float* kt = sk + t * HD + i0;
      const float* wt = sw + t * HD + i0;
      const float vj = sv[t * HD + j];
      float a0 = 0.f, a1 = 0.f, bonus = 0.f;
#pragma unroll
      for (int m = 0; m < R; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + m);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + m);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + m);
        a0 = fmaf(r4.x, s[m], a0);
        a1 = fmaf(r4.y, s[m + 1], a1);
        a0 = fmaf(r4.z, s[m + 2], a0);
        a1 = fmaf(r4.w, s[m + 3], a1);
        bonus = fmaf(r4.x * uu[m], k4.x, bonus);
        bonus = fmaf(r4.y * uu[m + 1], k4.y, bonus);
        bonus = fmaf(r4.z * uu[m + 2], k4.z, bonus);
        bonus = fmaf(r4.w * uu[m + 3], k4.w, bonus);
        s[m] = fmaf(w4.x, s[m], k4.x * vj);
        s[m + 1] = fmaf(w4.y, s[m + 1], k4.y * vj);
        s[m + 2] = fmaf(w4.z, s[m + 2], k4.z * vj);
        s[m + 3] = fmaf(w4.w, s[m + 3], k4.w * vj);
      }
      float part = fmaf(bonus, vj, a0 + a1);
#pragma unroll
      for (int o = 1; o < P; o <<= 1) part += __shfl_xor_sync(MASK, part, o);
      if (q == 0) out[base + static_cast<size_t>(t0 + t) * step + j] = tri::from_f32<T>(part);
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) s_l[sbase + static_cast<size_t>(i0 + m) * HD + j] = s[m];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* out, void* s_l, int B, int L, int H, int hd, int block_l,
           cudaStream_t stream) {
  auto go = [&](auto hd_c) -> int {
    constexpr int HD = decltype(hd_c)::value;
    constexpr int NT = HD * (HD >= 16 ? 4 : 2);
    const size_t bytes = wkv_smem(block_l, HD);
    auto kern = wkv_kernel<T, HD>;
    if (int err = tri::set_smem(kern, bytes)) return err;
    kern<<<B * H, NT, bytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(lw), static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<T*>(out), static_cast<float*>(s_l), L, H, block_l);
    return static_cast<int>(cudaGetLastError());
  };
  switch (hd) {
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
    case 32: return go(std::integral_constant<int, 32>{});
    case 64: return go(std::integral_constant<int, 64>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, lw: (B, L, H, hd) of `dtype` (0 f32, 1 bf16); u (H, hd) f32;
// s0, s_l (B, H, hd, hd) f32, possibly the same buffer; out (B, L, H, hd)
// of `dtype`. hd in {8, 16, 32, 64}; the chunk block_l >= 1 (the last
// chunk may be short).
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* lw,
                          const void* u, const void* s0, void* out, void* s_l, int B, int L,
                          int H, int hd, int block_l, int dtype, void* stream) {
  if (block_l < 1 || L < 1 || B < 1 || H < 1 ||
      wkv_smem(block_l, hd) > static_cast<size_t>(tri::SMEM_LIMIT))
    return static_cast<int>(cudaErrorInvalidValue);
  return tri::dispatch_dtype(dtype, [&](auto t) -> int {
    using T = typename decltype(t)::type;
    return launch<T>(r, k, v, lw, u, s0, out, s_l, B, L, H, hd, block_l,
                     static_cast<cudaStream_t>(stream));
  });
}
