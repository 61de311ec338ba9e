// Triangular-domain attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of repro/kernels/tri_attn/kernel.py:bwd:
//  - tri_bwd_dq (_dq_kernel): dq over the row-major lambdas;
//  - tri_bwd_dkv (_dkv_kernel): dk/dv over the column-major lambdas.
// delta = sum(do * out) is computed by the wrapper (kernel.py:bwd), as the
// reference computes it outside its kernels.
//
// Design. The Pallas grids run in order on one core: dq zeroes its
// accumulator at a row's first lambda and emits at its last, dk/dv do the
// same per column. CUDA blocks run in no order, so each accumulator owner
// is one block that walks its tiles in the reference's order:
//  - dq: one block per (batch, head, q-row tile i), grid (n, H, B), rows
//    issued longest first; the block walks j over [first_col(i),
//    last_col(i)] (tri::dq_row_tile).
//  - dk/dv: one block per (batch, KV head, key-column tile j), grid
//    (n, Hkv, B), column 0 (the longest) first; the block sums over the g
//    query heads of its group and rows i over [cm_first_row(j),
//    cm_last_row(j)] (tri::dkv_col_tile), and writes dk and dv in k's dtype
//    directly. The reference writes per-q-head partials and group-sums
//    them only because a Pallas output block cannot accumulate across the
//    head axis; here there is no partial buffer and no group sum.
// Neither kernel uses atomics: every output element is reduced in one
// fixed order, so two runs on the same inputs are bitwise equal. dq follows
// the reference's order of sums; dk/dv sums the group's heads inside one
// accumulator, where the reference rounds each head's partial to q's dtype
// and sums them after, so dk/dv match the reference within tolerance, not
// bitwise.
//
// Bound on this card. Per tile pair dq does 6 * blk^2 * D flops (S, dP,
// dS K) and dk/dv 8 * blk^2 * D (S, dP, P^T dO, dS^T Q) over 2 * blk * D
// loaded values: both are bound by the tensor-core rate in bf16. This first
// version does the products on the f32 CUDA cores from shared memory and
// runs far from that bound; wgmma with P and dS in bf16 is the next step.
// Shared memory at blk 64, D 128: dq 108 KB (Q, dO, one 32-key chunk of K
// and V, dS), dk/dv 75 KB (32-key chunks of K and V, 32-query chunks of Q
// and dO, P and dS), with the accumulators in registers (32 floats a
// thread each way at 256 threads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = tri::PREFILL_NT;

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
tri_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H,
                  int Hkv, int S, int n, int w, int p, int win, int pre,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = n - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t qo = (static_cast<size_t>(b) * H + h) * plane;
  const size_t ko = (static_cast<size_t>(b) * Hkv + hk) * plane;
  const size_t ro = (static_cast<size_t>(b) * H + h) * S;
  tri::dq_row_tile<T, BLK, D>(q + qo, k + ko, v + ko, dout + qo, lse + ro,
                              delta + ro, dq + qo, 0, i, w, p, win, pre, scale,
                              reinterpret_cast<float*>(smem));
}

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
tri_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int Hkv, int S, int n, int w,
                   int p, int win, int pre, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t qo = (static_cast<size_t>(b) * H + hk * g) * plane;
  const size_t ko = (static_cast<size_t>(b) * Hkv + hk) * plane;
  const size_t ro = (static_cast<size_t>(b) * H + hk * g) * S;
  tri::dkv_col_tile<T, BLK, D>(q + qo, k + ko, v + ko, dout + qo, lse + ro,
                               delta + ro, dk + ko, dv + ko, g, S, 0, j, n, w,
                               p, win, pre, scale,
                               reinterpret_cast<float*>(smem));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv share it; lse
// and delta are (B, H, S) f32). (n, w, p) and win / pre as in
// tri_fwd_launch.
extern "C" int tri_bwd_dq_launch(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int Hkv, int S, int D, int blk, int n, int w,
                                 int p, int win, int pre, float scale,
                                 int dtype, void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    auto kern = tri_bwd_dq_kernel<T, BLK, DD>;
    constexpr size_t bytes = tri::DqShape<BLK, DD>::BYTES;
    if (int err = tri::set_smem(kern, bytes)) return err;
    kern<<<dim3(n, H, B), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), H, Hkv, S, n, w, p, win, pre, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int tri_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int H, int Hkv, int S, int D,
                                  int blk, int n, int w, int p, int win,
                                  int pre, float scale, int dtype,
                                  void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    auto kern = tri_bwd_dkv_kernel<T, BLK, DD>;
    constexpr size_t bytes = tri::DkvShape<BLK, DD>::BYTES;
    if (int err = tri::set_smem(kern, bytes)) return err;
    kern<<<dim3(n, Hkv, B), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, S, n, w, p, win,
        pre, scale);
    return static_cast<int>(cudaGetLastError());
  });
}
