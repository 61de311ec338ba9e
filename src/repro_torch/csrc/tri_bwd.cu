// Triangular-domain attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of repro/kernels/tri_attn/kernel.py:bwd:
//  - tri_bwd_dq (_dq_kernel, :1018, launched at :1103): dq over the
//    row-major lambdas;
//  - tri_bwd_dkv (_dkv_kernel, :1055, launched at :1126): dk/dv over the
//    column-major lambdas.
// delta = sum(do * out) is computed by the wrapper (kernel.py:bwd), as the
// reference computes it outside its kernels.
//
// Owners. The Pallas grids run in order on one core: dq zeroes its
// accumulator at a row's first lambda and emits at its last, dk/dv do the
// same per column. CUDA blocks run in no order, so each accumulator is
// owned by one block that walks its tiles in the reference's order, and
// no kernel uses atomics: every output element is reduced in one fixed
// order, so two runs on the same inputs are bitwise equal. dk/dv sum the
// group's g query heads inside one accumulator, where the reference
// rounds each head's partial to q's dtype and sums them after, so they
// match the reference within tolerance, not bitwise.
//  - dq: one block per (batch, head, q-row tile i), rows issued longest
//    first; the block walks j over [first_col(i), last_col(i)].
//  - dk/dv: one block per (batch, kv head, column pair): the fold. Column
//    j's walk (every query head, then rows over [cm_first_row(j),
//    cm_last_row(j)]) is g (n - j) tile steps for ltm, from g n down to g,
//    so one block a column leaves the card uneven once the body is fast
//    (at the training shape 256 owners of 8 to 512 steps, all resident in
//    one wave). A block takes column j, then column n - 1 - j (the middle
//    column alone when n is odd), each walked and written exactly as
//    before, so the results are bitwise those of the unfolded walk and
//    every ltm block does g (n + 1) steps: ceil(n / 2) Hkv B blocks (128 at
//    the training shape, one even wave on 132 SMs). The rectangular-box
//    fold of the paper, applied to the owners of a reduction. Band and
//    prefix columns fold by the same code.
//
// Bound on this card. Per (query, key) pair dq does 6 D flops (S, dP,
// dS K) and dk/dv 8 D (S, dP, P^T dO, dS^T Q) over 2 D loaded values a
// tile row: both are bound by the bf16 tensor-core rate (at B 1, H 32,
// S 4096, D 128, ltm: 206 and 275 GFLOP, 0.2085 and 0.2780 ms).
//
// bf16 at blk 64 and 128 runs on the tensor cores (attn_mma_bwd.cuh):
// 64 x 64 sub-tiles, wgmma with swizzled TMA tiles through a ring of
// stages, S / dP / the accumulators in registers, P and dS rounded to bf16
// only as A operands. dq: one warpgroup a block of 64 query rows (a blk
// 128 row tile is two blocks), grid (n blk / 64, H, B). dk/dv: two
// warpgroups a block of 64 keys (a blk 128 column is two blocks), grid
// (ceil(n / 2) blk / 64, Hkv, B): WG0 computes S^T, P^T and dV += P^T dO,
// hands P^T to WG1 through shared memory and named barriers, and WG1
// computes dP^T, dS^T and dK += dS^T Q, so each issues two of the four
// products and holds one accumulator. The two run decoupled: each thread
// releases a ring stage on an mbarrier, P^T alternates between two
// buffers, and WG0 computes the next step's P^T while WG1 finishes this
// one, where a block barrier a step would hold both to the slower.
// Shared memory at D 128: dq 97 KB (two ring stages, two blocks an SM; a
// third stage would cost the second block), dk/dv 163 KB (three ring
// stages, so WG0 may lead by two steps); at nemotron-4's D 192 dq 145 KB
// (one block an SM) and dk/dv 227 KB, the whole of a block's limit.
//
// float32 at every tile edge, and bf16 at blk 16 and 32, keep the
// CUDA-core bodies (tri::dq_row_tile / dkv_col_tile, attn_tiles.cuh,
// scalar f32 FMAs, the same fold): the reference computes in f32 and TF32
// would compute something else, and no bf16 main path runs the backward
// at blk 16 or 32. kernel.tile_body(dtype, blk, "bwd") names the body.
// Head dims 16-128 and 192 (tri::dispatch_tile, kernel.HEAD_DIMS); the f32
// dq at blk 128 x D 192 takes its keys in chunks of 16 (tri::DqShape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma_bwd.cuh"

namespace {

using tri::tc::BwdShape;
using tri::tc::QB;

template <int BLK, int D>
__global__ void __launch_bounds__(BwdShape<D>::DQ_NT)
tri_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S,
                     int n, int w, int p, int win, int pre, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  constexpr int NSUB = BLK / QB;
  const int r = n * NSUB - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q_row = (b * H + h) * S;
  const tri::tc::BwdSrc src{&tq, &tk, &tv, &tdo, q_row, (b * Hkv + hk) * S};
  tri::tc::dq_sub_row<BLK, D>(src, dq + static_cast<size_t>(q_row) * D,
                              lse + q_row, delta + q_row, 0, r / NSUB,
                              r % NSUB, w, p, win, pre, scale, smem);
}

template <int BLK, int D>
__global__ void __launch_bounds__(BwdShape<D>::DKV_NT)
tri_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S,
                      int n, int w, int p, int win, int pre, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  constexpr int NSUB = BLK / QB;
  const int pair = blockIdx.x / NSUB, half = blockIdx.x % NSUB;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int q_row = (b * H + hk * g) * S, kv_row = (b * Hkv + hk) * S;
  const tri::tc::BwdSrc src{&tq, &tk, &tv, &tdo, q_row, kv_row};
  tri::tc::BwdRing ring{0, 0};
  const size_t kv = static_cast<size_t>(kv_row) * D;
  const int cols = 2 * pair + 1 == n ? 1 : 2;  // the middle column of an odd n
  for (int c = 0; c < cols; ++c)
    tri::tc::dkv_sub_col<BLK, D>(src, lse + q_row, delta + q_row, dk + kv,
                                 dv + kv, g, S, 0, c ? n - 1 - pair : pair,
                                 half, n, w, p, win, pre, scale, smem, ring);
}

constexpr int NT_F32 = tri::PREFILL_NT;

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT_F32)
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
__global__ void __launch_bounds__(NT_F32)
tri_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int H, int Hkv, int S, int n, int w,
                   int p, int win, int pre, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pair = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t qo = (static_cast<size_t>(b) * H + hk * g) * plane;
  const size_t ko = (static_cast<size_t>(b) * Hkv + hk) * plane;
  const size_t ro = (static_cast<size_t>(b) * H + hk * g) * S;
  const int cols = 2 * pair + 1 == n ? 1 : 2;  // the middle column of an odd n
  for (int c = 0; c < cols; ++c)
    tri::dkv_col_tile<T, BLK, D>(q + qo, k + ko, v + ko, dout + qo, lse + ro,
                                 delta + ro, dk + ko, dv + ko, g, S, 0,
                                 c ? n - 1 - pair : pair, n, w, p, win, pre,
                                 scale, reinterpret_cast<float*>(smem));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv share it; lse
// and delta are (B, H, S) f32). (n, w, p) and win / pre as in
// tri_fwd_launch. On the bf16 tensor-core path every pointer must be
// 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int tri_bwd_dq_launch(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int Hkv, int S, int D, int blk, int n, int w,
                                 int p, int win, int pre, float scale,
                                 int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    if constexpr (tri::tc::kTensorCores<T, BLK>) {
      if (tri::tc::misaligned({q, k, v, dout, lse, delta, dq}))
        return static_cast<int>(cudaErrorMisalignedAddress);
      CUtensorMap maps[4] = {};
      if (int err = tri::tc::make_bwd_tmaps<DD>(maps, q, k, v, dout, B, H,
                                                Hkv, S))
        return err;
      auto kern = tri_bwd_dq_tc_kernel<BLK, DD>;
      constexpr size_t bytes = BwdShape<DD>::DQ_BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(n * (BLK / QB), H, B), BwdShape<DD>::DQ_NT, bytes, st>>>(
          maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<T*>(dq), H, Hkv, S, n,
          w, p, win, pre, scale);
    } else {
      auto kern = tri_bwd_dq_kernel<T, BLK, DD>;
      constexpr size_t bytes = tri::DqShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(n, H, B), NT_F32, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), H, Hkv, S, n, w, p, win, pre, scale);
    }
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
  auto st = static_cast<cudaStream_t>(stream);
  const int pairs = (n + 1) / 2;
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    if constexpr (tri::tc::kTensorCores<T, BLK>) {
      if (tri::tc::misaligned({q, k, v, dout, lse, delta, dk, dv}))
        return static_cast<int>(cudaErrorMisalignedAddress);
      CUtensorMap maps[4] = {};
      if (int err = tri::tc::make_bwd_tmaps<DD>(maps, q, k, v, dout, B, H,
                                                Hkv, S))
        return err;
      auto kern = tri_bwd_dkv_tc_kernel<BLK, DD>;
      constexpr size_t bytes = BwdShape<DD>::DKV_BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(pairs * (BLK / QB), Hkv, B), BwdShape<DD>::DKV_NT, bytes,
             st>>>(maps[0], maps[1], maps[2], maps[3],
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<T*>(dk),
                   static_cast<T*>(dv), H, Hkv, S, n, w, p, win, pre, scale);
    } else {
      auto kern = tri_bwd_dkv_kernel<T, BLK, DD>;
      constexpr size_t bytes = tri::DkvShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(pairs, Hkv, B), NT_F32, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, S, n, w, p, win,
          pre, scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
