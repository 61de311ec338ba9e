// Triangular-domain attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:fwd
// (_fwd_kernel): flash attention over one request's ltm / band / prefix
// tile domain, online softmax in f32, GQA head h reads kv head h / (H / Hkv),
// out in q's dtype and lse (B, H, S) in f32. It is the forward of every
// layer of a training step (and of its recompute under remat).
//
// Grid. The Pallas grid walks its row-major lambdas in order on one core and
// carries the softmax state from a row's first tile to its last. CUDA
// blocks run in no order, so each accumulator owner, one (batch, head,
// q-row tile), is one block: grid (n, H, B), no atomics, two runs bitwise
// equal. The block walks its row's lambdas through the device g(lambda) in
// the reference's order and loads no tile outside the domain. Rows are
// issued longest first (blockIdx.x 0 is row n - 1), so the long serial
// walks start early and do not form the tail.
//
// Bound on this card. A tile is 4 blk^2 D flops over 2 blk D loaded K/V
// values, so the kernel is bound by the bf16 tensor-core rate: at (B 1,
// H 32, S 4096, D 128, ltm) 137.5 GFLOP, 0.139 ms at 989 TFLOP/s.
//
// bf16 runs on the tensor cores (tri::tc::row_tile, attn_mma.cuh): 2 blk
// threads, one warp per 16 rows; S = Q K^T and O += P V by wgmma at blk 64
// and 128 (one warpgroup per 64 rows, P the register A operand) and by
// mma.sync.m16n8k16 at blk 16 and 32. Q stays in shared memory for the
// walk; K and V go through a two-stage ring (swizzled TMA tiles at blk 64
// and 128, cp.async at 16 and 32), so the next tile's copy overlaps this
// tile's products; S, O and P stay in registers (blk / 2 + D / 2 f32 and
// blk / 4 packed bf16 pairs a thread: 32 + 64 + 16 at blk 64, D 128; ptxas
// gives that instantiation 128 registers, no spills). Shared memory is
// 5 blk D 2 bytes plus three mbarriers and 1 KB of alignment: 81 KB at
// blk 64, D 128 (two blocks an SM), 161 KB at blk 128 (one). Head dim 192
// (nemotron-4) takes the same body: 123,928 bytes at blk 64; at blk 128
// two stages would take 246,808, over the 232,448 a block may take, so
// the ring keeps one (148,496) and the next tile's copy no longer
// overlaps this tile's products.
//
// float32 keeps the CUDA-core body (tri::prefill_row_tile, attn_tiles.cuh,
// scalar f32 FMAs): the reference computes in f32 and TF32 would compute
// something else, and no full-width path runs attention in f32. The C entry
// dispatches on the dtype, nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

template <int BLK, int D>
__global__ void __launch_bounds__(tri::tc::Shape<BLK, D>::NT)
tri_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int H, int Hkv, int S, int n, int w, int p, int win, int pre,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  const int i = n - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  const int q_row = (b * H + h) * S, kv_row = (b * Hkv + hk) * S;
  const tri::tc::Src src{&tq, &tk, &tv, q_row, kv_row,
                         q + static_cast<size_t>(q_row) * D,
                         k + static_cast<size_t>(kv_row) * D,
                         v + static_cast<size_t>(kv_row) * D};
  tri::tc::row_tile<BLK, D>(src, out + (static_cast<size_t>(b) * H + h) * plane,
                            lse + (static_cast<size_t>(b) * H + h) * S, 0, i,
                            n, w, p, win, pre, scale, smem);
}

constexpr int NT_F32 = tri::PREFILL_NT;

template <int BLK, int D>
__global__ void __launch_bounds__(NT_F32)
tri_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, int H, int Hkv, int S, int n,
                   int w, int p, int win, int pre, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i = n - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  tri::prefill_row_tile<float, BLK, D>(
      q + (static_cast<size_t>(b) * H + h) * plane,
      k + (static_cast<size_t>(b) * Hkv + hk) * plane,
      v + (static_cast<size_t>(b) * Hkv + hk) * plane,
      out + (static_cast<size_t>(b) * H + h) * plane,
      lse + (static_cast<size_t>(b) * H + h) * S, 0, i, n, w, p, win, pre,
      scale, reinterpret_cast<float*>(smem));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse is f32).
// (n, w, p): tiles per side, band width in tiles (n unbanded), prefix
// width in tiles (0 = none); win / pre: window and prefix in tokens. The
// bf16 body copies 16 bytes at a time: q, k, v and out must be 16-byte
// aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int tri_fwd_launch(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int H, int Hkv,
                              int S, int D, int blk, int n, int w, int p,
                              int win, int pre, float scale, int dtype,
                              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
          15)
        return static_cast<int>(cudaErrorMisalignedAddress);
      using Sh = tri::tc::Shape<BLK, DD>;
      CUtensorMap maps[3] = {};
      if (int err = tri::tc::make_tmaps<BLK, DD>(maps, q, k, v, B, H, Hkv, S))
        return err;
      auto kern = tri_fwd_tc_kernel<BLK, DD>;
      if (int err = tri::set_smem(kern, Sh::ROW_BYTES)) return err;
      kern<<<dim3(n, H, B), Sh::NT, Sh::ROW_BYTES, st>>>(
          maps[0], maps[1], maps[2], static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), static_cast<float*>(lse), H, Hkv, S, n, w, p,
          win, pre, scale);
    } else {
      auto kern = tri_fwd_f32_kernel<BLK, DD>;
      constexpr size_t bytes = tri::FwdShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(n, H, B), NT_F32, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), H, Hkv, S, n, w, p, win, pre, scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
