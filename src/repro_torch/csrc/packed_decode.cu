// Packed mixed-position decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:packed_decode_fwd
// (_packed_decode_kernel): one decode round, each live slot's single new
// query attending only its own cache tokens [kv_first, kv_len), described
// by the (5, R) member table (starts | slot | kv_tiles | kv_len | kv_first).
//
// Design. The Pallas grid (H, capacity) walks the concatenated member
// tiles in order and carries the softmax state along a member's tiles.
// Here each accumulator owner gets one block: grid (n_members, Hkv). A
// block walks its member's kv_tiles cache tiles from kv_first / blk in the
// reference's order and serves all g = H / Hkv query heads of its kv head,
// so each K/V tile is read from device memory once, not g times. Columns
// that own no tiles -- the empty columns make_decode_table fills with
// slot 0, and the pad member (slot == B, kv_tiles == DECODE_NO_EMIT) --
// return before touching memory, so they can never overwrite a live
// slot's output row. The grid does not walk the capacity pad steps.
//
// Bound on this card. Decode reads every cached K/V byte of the live
// members once and does 4 * g flops per cached element pair: far below
// the ridge, so the bound is HBM bandwidth. With one block per
// (member, kv head) a round of B slots runs only B * Hkv blocks (16 at
// B = 4, Hkv = 4) on the 132 SMs, so the design keeps each block's
// memory pipe full instead: the next K/V tile streams into shared memory
// with cp.async while the current one is consumed (double buffering,
// single buffering where two tiles do not fit), a warp computes one key's
// g dot products with the queries held in registers and the lanes split
// over D, and 16 warps share a tile. Splitting a member's tiles across
// blocks, with a second pass that merges the partial softmax states, is
// the next step toward the bandwidth bound.
//
// Template parameters are the query and cache element types, covering the
// engine's bf16 queries against an f32 cache and the other combinations,
// and the head dim. The block's body is tri::decode_member
// (attn_tiles.cuh), which the fused step kernel runs too, at 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = 512;

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(NT)
packed_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                     const TC* __restrict__ vc, TQ* __restrict__ out,
                     const int* __restrict__ tbl, int n_members, int B, int H,
                     int Hkv, int S_cache, int blk, float scale, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (5, R) table: starts | slot | kv_tiles | kv_len | kv_first
  const int R = n_members;
  const int r = blockIdx.x, hk = blockIdx.y;
  tri::decode_member<TQ, TC, D, NT>(q, kc, vc, out, tbl[R + r], tbl[2 * R + r],
                                    tbl[3 * R + r], tbl[4 * R + r], hk, B, H,
                                    Hkv, S_cache, blk, scale, stages, smem_raw);
}

template <typename TQ, typename TC, int D>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  const void* tbl, int n_members, int B, int H, int Hkv,
                  int S_cache, int blk, float scale, cudaStream_t stream) {
  auto kern = packed_decode_kernel<TQ, TC, D>;
  const int g = H / Hkv;
  const int stages = tri::decode_stages(g, D, blk, sizeof(TC));
  const size_t bytes = tri::decode_smem_bytes(stages, g, D, blk, sizeof(TC));
  if (bytes > tri::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = tri::set_smem(kern, bytes)) return err;
  dim3 grid(n_members, Hkv);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<TQ*>(out),
      static_cast<const int*>(tbl), n_members, B, H, Hkv, S_cache, blk, scale,
      stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               const void* tbl, int R, int B, int H, int Hkv, int S_cache,
               int blk, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_decode<TQ, TC, 16>(q, k, v, out, tbl, R, B, H, Hkv, S_cache, blk, scale, st);
    case 32: return launch_decode<TQ, TC, 32>(q, k, v, out, tbl, R, B, H, Hkv, S_cache, blk, scale, st);
    case 64: return launch_decode<TQ, TC, 64>(q, k, v, out, tbl, R, B, H, Hkv, S_cache, blk, scale, st);
    case 128: return launch_decode<TQ, TC, 128>(q, k, v, out, tbl, R, B, H, Hkv, S_cache, blk, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype / cache_dtype: 0 = float32, 1 = bfloat16. out has q's type and
// B + 1 rows; rows of slots without a live member are left unwritten.
// The caches must be 16-byte aligned (cp.async).
extern "C" int packed_decode_launch(const void* q, const void* k,
                                    const void* v, void* out, const void* tbl,
                                    int n_members, int B, int H, int Hkv,
                                    int S_cache, int D, int blk, float scale,
                                    int q_dtype, int cache_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch_d<float, float>(D, q, k, v, out, tbl, n_members, B, H, Hkv, S_cache, blk, scale, st);
  if (q_dtype == 0 && cache_dtype == 1)
    return dispatch_d<float, __nv_bfloat16>(D, q, k, v, out, tbl, n_members, B, H, Hkv, S_cache, blk, scale, st);
  if (q_dtype == 1 && cache_dtype == 0)
    return dispatch_d<__nv_bfloat16, float>(D, q, k, v, out, tbl, n_members, B, H, Hkv, S_cache, blk, scale, st);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, out, tbl, n_members, B, H, Hkv, S_cache, blk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
