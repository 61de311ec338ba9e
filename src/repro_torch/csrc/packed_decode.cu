// Packed mixed-position decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:packed_decode_fwd
// (_packed_decode_kernel): one decode round, each live slot's single new
// query attending only its own cache tokens [kv_first, kv_len), described
// by the (5, R) member table (starts | slot | kv_tiles | kv_len | kv_first).
//
// Design. The Pallas grid (H, capacity) walks the concatenated member
// tiles in order and carries the softmax state along a member's tiles.
// Here a member's walk is cut into chunks of DECODE_CHUNK cache tokens from
// its first tile, and every (chunk, head slice) is a block: grid
// (ceil(tiles / CT) + R, Hkv ceil(g / 8)), CT = DECODE_CHUNK / blk
// (kernel.py's decode_grid). A block serves up to 8 query heads of one kv
// head, so each K/V tile is read from device memory once, not g times.
// The chunks of a member merge in this launch, in chunk order, in the block
// that arrives last (attn_decode.cuh); a member's chunking depends on its
// own (kv_first, kv_len) and blk alone, so a slot's output is the same
// bits in any round. Columns that own no tiles -- the empty columns
// make_decode_table fills with slot 0, and the pad member (slot == B,
// kv_tiles == DECODE_NO_EMIT) -- have no chunks and never write a live
// slot's output row. The grid does not walk the capacity pad steps.
//
// Bound on this card. Decode reads every cached K/V byte of the live
// members once and does 4 g flops per cached element pair: far below the
// ridge, so the bound is HBM bandwidth. One block a (member, kv head) ran
// 16 blocks on the 132 SMs at B = 4, Hkv = 4, each walking up to 32 tiles
// in series; chunks of 128 tokens give 112 blocks at that round's kv_lens
// (2000/37/900/300), each with its whole chunk in flight (cp.async into
// an mbarrier ring).
//
// Template parameters are the query and cache element types, covering the
// engine's bf16 queries against an f32 cache and the other combinations,
// the tile edge and the head dim (16-192). The block's body is tri::decode_walk
// (attn_decode.cuh), which the fused step kernel runs too, at its prefill
// body's thread count; both give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_decode.cuh"

namespace {

constexpr int NT = 256;

// One block an SM is all the launch bounds promise: with the thread count
// alone, ptxas capped some instantiations at 64 registers and spilled
// (H100 build, sm_90a).
template <typename TQ, typename TC, int BLK, int D>
__global__ void __launch_bounds__(NT, 1)
packed_decode_kernel(const tri::DecodeArgs<TQ, TC> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  tri::decode_walk<TQ, TC, BLK, D, NT>(a, blockIdx.x, gridDim.x, blockIdx.y,
                                       smem);
}

struct Args {
  const void *q, *k, *v;
  void* out;
  const int* tbl;
  void* ws;
  void* arrivals;
  int n_members, tiles, B, H, Hkv, S_cache;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int BLK, int D>
int launch_decode(const Args& a) {
  auto kern = packed_decode_kernel<TQ, TC, BLK, D>;
  constexpr size_t bytes = tri::DecodeShape<TC, BLK, D>::BYTES;
  if (int err = tri::set_smem(kern, bytes)) return err;
  const int R = a.n_members;
  // (5, R) table: starts | slot | kv_tiles | kv_len | kv_first
  const tri::DecodeArgs<TQ, TC> d{
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k),
      static_cast<const TC*>(a.v), static_cast<TQ*>(a.out), a.tbl + R,
      a.tbl + 2 * R, a.tbl + 3 * R, a.tbl + 4 * R, R,
      static_cast<float*>(a.ws), static_cast<int*>(a.arrivals), a.B, a.H,
      a.Hkv, a.S_cache, a.scale};
  dim3 grid(tri::decode_chunk_blocks(a.tiles, R, BLK),
            tri::decode_head_slices(a.H, a.Hkv));
  kern<<<grid, NT, bytes, a.stream>>>(d);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int BLK>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch_decode<TQ, TC, BLK, 16>(a);
    case 32: return launch_decode<TQ, TC, BLK, 32>(a);
    case 64: return launch_decode<TQ, TC, BLK, 64>(a);
    case 128: return launch_decode<TQ, TC, BLK, 128>(a);
    case 192: return launch_decode<TQ, TC, BLK, 192>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TC>
int dispatch_blk(int blk, int D, const Args& a) {
  switch (blk) {
    case 16: return dispatch_d<TQ, TC, 16>(D, a);
    case 32: return dispatch_d<TQ, TC, 32>(D, a);
    case 64: return dispatch_d<TQ, TC, 64>(D, a);
    case 128: return dispatch_d<TQ, TC, 128>(D, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype / cache_dtype: 0 = float32, 1 = bfloat16. out has q's type and
// B + 1 rows; rows of slots without a live member are left unwritten.
// tiles: the round's live tiles (sum of member kv_tiles), which sizes the
// grid. ws: the f32 partials, R ceil(S_cache / DECODE_CHUNK) H (D + 2)
// floats; arrivals: R ceil(g / 8) Hkv int32 counters, 0 on entry and left
// 0. The caches must be 16-byte aligned (cp.async).
extern "C" int packed_decode_launch(const void* q, const void* k,
                                    const void* v, void* out, const void* tbl,
                                    void* ws, void* arrivals, int n_members,
                                    int tiles, int B, int H, int Hkv,
                                    int S_cache, int D, int blk, float scale,
                                    int q_dtype, int cache_dtype,
                                    void* stream) {
  const Args a{q, k, v, out, static_cast<const int*>(tbl), ws, arrivals,
               n_members, tiles, B, H, Hkv, S_cache, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch_blk<float, float>(blk, D, a);
  if (q_dtype == 0 && cache_dtype == 1)
    return dispatch_blk<float, __nv_bfloat16>(blk, D, a);
  if (q_dtype == 1 && cache_dtype == 0)
    return dispatch_blk<__nv_bfloat16, float>(blk, D, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_blk<__nv_bfloat16, __nv_bfloat16>(blk, D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
