// Fused continuous-batching step for Hopper (sm_90a): the round's newly
// admitted prompts and every live decode slot in ONE launch.
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:fused_step_fwd
// (_fused_step_kernel), driven by the same (8, R) member table:
//   starts | kind | n or kv_tiles | w_b or kv_len | p_b or kv_first |
//   q_off or slot | win | pre
// with the r_p prefill columns (kind 0) first, then B decode columns and the
// pad member (kind 1).
//
// Design. The Pallas grid walks (H, capacity) in order on one core, and a
// decode row even broadcasts its single query over a blk-row tile and keeps
// row 0. Here every accumulator owner gets its own block, all in one 1-D
// grid:
//   - decode blocks first, one per (decode chunk, head slice), in
//     packed_decode.cu's chunks and with its body (tri::decode_walk,
//     attn_decode.cuh): ceil((tiles - prefill steps) / CT) + decode columns
//     chunk blocks, each DECODE_CHUNK cache tokens of one slot for up to 8
//     query heads of one kv head, a member's chunks merged in chunk order by
//     the last to arrive. Empty columns (slot 0, no tiles) and the pad
//     member (slot == B, DECODE_NO_EMIT) have no chunks: they never write
//     o_dec, and a round without a live slot writes nothing there.
//   - prefill blocks, one per (pack q-row tile, q head), in the order
//     tri::prefill_owner names: each finds its member by binary search over
//     the prefill columns' q_off row and walks its row's member-local
//     lambdas through member_map_params with packed_fwd.cu's body.
// The bodies live in attn_tiles.cuh / attn_mma.cuh / attn_decode.cuh, so
// the prefill half is bitwise equal to packed_fwd and the decode half to
// packed_decode. bf16 q runs packed_fwd's tensor-core body
// (tri::tc::row_tile over tensor maps of the pack's (1, H, S_pack, D)
// q/k/v, wgmma at blk 64 and 128, mma.sync at 16 and 32) at its 2 blk
// threads; f32 q keeps the CUDA-core body at 256 threads. The grid has one
// blockDim, FusedShape::NT: 2 blk threads with bf16 q (128 at blk 64), 256
// with f32 q, and the decode body runs at that count (256 in
// packed_decode; each of its output elements is computed by the same
// sequence of operations at any count).
//
// Bound on this card. The prefill half sits above the bf16 ridge (tensor
// core rate), the decode half far below it (HBM bandwidth). A decode block
// walks one chunk (2 tiles at blk 64), no longer a whole slot of up to 32
// tiles, so the decode blocks, issued first, end well before the prefill
// blocks behind them.
//
// Dynamic shared memory is the larger of the two halves' needs
// (tri::DecodeShape: a chunk's ring of K/V tiles, 143 KB with an f32 cache
// at D 128; at D 192 the f32 cache's ring takes 211,072 bytes at blk 64
// and 215,168 at blk 128, over the prefill half's 123,928 and 148,496,
// within the 232,448 a block may take at every blk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attn_decode.cuh"

namespace {

// The fused grid's geometry for q's dtype TQ: NT threads a block (the
// prefill body's own count) and PREFILL_BYTES of shared memory for it.
template <typename TQ, int BLK, int D>
struct FusedShape {
  using Sh = tri::tc::Shape<BLK, D>;
  static constexpr bool TC = std::is_same_v<TQ, __nv_bfloat16>;
  static constexpr int NT = TC ? Sh::NT : tri::PREFILL_NT;
  static constexpr size_t PREFILL_BYTES =
      TC ? Sh::ROW_BYTES : tri::FwdShape<BLK, D>::BYTES;
};

// One block an SM is all the launch bounds promise: with the thread count
// alone, ptxas capped the 64-thread (blk 32) instantiations' registers at
// 64 to 168 and spilled (H100 build, sm_90a).
template <typename TQ, typename TC, int BLK, int D>
__global__ void __launch_bounds__(FusedShape<TQ, BLK, D>::NT, 1)
fused_step_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const TQ* __restrict__ qp, const TQ* __restrict__ kp,
                  const TQ* __restrict__ vp, TQ* __restrict__ op,
                  const TQ* __restrict__ qd, const TC* __restrict__ kc,
                  const TC* __restrict__ vc, TQ* __restrict__ od,
                  const int* __restrict__ tbl, float* __restrict__ ws,
                  int* __restrict__ arrivals, int n_members, int r_p,
                  int pack_tiles, int dec_chunks, int H, int Hkv, int S_pack,
                  int B, int S_cache, float scale) {
  using Fs = FusedShape<TQ, BLK, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = n_members;
  const int slices = tri::decode_head_slices(H, Hkv);
  const int bid = blockIdx.x;
  if (bid < dec_chunks * slices) {
    // the decode columns r_p .. R - 1 of the (8, R) table
    const tri::DecodeArgs<TQ, TC> a{
        qd, kc, vc, od, tbl + 5 * R + r_p, tbl + 2 * R + r_p,
        tbl + 3 * R + r_p, tbl + 4 * R + r_p, R - r_p, ws, arrivals, B, H,
        Hkv, S_cache, scale};
    tri::decode_walk<TQ, TC, BLK, D, Fs::NT>(a, bid / slices, dec_chunks,
                                             bid % slices, smem);
    return;
  }
  const int dec_blocks = dec_chunks * slices;
  const int* q_off = tbl + 5 * R;
  const int2 th = tri::prefill_owner(bid - dec_blocks, H);
  const int tile = th.x, h = th.y;
  const int hk = h / (H / Hkv);
  const int r = tri::request_from_starts(tile, q_off, r_p);
  if constexpr (Fs::TC) {
    const tri::tc::Src src{&tq, &tk, &tv, h * S_pack, hk * S_pack,
                           qp + static_cast<size_t>(h) * S_pack * D,
                           kp + static_cast<size_t>(hk) * S_pack * D,
                           vp + static_cast<size_t>(hk) * S_pack * D};
    tri::tc::row_tile<BLK, D>(
        src, op + static_cast<size_t>(h) * S_pack * D, nullptr, q_off[r],
        tile - q_off[r], tbl[2 * R + r], tbl[3 * R + r], tbl[4 * R + r],
        tbl[6 * R + r], tbl[7 * R + r], scale, tri::tc::align_1k(smem));
  } else {
    const size_t head_elems = static_cast<size_t>(S_pack) * D;
    tri::prefill_row_tile<TQ, BLK, D>(
        qp + h * head_elems, kp + hk * head_elems, vp + hk * head_elems,
        op + h * head_elems, nullptr, q_off[r], tile - q_off[r],
        tbl[2 * R + r], tbl[3 * R + r], tbl[4 * R + r], tbl[6 * R + r],
        tbl[7 * R + r], scale, reinterpret_cast<float*>(smem));
  }
}

struct Args {
  const void *qp, *kp, *vp;
  void* op;
  const void* qd;
  const void *kc, *vc;
  void* od;
  const void* tbl;
  void *ws, *arrivals;
  int n_members, r_p, pack_tiles, dec_tiles, B, H, Hkv, S_pack, S_cache;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int BLK, int D>
int launch_fused(const Args& a) {
  using Fs = FusedShape<TQ, BLK, D>;
  auto kern = fused_step_kernel<TQ, TC, BLK, D>;
  constexpr size_t dec_bytes = tri::DecodeShape<TC, BLK, D>::BYTES;
  constexpr size_t bytes =
      Fs::PREFILL_BYTES > dec_bytes ? Fs::PREFILL_BYTES : dec_bytes;
  static_assert(bytes <= tri::SMEM_LIMIT, "both halves fit");
  CUtensorMap maps[3] = {};
  if constexpr (Fs::TC) {
    if ((reinterpret_cast<uintptr_t>(a.qp) | reinterpret_cast<uintptr_t>(a.kp) |
         reinterpret_cast<uintptr_t>(a.vp) | reinterpret_cast<uintptr_t>(a.op)) &
        15)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (int err = tri::tc::make_tmaps<BLK, D>(maps, a.qp, a.kp, a.vp, 1, a.H,
                                              a.Hkv, a.S_pack))
      return err;
  }
  if (int err = tri::set_smem(kern, bytes)) return err;
  const int dec_chunks =
      tri::decode_chunk_blocks(a.dec_tiles, a.n_members - a.r_p, BLK);
  const int blocks =
      dec_chunks * tri::decode_head_slices(a.H, a.Hkv) + a.pack_tiles * a.H;
  kern<<<blocks, Fs::NT, bytes, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<const TQ*>(a.qp),
      static_cast<const TQ*>(a.kp), static_cast<const TQ*>(a.vp),
      static_cast<TQ*>(a.op), static_cast<const TQ*>(a.qd),
      static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc),
      static_cast<TQ*>(a.od), static_cast<const int*>(a.tbl),
      static_cast<float*>(a.ws), static_cast<int*>(a.arrivals), a.n_members,
      a.r_p, a.pack_tiles, dec_chunks, a.H, a.Hkv, a.S_pack, a.B, a.S_cache,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int BLK>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch_fused<TQ, TC, BLK, 16>(a);
    case 32: return launch_fused<TQ, TC, BLK, 32>(a);
    case 64: return launch_fused<TQ, TC, BLK, 64>(a);
    case 128: return launch_fused<TQ, TC, BLK, 128>(a);
    case 192: return launch_fused<TQ, TC, BLK, 192>(a);
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

// q_dtype (the pack's q/k/v, the decode queries and both outputs) and
// cache_dtype: 0 = float32, 1 = bfloat16. o_pack is (1, H, S_pack, D),
// every row written; o_dec has B + 1 rows, those of slots without a live
// decode member left unwritten. dec_tiles: the round's live decode tiles,
// which size the decode half's grid; ws and arrivals as packed_decode's
// over the R - r_p decode columns. The caches must be 16-byte aligned, and
// so must the pack's q, k, v and o_pack in bf16 (cudaErrorMisalignedAddress
// otherwise).
extern "C" int fused_step_launch(const void* qp, const void* kp,
                                 const void* vp, void* op, const void* qd,
                                 const void* kc, const void* vc, void* od,
                                 const void* tbl, void* ws, void* arrivals,
                                 int n_members, int r_p, int pack_tiles,
                                 int dec_tiles, int B, int H, int Hkv,
                                 int S_pack, int S_cache, int D, int blk,
                                 float scale, int q_dtype, int cache_dtype,
                                 void* stream) {
  const Args a{qp, kp, vp, op, qd, kc, vc, od, tbl, ws, arrivals,
               n_members, r_p, pack_tiles, dec_tiles, B, H, Hkv, S_pack,
               S_cache, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch_blk<float, float>(blk, D, a);
  if (q_dtype == 0 && cache_dtype == 1) return dispatch_blk<float, __nv_bfloat16>(blk, D, a);
  if (q_dtype == 1 && cache_dtype == 0) return dispatch_blk<__nv_bfloat16, float>(blk, D, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_blk<__nv_bfloat16, __nv_bfloat16>(blk, D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
