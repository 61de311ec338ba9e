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
//   - decode blocks first, one per (decode column, kv head): each streams
//     its slot's live cache tiles with cp.async for the g query heads of its
//     kv head (the body of packed_decode.cu). Their walks are long and
//     serial (up to 32 tiles at kv_len 2000, blk 64), so they start first
//     and do not become the tail. Empty columns (slot 0, no tiles) and the
//     pad member (slot == B, DECODE_NO_EMIT) return before any load: they
//     never write o_dec, and a round without a live slot writes nothing
//     there.
//   - prefill blocks, one per (pack q-row tile, q head): each finds its
//     member by binary search over the prefill columns' q_off row and walks
//     its row's member-local lambdas through member_map_params (the body of
//     packed_fwd.cu).
// Both bodies live in attn_tiles.cuh, so the prefill half runs the code of
// packed_fwd at the same 256 threads and is bitwise equal to it. The
// decode body runs at 256 threads here and 512 in packed_decode; each of
// its output elements is computed by the same sequence of operations at
// either count. 256 threads keep the prefill body's registers (~198 a
// thread) unspilled: a 512-thread block would cap them at 128.
//
// Bound on this card. The prefill half sits above the bf16 ridge (tensor
// core rate), the decode half far below it (HBM bandwidth); at the serving
// shapes the prefill blocks outnumber the decode blocks ~60 to 1, so the
// kernel's time is the prefill half's: f32 CUDA-core FMAs, far from the
// tensor-core bound, as in packed_fwd.
//
// Dynamic shared memory is the larger of the two halves' needs; the decode
// half double-buffers where two K/V tiles fit and single-buffers otherwise
// (blk 128, D 128, f32 cache), as packed_decode does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = tri::PREFILL_NT;

template <typename TQ, typename TC, int BLK, int D>
__global__ void __launch_bounds__(NT)
fused_step_kernel(const TQ* __restrict__ qp, const TQ* __restrict__ kp,
                  const TQ* __restrict__ vp, TQ* __restrict__ op,
                  const TQ* __restrict__ qd, const TC* __restrict__ kc,
                  const TC* __restrict__ vc, TQ* __restrict__ od,
                  const int* __restrict__ tbl, int n_members, int r_p,
                  int pack_tiles, int H, int Hkv, int S_pack, int B,
                  int S_cache, float scale, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = n_members;
  const int dec_blocks = (R - r_p) * Hkv;
  int bid = blockIdx.x;
  if (bid < dec_blocks) {
    const int c = r_p + bid / Hkv, hk = bid % Hkv;
    tri::decode_member<TQ, TC, D, NT>(
        qd, kc, vc, od, tbl[5 * R + c], tbl[2 * R + c], tbl[3 * R + c],
        tbl[4 * R + c], hk, B, H, Hkv, S_cache, BLK, scale, stages, smem);
    return;
  }
  bid -= dec_blocks;
  const int tile = bid % pack_tiles, h = bid / pack_tiles;
  const int hk = h / (H / Hkv);
  const int* q_off = tbl + 5 * R;
  const int r = tri::request_from_starts(tile, q_off, r_p);
  const size_t head_elems = static_cast<size_t>(S_pack) * D;
  tri::prefill_row_tile<TQ, BLK, D>(
      qp + h * head_elems, kp + hk * head_elems, vp + hk * head_elems,
      op + h * head_elems, nullptr, q_off[r], tile - q_off[r], tbl[2 * R + r],
      tbl[3 * R + r], tbl[4 * R + r], tbl[6 * R + r], tbl[7 * R + r], scale,
      reinterpret_cast<float*>(smem));
}

struct Args {
  const void *qp, *kp, *vp;
  void* op;
  const void* qd;
  const void *kc, *vc;
  void* od;
  const void* tbl;
  int n_members, r_p, pack_tiles, B, H, Hkv, S_pack, S_cache;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int BLK, int D>
int launch_fused(const Args& a) {
  auto kern = fused_step_kernel<TQ, TC, BLK, D>;
  const int g = a.H / a.Hkv;
  const int stages = tri::decode_stages(g, D, BLK, sizeof(TC));
  size_t bytes = tri::decode_smem_bytes(stages, g, D, BLK, sizeof(TC));
  if (tri::FwdShape<BLK, D>::BYTES > bytes) bytes = tri::FwdShape<BLK, D>::BYTES;
  if (bytes > tri::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.n_members - a.r_p) * a.Hkv + a.pack_tiles * a.H;
  kern<<<blocks, NT, bytes, a.stream>>>(
      static_cast<const TQ*>(a.qp), static_cast<const TQ*>(a.kp),
      static_cast<const TQ*>(a.vp), static_cast<TQ*>(a.op),
      static_cast<const TQ*>(a.qd), static_cast<const TC*>(a.kc),
      static_cast<const TC*>(a.vc), static_cast<TQ*>(a.od),
      static_cast<const int*>(a.tbl), a.n_members, a.r_p, a.pack_tiles, a.H,
      a.Hkv, a.S_pack, a.B, a.S_cache, a.scale, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int BLK>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch_fused<TQ, TC, BLK, 16>(a);
    case 32: return launch_fused<TQ, TC, BLK, 32>(a);
    case 64: return launch_fused<TQ, TC, BLK, 64>(a);
    case 128: return launch_fused<TQ, TC, BLK, 128>(a);
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
// decode member left unwritten. The caches must be 16-byte aligned.
extern "C" int fused_step_launch(const void* qp, const void* kp,
                                 const void* vp, void* op, const void* qd,
                                 const void* kc, const void* vc, void* od,
                                 const void* tbl, int n_members, int r_p,
                                 int pack_tiles, int B, int H, int Hkv,
                                 int S_pack, int S_cache, int D, int blk,
                                 float scale, int q_dtype, int cache_dtype,
                                 void* stream) {
  const Args a{qp, kp, vp, op, qd, kc, vc, od, tbl, n_members, r_p,
               pack_tiles, B, H, Hkv, S_pack, S_cache, scale,
               static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0 && cache_dtype == 0) return dispatch_blk<float, float>(blk, D, a);
  if (q_dtype == 0 && cache_dtype == 1) return dispatch_blk<float, __nv_bfloat16>(blk, D, a);
  if (q_dtype == 1 && cache_dtype == 0) return dispatch_blk<__nv_bfloat16, float>(blk, D, a);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_blk<__nv_bfloat16, __nv_bfloat16>(blk, D, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
