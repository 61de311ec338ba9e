// Packed ragged attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of repro/kernels/tri_attn/kernel.py:packed_bwd:
//  - packed_bwd_dq (_packed_dq_kernel): dq over the row-major packed grid;
//  - packed_bwd_dkv (_packed_dkv_kernel): dk/dv over the column-major
//    packed grid (member_cm_map_params).
// Both read the forward's (7, R) member table (PackedTriSched.table():
// starts | rows | n | w_b | p_b | win | pre), so R documents of mixed
// lengths, each an ltm, band or prefix member, are differentiated in one
// launch per direction, sum_r tiles(member r) tile steps a head, with no
// tile across two documents. delta = sum(do * out) is computed by the
// wrapper (kernel.py:packed_bwd), as the reference computes it outside its
// kernels.
//
// Owners. The Pallas grids run in order on one core: dq zeroes its
// accumulator at a row's first lambda and emits at its last, dk/dv do the
// same per column. CUDA blocks run in no order, so each accumulator is
// owned by one block that walks its member's tiles in the reference's
// order, with the tile bodies of tri_bwd.cu and the member's first tile
// row as their row0:
//  - dq: one block per (packed q-row tile, head, batch). A block finds its
//    member by request_from_starts over the table's tile-row offsets, as
//    packed_fwd.cu does; its row within the member is the tile less the
//    member's first row; it walks j over [first_col(i), last_col(i)].
//  - dk/dv: one block per (column pair of one member, kv head, batch): the
//    fold of tri_bwd.cu inside each member. Member r has ceil(n_r / 2)
//    pairs (j, n_r - 1 - j), the middle column of an odd n_r alone; the
//    block finds its member and j by counting pairs over the table's n
//    row (pair_of), sums over the g query heads of its group and rows i
//    over [cm_first_row(j), cm_last_row(j)] -- rows above the diagonal for
//    a prefix column j < p -- writes dk and dv once, in k's dtype, then
//    walks the partner column the same way. Each column is walked and
//    written as unfolded, so the result is bitwise that of one block a
//    column. The reference writes per-q-head partials and group-sums them
//    after (kernel.py:654-658); here there is no partial buffer and no
//    group sum.
// Blocks are numbered head fastest (block_owner): the card starts one
// owner's blocks for every head together, in the pack's order. Starting
// the longest walks first (the last rows of the largest member) measured
// slower for dq at the packed train shape, and no order moved dk/dv, one
// wave there (PERF.md §6).
// Neither kernel uses atomics: every output element is reduced in one
// fixed order, so two runs on the same inputs are bitwise equal.
//
// Bound on this card. Per (query, key) pair dq does 6 D flops (S, dP,
// dS K) and dk/dv 8 D (S, dP, P^T dO, dS^T Q) over 2 D loaded values a
// tile row: both are bound by the bf16 tensor-core rate. bf16 at blk 64
// and 128 runs the wgmma backward of attn_mma_bwd.cuh, the body of
// tri_bwd.cu (64 x 64 sub-tiles: a blk 128 row tile is two dq blocks, a
// column pair two dk/dv blocks; S / dP in f32, P and dS in bf16 only as A
// operands; dq one warpgroup and a 2-stage K/V ring, dk/dv two warpgroups
// and a 3-stage Q/dO ring). float32 at every tile edge, and bf16 at blk
// 16 and 32, keep the CUDA-core bodies (tri::dq_row_tile / dkv_col_tile,
// scalar f32 FMAs) with the same owners and fold. kernel.tile_body(dtype,
// blk, "bwd") names the body. The fold evens each member's pairs, not the
// members: at the training shape (8 ltm members of 24 to 1 tiles, blk 64,
// g 8) dk/dv is 33 pairs x 4 kv heads = 132 blocks, one wave, whose
// largest member's blocks walk g (n + 1) = 200 sub-tile steps and whose
// smallest walk 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma_bwd.cuh"

namespace {

using tri::tc::BwdShape;
using tri::tc::QB;

constexpr int NT_F32 = tri::PREFILL_NT;

// The member of packed tile row (or key column) `tile`: its index r in the
// (7, R) table, found over the cumulative tile-row offsets (row 1).
__device__ __forceinline__ int member_of(int tile, const int* tbl, int R) {
  return tri::request_from_starts(tile, tbl + R, R);
}

// This block's owner: (slot, head), numbered head fastest over the grid
// (slots, heads, batch). slot / NSUB is the dq row tile or the dk/dv
// column pair, slot % NSUB its 64-row (or 64-key) sub-block.
struct Owner {
  int slot, head;
};

__device__ __forceinline__ Owner block_owner() {
  const int flat = blockIdx.y * gridDim.x + blockIdx.x;
  return {flat / static_cast<int>(gridDim.y),
          flat % static_cast<int>(gridDim.y)};
}

// Column pair `pair` of the pack: its member r and first column j, the
// pairs counted member by member over the table's n row (row 2).
__device__ __forceinline__ int2 pair_of(int pair, const int* tbl, int R) {
  int r = 0;
  for (int c; r < R - 1 && pair >= (c = (tbl[2 * R + r] + 1) / 2); ++r)
    pair -= c;
  return make_int2(r, pair);
}

template <int BLK, int D>
__global__ void __launch_bounds__(BwdShape<D>::DQ_NT)
packed_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq,
                        const int* __restrict__ tbl, int R, int H, int Hkv,
                        int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  constexpr int NSUB = BLK / QB;
  const Owner o = block_owner();
  const int tile = o.slot / NSUB, b = blockIdx.z;
  const int hk = o.head / (H / Hkv);
  const int r = member_of(tile, tbl, R);
  const int row0 = tbl[R + r];
  const int q_row = (b * H + o.head) * S;
  const tri::tc::BwdSrc src{&tq, &tk, &tv, &tdo, q_row, (b * Hkv + hk) * S};
  tri::tc::dq_sub_row<BLK, D>(src, dq + static_cast<size_t>(q_row) * D,
                              lse + q_row, delta + q_row, row0, tile - row0,
                              o.slot % NSUB, tbl[3 * R + r], tbl[4 * R + r],
                              tbl[5 * R + r], tbl[6 * R + r], scale, smem);
}

template <int BLK, int D>
__global__ void __launch_bounds__(BwdShape<D>::DKV_NT)
packed_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         const int* __restrict__ tbl, int R, int H, int Hkv,
                         int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  constexpr int NSUB = BLK / QB;
  const Owner o = block_owner();
  const int2 rj = pair_of(o.slot / NSUB, tbl, R);
  const int r = rj.x, j = rj.y, half = o.slot % NSUB;
  const int hk = o.head, b = blockIdx.z;
  const int g = H / Hkv;
  const int row0 = tbl[R + r], n = tbl[2 * R + r];
  const int q_row = (b * H + hk * g) * S, kv_row = (b * Hkv + hk) * S;
  const tri::tc::BwdSrc src{&tq, &tk, &tv, &tdo, q_row, kv_row};
  tri::tc::BwdRing ring{0, 0};
  const size_t kv = static_cast<size_t>(kv_row) * D;
  const int cols = 2 * j + 1 == n ? 1 : 2;  // the middle column of an odd n
  for (int c = 0; c < cols; ++c)
    tri::tc::dkv_sub_col<BLK, D>(
        src, lse + q_row, delta + q_row, dk + kv, dv + kv, g, S, row0,
        c ? n - 1 - j : j, half, n, tbl[3 * R + r], tbl[4 * R + r],
        tbl[5 * R + r], tbl[6 * R + r], scale, smem, ring);
}

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT_F32)
packed_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     const int* __restrict__ tbl, int R, int H, int Hkv,
                     int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Owner o = block_owner();
  const int tile = o.slot, h = o.head, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = member_of(tile, tbl, R);
  const int row0 = tbl[R + r];
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t qo = (static_cast<size_t>(b) * H + h) * plane;
  const size_t ko = (static_cast<size_t>(b) * Hkv + hk) * plane;
  const size_t ro = (static_cast<size_t>(b) * H + h) * S;
  tri::dq_row_tile<T, BLK, D>(q + qo, k + ko, v + ko, dout + qo, lse + ro,
                              delta + ro, dq + qo, row0, tile - row0,
                              tbl[3 * R + r], tbl[4 * R + r], tbl[5 * R + r],
                              tbl[6 * R + r], scale,
                              reinterpret_cast<float*>(smem));
}

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT_F32)
packed_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, const int* __restrict__ tbl,
                      int R, int H, int Hkv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Owner o = block_owner();
  const int2 rj = pair_of(o.slot, tbl, R);
  const int r = rj.x, j = rj.y, hk = o.head, b = blockIdx.z;
  const int g = H / Hkv;
  const int row0 = tbl[R + r], n = tbl[2 * R + r];
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t qo = (static_cast<size_t>(b) * H + hk * g) * plane;
  const size_t ko = (static_cast<size_t>(b) * Hkv + hk) * plane;
  const size_t ro = (static_cast<size_t>(b) * H + hk * g) * S;
  const int cols = 2 * j + 1 == n ? 1 : 2;  // the middle column of an odd n
  for (int c = 0; c < cols; ++c)
    tri::dkv_col_tile<T, BLK, D>(q + qo, k + ko, v + ko, dout + qo, lse + ro,
                                 delta + ro, dk + ko, dv + ko, g, S, row0,
                                 c ? n - 1 - j : j, n, tbl[3 * R + r],
                                 tbl[4 * R + r], tbl[5 * R + r],
                                 tbl[6 * R + r], scale,
                                 reinterpret_cast<float*>(smem));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv share it; lse
// and delta are (B, H, S) f32). tbl is the (7, n_members) int32 member
// table on the device; owners the number of dq rows (sum of the members'
// n) or dk/dv column pairs (sum of ceil(n / 2)). The grid is (owners *
// blk / 64, heads, B) on the bf16 tensor-core path, where every pointer
// must be 16-byte aligned (cudaErrorMisalignedAddress otherwise), and
// (owners, heads, B) on the CUDA-core path.
extern "C" int packed_bwd_dq_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int H, int Hkv, int S,
                                    int D, int blk, const void* tbl,
                                    int n_members, int owners, float scale,
                                    int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tbl);
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
      auto kern = packed_bwd_dq_tc_kernel<BLK, DD>;
      constexpr size_t bytes = BwdShape<DD>::DQ_BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(owners * (BLK / QB), H, B), BwdShape<DD>::DQ_NT, bytes,
             st>>>(maps[0], maps[1], maps[2], maps[3],
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<T*>(dq), tb,
                   n_members, H, Hkv, S, scale);
    } else {
      auto kern = packed_bwd_dq_kernel<T, BLK, DD>;
      constexpr size_t bytes = tri::DqShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(owners, H, B), NT_F32, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), tb, n_members, H, Hkv, S, scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int packed_bwd_dkv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Hkv, int S, int D, int blk,
                                     const void* tbl, int n_members,
                                     int owners, float scale, int dtype,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tbl);
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
      auto kern = packed_bwd_dkv_tc_kernel<BLK, DD>;
      constexpr size_t bytes = BwdShape<DD>::DKV_BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(owners * (BLK / QB), Hkv, B), BwdShape<DD>::DKV_NT, bytes,
             st>>>(maps[0], maps[1], maps[2], maps[3],
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<T*>(dk),
                   static_cast<T*>(dv), tb, n_members, H, Hkv, S, scale);
    } else {
      auto kern = packed_bwd_dkv_kernel<T, BLK, DD>;
      constexpr size_t bytes = tri::DkvShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(owners, Hkv, B), NT_F32, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), tb, n_members, H, Hkv, S,
          scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
