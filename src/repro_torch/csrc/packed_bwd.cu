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
// Design. The Pallas grids run in order on one core: dq zeroes its
// accumulator at a row's first lambda and emits at its last, dk/dv do the
// same per column. CUDA blocks run in no order, so each accumulator owner
// is one block that walks its member's tiles in the reference's order,
// with the tile bodies of tri_bwd.cu (attn_tiles.cuh) and the member's
// first tile row as their row0:
//  - dq: one block per (packed q-row tile, head, batch), grid
//    (sum_r n_r, H, B). The block finds its member by request_from_starts
//    over the table's tile-row offsets, as packed_fwd.cu does; its row
//    within the member is the tile less the member's first row; it walks
//    j over [first_col(i), last_col(i)] (tri::dq_row_tile).
//  - dk/dv: one block per (packed key-column tile, kv head, batch), grid
//    (sum_r n_r, Hkv, B). A member has as many key-column tiles as q-row
//    tiles, so the same search over the same offsets finds the column's
//    member; the block sums over the g query heads of its group and rows i
//    over [cm_first_row(j), cm_last_row(j)] (tri::dkv_col_tile) -- rows
//    above the diagonal for a prefix column j < p -- and writes dk and dv
//    once, in k's dtype. The reference writes per-q-head partials and
//    group-sums them after (kernel.py:654-658); here there is no partial
//    buffer and no group sum.
// Neither kernel uses atomics: every output element is reduced in one
// fixed order, so two runs on the same inputs are bitwise equal.
//
// Bound on this card. Per tile pair dq does 6 * blk^2 * D flops (S, dP,
// dS K) and dk/dv 8 * blk^2 * D (S, dP, P^T dO, dS^T Q) over 2 * blk * D
// loaded values: both are bound by the tensor-core rate in bf16. Like
// tri_bwd.cu, this first version does the products on the f32 CUDA cores
// from shared memory and runs far from that bound; wgmma with P and dS in
// bf16 is the next step. Shared memory at blk 64, D 128: dq 108 KB, dk/dv
// 75 KB (tri::DqShape, tri::DkvShape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = tri::PREFILL_NT;

// The member of packed tile row (or key column) `tile`: its index r in the
// (7, R) table, found over the cumulative tile-row offsets (row 1).
__device__ __forceinline__ int member_of(int tile, const int* tbl, int R) {
  return tri::request_from_starts(tile, tbl + R, R);
}

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
packed_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     const int* __restrict__ tbl, int R, int H, int Hkv,
                     int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
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
__global__ void __launch_bounds__(NT)
packed_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, const int* __restrict__ tbl, int R,
                      int H, int Hkv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int r = member_of(tile, tbl, R);
  const int row0 = tbl[R + r];
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t qo = (static_cast<size_t>(b) * H + hk * g) * plane;
  const size_t ko = (static_cast<size_t>(b) * Hkv + hk) * plane;
  const size_t ro = (static_cast<size_t>(b) * H + hk * g) * S;
  tri::dkv_col_tile<T, BLK, D>(q + qo, k + ko, v + ko, dout + qo, lse + ro,
                               delta + ro, dk + ko, dv + ko, g, S, row0,
                               tile - row0, tbl[2 * R + r], tbl[3 * R + r],
                               tbl[4 * R + r], tbl[5 * R + r],
                               tbl[6 * R + r], scale,
                               reinterpret_cast<float*>(smem));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv share it; lse
// and delta are (B, H, S) f32). tbl is the (7, n_members) int32 member
// table on the device; total_tiles = sum of the members' n (the grid's x).
extern "C" int packed_bwd_dq_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int H, int Hkv, int S,
                                    int D, int blk, const void* tbl,
                                    int n_members, int total_tiles,
                                    float scale, int dtype, void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    auto kern = packed_bwd_dq_kernel<T, BLK, DD>;
    constexpr size_t bytes = tri::DqShape<BLK, DD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(total_tiles, H, B), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), static_cast<const int*>(tbl), n_members, H, Hkv,
        S, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int packed_bwd_dkv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Hkv, int S, int D, int blk,
                                     const void* tbl, int n_members,
                                     int total_tiles, float scale, int dtype,
                                     void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    auto kern = packed_bwd_dkv_kernel<T, BLK, DD>;
    constexpr size_t bytes = tri::DkvShape<BLK, DD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(total_tiles, Hkv, B), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<const int*>(tbl),
        n_members, H, Hkv, S, scale);
    return static_cast<int>(cudaGetLastError());
  });
}
