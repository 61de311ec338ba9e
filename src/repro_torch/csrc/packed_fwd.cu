// Packed ragged prefill attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:packed_fwd
// (_packed_fwd_kernel): flash attention over R requests concatenated along
// S, each request attending only its own ltm / band / prefix tile domain,
// online softmax in f32, GQA head h reads kv head h / (H / Hkv).
//
// Design. The Pallas grid walks its lambda steps in order on one core and
// carries the softmax state from a row's first tile to its last. CUDA
// blocks run in no order, so this kernel gives each accumulator owner,
// one (batch, head, packed q-row tile), its own block: grid
// (total q-row tiles, H, B). The block finds its member by binary search
// over the table's tile-row offsets, then walks the member-local lambdas
// of its row [segment_origin(i), segment_origin(i) + row width) through
// member_map_params -- the paper's g(lambda) on the device -- in the
// reference's order. Every K/V tile it reads is in the domain: no tile
// outside the triangle (or band, or prefix) is ever loaded. Owners are
// issued in the order tri::prefill_owner names (attn_tiles.cuh): the pack's
// order, heads numbered fastest.
//
// Bound on this card. Per tile step the block does 4 * blk^2 * D flops
// over 2 * blk * D loaded K/V values: at blk = 64, D = 128 the kernel sits
// above the H100's bf16 ridge, so the bound is the tensor-core rate.
//
// bf16 runs tri_fwd's tensor-core body (tri::tc::row_tile, attn_mma.cuh)
// with the member's first tile row as row0: 2 blk threads, S = Q K^T and
// O += P V by wgmma over swizzled TMA tiles at blk 64 and 128, by
// mma.sync.m16n8k16 over cp.async tiles at blk 16 and 32, P rounded to
// bf16 for the PV product; tensor maps over the (B H S_total, D) and
// (B Hkv S_total, D) rows. Shared memory is ROW_BYTES, 81 KB at blk 64,
// D 128. Every bf16 pointer must be 16-byte aligned (the C entry returns
// cudaErrorMisalignedAddress otherwise). float32 keeps the CUDA-core body
// (tri::prefill_row_tile, attn_tiles.cuh, scalar f32 FMAs at 256 threads),
// which the reference's f32 arithmetic asks for; the fused step kernel
// runs both bodies too. The C entry dispatches on the dtype, nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

constexpr int NT_F32 = tri::PREFILL_NT;

// This block's owner: (packed q-row tile, head) over the grid (tiles,
// heads, batch), in the order tri::prefill_owner issues them.
__device__ __forceinline__ int2 block_owner() {
  return tri::prefill_owner(blockIdx.y * gridDim.x + blockIdx.x, gridDim.y);
}

template <int BLK, int D>
__global__ void __launch_bounds__(tri::tc::Shape<BLK, D>::NT)
packed_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     const int* __restrict__ tbl, int R, int H, int Hkv,
                     int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  // (7, R) table: starts | rows | n | w_b | p_b | win | pre
  const int2 th = block_owner();
  const int tile = th.x, h = th.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = tri::request_from_starts(tile, tbl + R, R);
  const int row0 = tbl[R + r];
  const int q_row = (b * H + h) * S, kv_row = (b * Hkv + hk) * S;
  const tri::tc::Src src{&tq, &tk, &tv, q_row, kv_row,
                         q + static_cast<size_t>(q_row) * D,
                         k + static_cast<size_t>(kv_row) * D,
                         v + static_cast<size_t>(kv_row) * D};
  tri::tc::row_tile<BLK, D>(src, out + static_cast<size_t>(q_row) * D,
                            lse + q_row, row0, tile - row0, tbl[2 * R + r],
                            tbl[3 * R + r], tbl[4 * R + r], tbl[5 * R + r],
                            tbl[6 * R + r], scale, smem);
}

template <int BLK, int D>
__global__ void __launch_bounds__(NT_F32)
packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ tbl,
                  int R, int H, int Hkv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* rows = tbl + R;
  const int2 th = block_owner();
  const int tile = th.x, h = th.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = tri::request_from_starts(tile, rows, R);
  const size_t head_elems = static_cast<size_t>(S) * D;
  tri::prefill_row_tile<float, BLK, D>(
      q + (static_cast<size_t>(b) * H + h) * head_elems,
      k + (static_cast<size_t>(b) * Hkv + hk) * head_elems,
      v + (static_cast<size_t>(b) * Hkv + hk) * head_elems,
      out + (static_cast<size_t>(b) * H + h) * head_elems,
      lse + (static_cast<size_t>(b) * H + h) * S, rows[r], tile - rows[r],
      tbl[2 * R + r], tbl[3 * R + r], tbl[4 * R + r], tbl[5 * R + r],
      tbl[6 * R + r], scale, reinterpret_cast<float*>(smem));
}

__global__ void member_map_probe_kernel(const int* __restrict__ local,
                                        const int* __restrict__ nwp,
                                        int* __restrict__ out_i,
                                        int* __restrict__ out_j, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  tri::member_map_params(local[e], nwp[e], nwp[count + e], nwp[2 * count + e],
                         &out_i[e], &out_j[e]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse is f32).
// The bf16 body copies 16 bytes at a time: q, k, v and out must be 16-byte
// aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int packed_fwd_launch(const void* q, const void* k, const void* v,
                                 void* out, void* lse, const void* tbl,
                                 int n_members, int B, int H, int Hkv, int S,
                                 int D, int blk, int total_tiles, float scale,
                                 int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tbl);
  const dim3 grid(total_tiles, H, B);
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
      auto kern = packed_fwd_tc_kernel<BLK, DD>;
      if (int err = tri::set_smem(kern, Sh::ROW_BYTES)) return err;
      kern<<<grid, Sh::NT, Sh::ROW_BYTES, st>>>(
          maps[0], maps[1], maps[2], static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), static_cast<float*>(lse), tb, n_members, H,
          Hkv, S, scale);
    } else {
      auto kern = packed_fwd_kernel<BLK, DD>;
      constexpr size_t bytes = tri::FwdShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<grid, NT_F32, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), tb, n_members, H, Hkv, S, scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// Evaluates member_map_params for `count` (local, n, w, p) tuples: the
// device g(lambda) the kernel above walks, exposed for tests.
extern "C" int member_map_probe(const void* local, const void* nwp,
                                void* out_i, void* out_j, int count,
                                void* stream) {
  const int threads = 256;
  const int blocks = (count + threads - 1) / threads;
  member_map_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(local), static_cast<const int*>(nwp),
      static_cast<int*>(out_i), static_cast<int*>(out_j), count);
  return static_cast<int>(cudaGetLastError());
}
