// The paper's bounding-box baseline of the triangular attention forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:fwd_bb
// (_bb_fwd_kernel): flash attention of one request over the n x n tile
// grid with the paper's block guard j <= i (ltm, or band through the token
// mask; the reference's guard drops the above-diagonal tiles a
// prefix-causal row needs, so the wrapper refuses prefix schedules). Out in
// q's dtype, lse (B, H, S) f32, GQA head h reading kv head h / (H / Hkv).
//
// Design. A q-row block that walked j = 0..n-1 and skipped j > i as loop
// steps would pay nothing like a discarded block, and BB would look as
// cheap as the triangle. So, as in the paper, every tile of the n x n grid
// is its own block: grid (n * n, H, B), blockIdx.x = i * n + j. A block
// with j > i returns before any load (the discarded block). A live block
// computes its tile's softmax partial (m, l, acc in f32, the token mask
// applied, so band windows are right) with the tile body tri_fwd.cu runs
// (below), and writes it to a scratch slot indexed by lambda =
// ltm_inverse(i, j) = tri(i) + j: B * H * tri(n) * (BLK * D + 2 * BLK) f32.
// It then counts itself in its row's arrival counter (atomicAdd after
// __threadfence; the partials themselves use no atomics). The row's last
// block to arrive merges the i + 1 partials in ascending j, as the
// reference's grid order accumulates them, and writes out and lse. Which
// block merges varies between runs; what it computes does not, so two runs
// are bitwise equal. One launch, as the reference's: tiles_launched =
// n^2 B H, tiles_domain = tri(n) B H.
//
// Bound on this card. The live tiles do fwd's arithmetic (4 BLK^2 D flops
// a tile: 0.139 ms at the bf16 tensor-core rate at B 1, H 32, S 4096,
// D 128, BLK 64), and the partials make a round trip through device memory
// that tri_fwd does not pay: B H tri(n) (BLK D + 2 BLK) f32, 2.215 GB at
// that shape, written once and read once, a floor of 1.32 ms at 3.35 TB/s.
//
// bf16 runs the tensor-core body of tri_fwd (attn_mma.cuh) on its one tile:
// tri::tc::bb_partial loads Q, K and V once (swizzled TMA tiles at BLK 64
// and 128, cp.async at 16 and 32; no ring: 3 BLK D 2 bytes of shared
// memory and 1 KB of alignment, 49 KB at BLK 64, D 128), runs S = Q K^T and
// O += P V by wgmma (BLK 64, 128) or mma.sync (BLK 16, 32) with the same
// mask and softmax code, and writes the partial with 16-byte stores;
// tri::tc::bb_merge reads the row's partials with 16-byte __ldcg loads, so
// both kernels do the same tile work and I_attn = t_fwd_bb / t_tri_fwd
// measures the space of computation, not two tile bodies. float32 keeps the
// CUDA-core body (prefill_begin + prefill_key_tile, attn_tiles.cuh) with
// tri_fwd's f32 path, for the reason tri_fwd.cu gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attn_tiles.cuh"

namespace {

template <int BLK, int D>
__global__ void __launch_bounds__(tri::tc::Shape<BLK, D>::NT)
fwd_bb_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ part, int* __restrict__ arrivals, int H,
                 int Hkv, int S, int n, int win, float scale) {
  using Sh = tri::tc::Shape<BLK, D>;
  constexpr int PART = BLK * D + 2 * BLK;  // O, then m, then l
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = tri::tc::align_1k(smem_raw);
  int* is_last = reinterpret_cast<int*>(smem + 3 * Sh::TILE);

  const int i = static_cast<int>(blockIdx.x) / n;
  const int j = static_cast<int>(blockIdx.x) - i * n;
  if (j > i) return;  // the paper's BB guard, by block coordinates

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  const size_t cell = (static_cast<size_t>(b) * H + h) *
                      static_cast<size_t>(tri::tri_n(n));
  float* row_part = part + (cell + static_cast<size_t>(tri::tri_n(i))) * PART;
  const int q_row = (b * H + h) * S, kv_row = (b * Hkv + hk) * S;
  const tri::tc::Src src{&tq, &tk, &tv, q_row, kv_row,
                         q + static_cast<size_t>(q_row) * D,
                         k + static_cast<size_t>(kv_row) * D,
                         v + static_cast<size_t>(kv_row) * D};
  tri::tc::bb_partial<BLK, D>(src, i, j, win > 0 ? win : (1 << 30), scale,
                              smem, row_part + static_cast<size_t>(j) * PART);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *is_last = atomicAdd(arrivals + (static_cast<size_t>(b) * H + h) * n + i,
                         1) == i;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  tri::tc::bb_merge<BLK, D>(row_part, i + 1, smem,
                            out + (static_cast<size_t>(b) * H + h) * plane,
                            lse + (static_cast<size_t>(b) * H + h) * S,
                            i * BLK);
}

constexpr int NT = tri::PREFILL_NT;

template <int BLK, int D>
__global__ void __launch_bounds__(NT)
fwd_bb_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, float* __restrict__ part,
                  int* __restrict__ arrivals, int H, int Hkv, int S, int n,
                  int win, float scale) {
  using T = float;
  using Sh = tri::FwdShape<BLK, D>;
  constexpr int ACC = Sh::ACC;
  constexpr int PART = BLK * D + 2 * BLK;  // acc, then m, then l
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int is_last;
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* ss = smem + BLK * Sh::DP + Sh::KC * Sh::DP + Sh::KC * D;
  float* sm = ss + BLK * Sh::SP;
  float* sl = sm + BLK;
  float* sa = sl + BLK;

  const int i = static_cast<int>(blockIdx.x) / n;
  const int j = static_cast<int>(blockIdx.x) - i * n;
  if (j > i) return;  // the paper's BB guard, by block coordinates

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  const T* qh = q + (static_cast<size_t>(b) * H + h) * plane;
  const T* kh = k + (static_cast<size_t>(b) * Hkv + hk) * plane;
  const T* vh = v + (static_cast<size_t>(b) * Hkv + hk) * plane;

  float acc[ACC];
  tri::prefill_begin<T, BLK, D>(qh, i * BLK, smem, acc);
  tri::prefill_key_tile<T, BLK, D>(kh, vh, j * BLK, i, j,
                                   win > 0 ? win : (1 << 30), 0, scale, smem,
                                   acc);

  const size_t cell = (static_cast<size_t>(b) * H + h) * static_cast<size_t>(tri::tri_n(n));
  const size_t row_lam = cell + static_cast<size_t>(tri::tri_n(i));
  float* mine = part + (row_lam + j) * PART;
#pragma unroll
  for (int a = 0; a < ACC; ++a) mine[threadIdx.x + a * NT] = acc[a];
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    mine[BLK * D + rr] = sm[rr];
    mine[BLK * D + BLK + rr] = sl[rr];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* row = arrivals + (static_cast<size_t>(b) * H + h) * n + i;
    is_last = atomicAdd(row, 1) == i;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // Merge the row's partials j' = 0..i in ascending order: running (M, L)
  // per row in sm / sl, the weights of the running state and of the
  // partial in sa / ss, the running acc in registers. Partials are read
  // through L2 (__ldcg): other blocks wrote them in this launch.
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    sm[rr] = tri::MASK_VALUE;
    sl[rr] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();
  for (int jj = 0; jj <= i; ++jj) {
    const float* p = part + (row_lam + jj) * PART;
    for (int rr = threadIdx.x; rr < BLK; rr += NT) {
      const float m_j = __ldcg(p + BLK * D + rr);
      const float l_j = __ldcg(p + BLK * D + BLK + rr);
      const float m_new = fmaxf(sm[rr], m_j);
      const float w_run = expf(sm[rr] - m_new), w_j = expf(m_j - m_new);
      sl[rr] = sl[rr] * w_run + l_j * w_j;
      sm[rr] = m_new;
      sa[rr] = w_run;
      ss[rr] = w_j;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = threadIdx.x + a * NT;
      const int rr = e / D;
      acc[a] = acc[a] * sa[rr] + __ldcg(p + e) * ss[rr];
    }
    __syncthreads();
  }
  T* oh = out + (static_cast<size_t>(b) * H + h) * plane;
  float* lh = lse + (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT;
    const int rr = e / D, d = e % D;
    oh[static_cast<size_t>(i * BLK + rr) * D + d] = tri::from_f32<T>(acc[a] / sl[rr]);
  }
  for (int rr = threadIdx.x; rr < BLK; rr += NT) lh[i * BLK + rr] = sm[rr] + logf(sl[rr]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse, part
// f32). part: B * H * tri(n) * (blk * D + 2 * blk) f32 scratch; arrivals:
// B * H * n int32, zero at launch. win: window in tokens (0 = none). The
// bf16 body moves 16 bytes at a time: q, k, v, out and part must be
// 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int fwd_bb_launch(const void* q, const void* k, const void* v,
                             void* out, void* lse, void* part, void* arrivals,
                             int B, int H, int Hkv, int S, int D, int blk,
                             int n, int win, float scale, int dtype,
                             void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
           reinterpret_cast<uintptr_t>(part)) &
          15)
        return static_cast<int>(cudaErrorMisalignedAddress);
      using Sh = tri::tc::Shape<BLK, DD>;
      CUtensorMap maps[3] = {};
      if (int err = tri::tc::make_tmaps<BLK, DD>(maps, q, k, v, B, H, Hkv, S))
        return err;
      auto kern = fwd_bb_tc_kernel<BLK, DD>;
      if (int err = tri::set_smem(kern, Sh::BB_BYTES)) return err;
      kern<<<dim3(n * n, H, B), Sh::NT, Sh::BB_BYTES, st>>>(
          maps[0], maps[1], maps[2], static_cast<const T*>(q),
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out),
          static_cast<float*>(lse), static_cast<float*>(part),
          static_cast<int*>(arrivals), H, Hkv, S, n, win, scale);
    } else {
      auto kern = fwd_bb_f32_kernel<BLK, DD>;
      constexpr size_t bytes = tri::FwdShape<BLK, DD>::BYTES;
      if (int err = tri::set_smem(kern, bytes)) return err;
      kern<<<dim3(n * n, H, B), NT, bytes, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), static_cast<float*>(part),
          static_cast<int*>(arrivals), H, Hkv, S, n, win, scale);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
