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
// and the head dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packing.cuh"

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int GC = 8;  // query heads per register chunk
constexpr int SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stream one cache tile (blk tokens of this kv head) of K and V into shared
// memory, 16 bytes per cp.async; one commit group per tile.
template <typename TC, int D>
__device__ __forceinline__ void load_tile(TC* dk, TC* dv, const TC* ks,
                                          const TC* vs, int tok0, int blk,
                                          size_t tok_stride) {
  constexpr int V = 16 / sizeof(TC);
  constexpr int PER_ROW = D / V;
  for (int c = threadIdx.x; c < blk * PER_ROW; c += NT) {
    const int row = c / PER_ROW, off = (c - row * PER_ROW) * V;
    const size_t src = static_cast<size_t>(tok0 + row) * tok_stride + off;
    cp_async16(dk + row * D + off, ks + src);
    cp_async16(dv + row * D + off, vs + src);
  }
  cp_async_commit();
}

size_t decode_smem_bytes(int stages, int g, int D, int blk, size_t tc_size) {
  return static_cast<size_t>(stages) * 2 * blk * D * tc_size +
         sizeof(float) * (static_cast<size_t>(g) * D * 2 +
                          static_cast<size_t>(g) * blk + 3 * g);
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(NT)
packed_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                     const TC* __restrict__ vc, TQ* __restrict__ out,
                     const int* __restrict__ tbl, int n_members, int B, int H,
                     int Hkv, int S_cache, int blk, float scale, int stages) {
  constexpr int DPL = (D + 31) / 32;  // head-dim elements per lane
  const int R = n_members;
  const int r = blockIdx.x, hk = blockIdx.y;
  const int slot = tbl[R + r];
  const int kv_tiles = tbl[2 * R + r];
  const int kv_len = tbl[3 * R + r];
  const int kv_first = tbl[4 * R + r];
  if (slot < 0 || slot >= B || kv_tiles <= 0 || kv_tiles == tri::DECODE_NO_EMIT ||
      kv_len <= 0)
    return;
  const int g = H / Hkv;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TC* kv = reinterpret_cast<TC*>(smem_raw);  // stages x {K, V} x blk x D
  float* sq = reinterpret_cast<float*>(kv + stages * 2 * blk * D);
  float* ss = sq + g * D;
  float* sacc = ss + g * blk;
  float* sm = sacc + g * D;
  float* sl = sm + g;
  float* sa = sl + g;

  const int cache_tiles = S_cache / blk;
  const size_t tok_stride = static_cast<size_t>(Hkv) * D;
  const TC* ks = kc + static_cast<size_t>(slot) * S_cache * tok_stride + hk * D;
  const TC* vs = vc + static_cast<size_t>(slot) * S_cache * tok_stride + hk * D;
  const int tile0 = kv_first / blk;
  load_tile<TC, D>(kv, kv + blk * D, ks, vs, min(tile0, cache_tiles - 1) * blk,
                   blk, tok_stride);

  const TQ* qs = q + (static_cast<size_t>(slot) * H + hk * g) * D;
  for (int e = threadIdx.x; e < g * D; e += NT) {
    sq[e] = tri::to_f32(qs[e]);
    sacc[e] = 0.f;
  }
  for (int gi = threadIdx.x; gi < g; gi += NT) {
    sm[gi] = tri::MASK_VALUE;
    sl[gi] = 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < kv_tiles; ++t) {
    const int cur = stages == 2 ? (t & 1) : 0;
    if (stages == 2 && t + 1 < kv_tiles) {
      TC* nk = kv + ((t + 1) & 1) * 2 * blk * D;
      load_tile<TC, D>(nk, nk + blk * D, ks, vs,
                       min(tile0 + t + 1, cache_tiles - 1) * blk, blk, tok_stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TC* sk = kv + cur * 2 * blk * D;
    const TC* sv = sk + blk * D;
    const int tile = tile0 + t;

    // scores: one warp per key, lanes over D, queries in registers
    for (int g0 = 0; g0 < g; g0 += GC) {
      float qr[GC][DPL];
#pragma unroll
      for (int j = 0; j < GC; ++j)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          qr[j][i] = (g0 + j < g && d < D) ? sq[(g0 + j) * D + d] : 0.f;
        }
      for (int cc = warp; cc < blk; cc += NW) {
        float kr[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          kr[i] = d < D ? tri::to_f32(sk[cc * D + d]) : 0.f;
        }
        const int kp = tile * blk + cc;
        const bool keep = kp >= kv_first && kp < kv_len;
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(qr[j][i], kr[i], part);
          part = tri::warp_sum(part);
          if (lane == j && g0 + j < g)
            ss[(g0 + j) * blk + cc] = keep ? part * scale : tri::MASK_VALUE;
        }
      }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NW) {
      float mx = -INFINITY;
      for (int cc = lane; cc < blk; cc += 32) mx = fmaxf(mx, ss[gi * blk + cc]);
      const float m_prev = sm[gi];
      const float m_new = fmaxf(m_prev, tri::warp_max(mx));
      float psum = 0.f;
      for (int cc = lane; cc < blk; cc += 32) {
        const float p = expf(ss[gi * blk + cc] - m_new);
        ss[gi * blk + cc] = p;
        psum += p;
      }
      psum = tri::warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[gi] = alpha;
        sl[gi] = sl[gi] * alpha + psum;
        sm[gi] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < g * D; e += NT) {
      const int gi = e / D, d = e % D;
      float o = sacc[e] * sa[gi];
      for (int cc = 0; cc < blk; ++cc)
        o = fmaf(ss[gi * blk + cc], tri::to_f32(sv[cc * D + d]), o);
      sacc[e] = o;
    }
    __syncthreads();
    if (stages == 1 && t + 1 < kv_tiles)
      load_tile<TC, D>(kv, kv + blk * D, ks, vs,
                       min(tile0 + t + 1, cache_tiles - 1) * blk, blk, tok_stride);
  }

  TQ* os = out + (static_cast<size_t>(slot) * H + hk * g) * D;
  for (int e = threadIdx.x; e < g * D; e += NT)
    os[e] = tri::from_f32<TQ>(sacc[e] / sl[e / D]);
}

template <typename TQ, typename TC, int D>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  const void* tbl, int n_members, int B, int H, int Hkv,
                  int S_cache, int blk, float scale, cudaStream_t stream) {
  auto kern = packed_decode_kernel<TQ, TC, D>;
  const int g = H / Hkv;
  int stages = 2;
  size_t bytes = decode_smem_bytes(stages, g, D, blk, sizeof(TC));
  if (bytes > SMEM_LIMIT) {
    stages = 1;
    bytes = decode_smem_bytes(stages, g, D, blk, sizeof(TC));
  }
  if (bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
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
