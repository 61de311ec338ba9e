// Tile bodies shared by the attention kernels (packed_fwd.cu,
// packed_decode.cu, fused_step.cu).
//
// prefill_row_tile is one prefill accumulator owner: one q-row tile of one
// packed member for one query head, walking the member-local lambdas of its
// row through member_map_params with an f32 online softmax. decode_member
// is one decode accumulator owner: one live slot's single query for all g
// query heads of one kv head, streaming the slot's cache tiles with
// cp.async. Each kernel reads its own member table and hands these bodies
// plain integers, so the (7, R), (5, R) and (8, R) row layouts stay with
// their kernels, and a fused launch runs exactly the code of the two split
// kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packing.cuh"

namespace tri {

// Threads of a prefill block (packed_fwd and the fused kernel).
constexpr int PREFILL_NT = 256;
constexpr int SMEM_LIMIT = 227 * 1024;

template <int BLK, int D>
struct FwdShape {
  static constexpr int KC = BLK < 32 ? BLK : 32;
  static constexpr int DP = D + 1;
  static constexpr int SP = KC + 1;
  static constexpr int ACC = BLK * D / PREFILL_NT;
  static constexpr int FLOATS = BLK * DP + KC * DP + KC * D + BLK * SP + 3 * BLK;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// Shared memory: the Q tile (BLK x D, f32, padded rows), one key chunk of
// KC = min(BLK, 32) keys of K and V, the chunk's scores and the per-row
// softmax state. qh/kh/vh/oh point at this head's (S, D) planes, lh at its
// (S,) log-sum-exp row or is null. The row's tiles are the member's tile
// rows from row0; i is the row within the member.
template <typename T, int BLK, int D>
__device__ __forceinline__ void prefill_row_tile(
    const T* __restrict__ qh, const T* __restrict__ kh,
    const T* __restrict__ vh, T* __restrict__ oh, float* __restrict__ lh,
    int row0, int i, int n_r, int w_r, int p_r, int win, int pre, float scale,
    float* smem) {
  using Sh = FwdShape<BLK, D>;
  constexpr int NT = PREFILL_NT;
  constexpr int KC = Sh::KC, DP = Sh::DP, SP = Sh::SP, ACC = Sh::ACC;
  static_assert(BLK * D % NT == 0, "tile must split evenly over threads");
  float* sq = smem;
  float* sk = sq + BLK * DP;
  float* sv = sk + KC * DP;
  float* ss = sv + KC * D;
  float* sm = ss + BLK * SP;
  float* sl = sm + BLK;
  float* sa = sl + BLK;

  const int win_eff = win > 0 ? win : (1 << 30);
  const int first = first_col_params(i, w_r);
  const int last = last_col_params(i, p_r);
  const int lam0 = segment_origin_params(i, w_r, p_r);
  const int q0 = (row0 + i) * BLK;

  for (int e = threadIdx.x; e < BLK * D; e += NT) {
    const int rr = e / D, d = e % D;
    sq[rr * DP + d] = to_f32(qh[static_cast<size_t>(q0 + rr) * D + d]);
  }
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    sm[rr] = MASK_VALUE;
    sl[rr] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = 0; s <= last - first; ++s) {
    int ii, j;
    member_map_params(lam0 + s, n_r, w_r, p_r, &ii, &j);
    const int k0 = (row0 + j) * BLK;
    for (int c0 = 0; c0 < BLK; c0 += KC) {
      for (int e = threadIdx.x; e < KC * D; e += NT) {
        const int cc = e / D, d = e % D;
        const size_t off = static_cast<size_t>(k0 + c0 + cc) * D + d;
        sk[cc * DP + d] = to_f32(kh[off]);
        sv[cc * D + d] = to_f32(vh[off]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < BLK * KC; e += NT) {
        const int rr = e / KC, cc = e % KC;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(sq[rr * DP + d], sk[cc * DP + d], dot);
        const int qp = ii * BLK + rr, kp = j * BLK + c0 + cc;
        const bool keep = (kp <= qp && qp - kp < win_eff) || kp < pre;
        ss[rr * SP + cc] = keep ? dot * scale : MASK_VALUE;
      }
      __syncthreads();
      for (int rr = warp; rr < BLK; rr += NT / 32) {
        const float sval = lane < KC ? ss[rr * SP + lane] : -INFINITY;
        const float m_prev = sm[rr];
        const float m_new = fmaxf(m_prev, warp_max(sval));
        const float p = lane < KC ? expf(sval - m_new) : 0.f;
        const float psum = warp_sum(p);
        if (lane < KC) ss[rr * SP + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sa[rr] = alpha;
          sl[rr] = sl[rr] * alpha + psum;
          sm[rr] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = threadIdx.x + a * NT;
        const int rr = e / D, d = e % D;
        float o = acc[a] * sa[rr];
#pragma unroll 8
        for (int cc = 0; cc < KC; ++cc) o = fmaf(ss[rr * SP + cc], sv[cc * D + d], o);
        acc[a] = o;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT;
    const int rr = e / D, d = e % D;
    oh[static_cast<size_t>(q0 + rr) * D + d] = from_f32<T>(acc[a] / sl[rr]);
  }
  if (lh != nullptr)
    for (int rr = threadIdx.x; rr < BLK; rr += NT) lh[q0 + rr] = sm[rr] + logf(sl[rr]);
}

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
template <typename TC, int D, int NT>
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

// Dynamic shared memory of decode_member: `stages` tiles of K and V, then
// the g queries, scores, accumulators and softmax state in f32.
inline size_t decode_smem_bytes(int stages, int g, int D, int blk,
                                size_t tc_size) {
  return static_cast<size_t>(stages) * 2 * blk * D * tc_size +
         sizeof(float) * (static_cast<size_t>(g) * D * 2 +
                          static_cast<size_t>(g) * blk + 3 * g);
}

// Two stages (double buffering) where they fit, else one.
inline int decode_stages(int g, int D, int blk, size_t tc_size) {
  return decode_smem_bytes(2, g, D, blk, tc_size) > SMEM_LIMIT ? 1 : 2;
}

constexpr int DECODE_GC = 8;  // query heads per register chunk

// One decode member: the block attends slot `slot`'s query heads of kv head
// hk over cache tokens [kv_first, kv_len), walking kv_tiles tiles from
// kv_first / blk in the reference's order. Columns that own no tiles (the
// empty columns with slot 0, the pad member with slot == B) return before
// touching memory, so they never write a live slot's output row. The
// arithmetic of every output element is independent of NT.
template <typename TQ, typename TC, int D, int NT>
__device__ __forceinline__ void decode_member(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, TQ* __restrict__ out, int slot, int kv_tiles,
    int kv_len, int kv_first, int hk, int B, int H, int Hkv, int S_cache,
    int blk, float scale, int stages, unsigned char* smem_raw) {
  constexpr int NW = NT / 32;
  constexpr int GC = DECODE_GC;
  constexpr int DPL = (D + 31) / 32;  // head-dim elements per lane
  if (slot < 0 || slot >= B || kv_tiles <= 0 || kv_tiles == DECODE_NO_EMIT ||
      kv_len <= 0)
    return;
  const int g = H / Hkv;
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
  load_tile<TC, D, NT>(kv, kv + blk * D, ks, vs,
                       min(tile0, cache_tiles - 1) * blk, blk, tok_stride);

  const TQ* qs = q + (static_cast<size_t>(slot) * H + hk * g) * D;
  for (int e = threadIdx.x; e < g * D; e += NT) {
    sq[e] = to_f32(qs[e]);
    sacc[e] = 0.f;
  }
  for (int gi = threadIdx.x; gi < g; gi += NT) {
    sm[gi] = MASK_VALUE;
    sl[gi] = 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < kv_tiles; ++t) {
    const int cur = stages == 2 ? (t & 1) : 0;
    if (stages == 2 && t + 1 < kv_tiles) {
      TC* nk = kv + ((t + 1) & 1) * 2 * blk * D;
      load_tile<TC, D, NT>(nk, nk + blk * D, ks, vs,
                           min(tile0 + t + 1, cache_tiles - 1) * blk, blk,
                           tok_stride);
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
          kr[i] = d < D ? to_f32(sk[cc * D + d]) : 0.f;
        }
        const int kp = tile * blk + cc;
        const bool keep = kp >= kv_first && kp < kv_len;
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(qr[j][i], kr[i], part);
          part = warp_sum(part);
          if (lane == j && g0 + j < g)
            ss[(g0 + j) * blk + cc] = keep ? part * scale : MASK_VALUE;
        }
      }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += NW) {
      float mx = -INFINITY;
      for (int cc = lane; cc < blk; cc += 32) mx = fmaxf(mx, ss[gi * blk + cc]);
      const float m_prev = sm[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
      for (int cc = lane; cc < blk; cc += 32) {
        const float p = expf(ss[gi * blk + cc] - m_new);
        ss[gi * blk + cc] = p;
        psum += p;
      }
      psum = warp_sum(psum);
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
        o = fmaf(ss[gi * blk + cc], to_f32(sv[cc * D + d]), o);
      sacc[e] = o;
    }
    __syncthreads();
    if (stages == 1 && t + 1 < kv_tiles)
      load_tile<TC, D, NT>(kv, kv + blk * D, ks, vs,
                           min(tile0 + t + 1, cache_tiles - 1) * blk, blk,
                           tok_stride);
  }

  TQ* os = out + (static_cast<size_t>(slot) * H + hk * g) * D;
  for (int e = threadIdx.x; e < g * D; e += NT)
    os[e] = from_f32<TQ>(sacc[e] / sl[e / D]);
}

}  // namespace tri
