// Tile bodies shared by the attention kernels (packed_fwd.cu,
// fused_step.cu, tri_fwd.cu, tri_bwd.cu, packed_bwd.cu, fwd_bb.cu; the
// decode body of packed_decode.cu and fused_step.cu is attn_decode.cuh).
//
// prefill_row_tile is one prefill accumulator owner: one q-row tile of one
// packed member (or of the one request of tri_fwd) for one query head,
// walking the member-local lambdas of its row through member_map_params
// with an f32 online softmax, one prefill_key_tile a lambda (fwd_bb.cu runs
// that key-tile step alone, one block per tile of the n x n grid).
// dq_row_tile and dkv_col_tile are the backward's owners: a q-row tile's
// dq, and a key-column tile's dk/dv over every query head of its kv head
// (tri_bwd.cu with row0 = 0, packed_bwd.cu with a member's first tile
// row). Each kernel reads its own member table and hands these bodies
// plain integers, so the (7, R) and (8, R) row layouts stay with their
// kernels, and a fused launch runs exactly the code of the two split
// kernels.
//
// These bodies do their products on the f32 CUDA cores, scalar FMAs from
// f32 copies in shared memory, though every prefill and backward kernel
// here is bound by the bf16 tensor-core rate (4 blk^2 D flops a tile over
// 2 blk D loaded values). tri_fwd.cu, fwd_bb.cu, packed_fwd.cu and the
// fused step's prefill half (replacing the reference's fwd, fwd_bb,
// packed_fwd and fused_step_fwd, repro/kernels/tri_attn/kernel.py) run
// them for f32 inputs only, and tri_bwd.cu and packed_bwd.cu (bwd,
// packed_bwd) for f32 inputs and for bf16 at blk 16 and 32, which no bf16
// main path reaches: the reference computes in f32 and TF32 would compute
// something else. Their bf16 paths are the tensor-core bodies of
// attn_mma.cuh (included at the end of this file: wgmma or mma.sync,
// S / O / P in registers, bf16 tiles in shared memory) and
// attn_mma_bwd.cuh (wgmma on 64 x 64 sub-tiles). The decode body
// (attn_decode.cuh) is bound by HBM bandwidth and keeps f32 FMAs on the
// CUDA cores in every dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "packing.cuh"

namespace tri {

// Threads of a CUDA-core prefill block (prefill_row_tile: the f32 paths of
// packed_fwd, the fused kernel and tri_fwd).
constexpr int PREFILL_NT = 256;

// The owner (packed q-row tile, head) at position flat of a prefill launch
// over tiles x heads: packed_fwd and the fused step's prefill half issue
// their owners in the pack's order, heads numbered fastest (on the H100 it
// beat the last rows first at the packed training and serving shapes;
// PERF.md section 6).
__device__ __forceinline__ int2 prefill_owner(int flat, int heads) {
  return make_int2(flat / heads, flat % heads);
}

template <int BLK, int D>
struct FwdShape {
  static constexpr int KC = BLK < 32 ? BLK : 32;
  static constexpr int DP = D + 1;
  static constexpr int SP = KC + 1;
  static constexpr int ACC = BLK * D / PREFILL_NT;
  static constexpr int FLOATS = BLK * DP + KC * DP + KC * D + BLK * SP + 3 * BLK;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert(BYTES <= SMEM_LIMIT, "a prefill row tile fits a block");
};

// One key tile of a prefill q-row tile: keys [k0, k0 + BLK) of the (S, D)
// planes kh / vh against the Q tile already in shared memory, in chunks of
// KC = min(BLK, 32) keys, with the f32 online-softmax update of the rows'
// state (sm, sl) and of the thread's acc. (ii, j) are the tile's row and
// column in the member's own token positions, which the mask reads.
// Shared memory: the Q tile (BLK x D, f32, padded rows), one key chunk of
// K and V, the chunk's scores and the per-row softmax state.
template <typename T, int BLK, int D>
__device__ __forceinline__ void prefill_key_tile(
    const T* __restrict__ kh, const T* __restrict__ vh, int k0, int ii,
    int j, int win_eff, int pre, float scale, float* smem,
    float (&acc)[FwdShape<BLK, D>::ACC]) {
  using Sh = FwdShape<BLK, D>;
  constexpr int NT = PREFILL_NT;
  constexpr int KC = Sh::KC, DP = Sh::DP, SP = Sh::SP, ACC = Sh::ACC;
  const float* sq = smem;
  float* sk = smem + BLK * DP;
  float* sv = sk + KC * DP;
  float* ss = sv + KC * D;
  float* sm = ss + BLK * SP;
  float* sl = sm + BLK;
  float* sa = sl + BLK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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

// Loads the Q tile of rows [q0, q0 + BLK) of the (S, D) plane qh into
// shared memory (f32, padded rows) and resets the rows' softmax state and
// the thread's acc, ready for prefill_key_tile.
template <typename T, int BLK, int D>
__device__ __forceinline__ void prefill_begin(
    const T* __restrict__ qh, int q0, float* smem,
    float (&acc)[FwdShape<BLK, D>::ACC]) {
  using Sh = FwdShape<BLK, D>;
  constexpr int NT = PREFILL_NT;
  constexpr int DP = Sh::DP;
  float* sq = smem;
  float* sm = sq + BLK * DP + Sh::KC * DP + Sh::KC * D + BLK * Sh::SP;
  float* sl = sm + BLK;
  for (int e = threadIdx.x; e < BLK * D; e += NT) {
    const int rr = e / D, d = e % D;
    sq[rr * DP + d] = to_f32(qh[static_cast<size_t>(q0 + rr) * D + d]);
  }
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    sm[rr] = MASK_VALUE;
    sl[rr] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < Sh::ACC; ++a) acc[a] = 0.f;
  __syncthreads();
}

// One prefill accumulator owner: q-row tile i of a member whose tiles
// start at tile row row0, walking the member-local lambdas of its row
// through member_map_params (prefill_key_tile for each), then writing
// out = acc / l in T and, when lh is not null, lse = m + log(l). qh/kh/
// vh/oh point at this head's (S, D) planes, lh at its (S,) log-sum-exp
// row.
template <typename T, int BLK, int D>
__device__ __forceinline__ void prefill_row_tile(
    const T* __restrict__ qh, const T* __restrict__ kh,
    const T* __restrict__ vh, T* __restrict__ oh, float* __restrict__ lh,
    int row0, int i, int n_r, int w_r, int p_r, int win, int pre, float scale,
    float* smem) {
  using Sh = FwdShape<BLK, D>;
  constexpr int NT = PREFILL_NT;
  constexpr int ACC = Sh::ACC;
  static_assert(BLK * D % NT == 0, "tile must split evenly over threads");
  const float* sm = smem + BLK * Sh::DP + Sh::KC * Sh::DP + Sh::KC * D + BLK * Sh::SP;
  const float* sl = sm + BLK;

  const int win_eff = win > 0 ? win : (1 << 30);
  const int first = first_col_params(i, w_r);
  const int last = last_col_params(i, p_r);
  const int lam0 = segment_origin_params(i, w_r, p_r);
  const int q0 = (row0 + i) * BLK;

  float acc[ACC];
  prefill_begin<T, BLK, D>(qh, q0, smem, acc);
  for (int s = 0; s <= last - first; ++s) {
    int ii, j;
    member_map_params(lam0 + s, n_r, w_r, p_r, &ii, &j);
    prefill_key_tile<T, BLK, D>(kh, vh, (row0 + j) * BLK, ii, j, win_eff,
                                pre, scale, smem, acc);
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

// ---------------------------------------------------------------------------
// Backward tile bodies
// ---------------------------------------------------------------------------

// `rows` rows of a (S, D) plane from row r0, as f32 with padded rows.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const T* __restrict__ src,
                                              int r0, int rows) {
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int rr = e / D, d = e % D;
    dst[rr * (D + 1) + d] = to_f32(src[static_cast<size_t>(r0 + rr) * D + d]);
  }
}

// One (query, key) pair of the backward, as the reference's _dq_kernel /
// _dkv_kernel compute it: s = q.k * scale (MASK_VALUE where masked),
// p = exp(s - lse), ds = p * (do.v - delta) * scale.
template <int D>
__device__ __forceinline__ void bwd_pair(const float* q, const float* k,
                                         const float* dout, const float* v,
                                         bool keep, float scale, float lse,
                                         float delta, float* p, float* ds) {
  float s = 0.f, dp = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    s = fmaf(q[d], k[d], s);
    dp = fmaf(dout[d], v[d], dp);
  }
  const float pv = expf((keep ? s * scale : MASK_VALUE) - lse);
  *p = pv;
  *ds = pv * (dp - delta) * scale;
}

template <int BLK, int D>
struct DqShape {
  // Q, dO, one key chunk of K and V (padded rows), the chunk's dS, lse and
  // delta, in floats, at a key chunk of kc
  static constexpr size_t floats(int kc) {
    return 2 * static_cast<size_t>(BLK) * (D + 1) + 2 * kc * (D + 1) +
           BLK * (kc + 1) + 2 * BLK;
  }
  // keys per chunk: 32, or 16 where 32 does not fit (BLK 128 at D 192:
  // 264,960 bytes; 16 takes 232,064). The keys of a row tile still reach
  // each accumulator in ascending order, so the chunk moves no bit.
  static constexpr int KC = BLK < 32 ? BLK
                            : (4 * floats(32) <= SMEM_LIMIT ? 32 : 16);
  static constexpr int DP = D + 1;
  static constexpr int SP = KC + 1;
  static constexpr int ACC = BLK * D / PREFILL_NT;
  static constexpr size_t BYTES = sizeof(float) * floats(KC);
  static_assert(BYTES <= SMEM_LIMIT, "a dq row tile fits a block");
};

// dq of q-row tile i: the block holds Q_i, dO_i, lse_i and delta_i and
// walks j over [first_col(i), last_col(i)] in the reference's order, keys
// in chunks of KC: dS for the chunk into shared memory, then
// dQ += dS K_chunk into f32 registers (ACC a thread). qh/kh/vh/doh/dqh
// point at this head's (S, D) planes, lh/dh at its (S,) lse and delta.
template <typename T, int BLK, int D>
__device__ __forceinline__ void dq_row_tile(
    const T* __restrict__ qh, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ doh,
    const float* __restrict__ lh, const float* __restrict__ dh,
    T* __restrict__ dqh, int row0, int i, int w_r, int p_r, int win, int pre,
    float scale, float* smem) {
  using Sh = DqShape<BLK, D>;
  constexpr int NT = PREFILL_NT;
  constexpr int KC = Sh::KC, DP = Sh::DP, SP = Sh::SP, ACC = Sh::ACC;
  static_assert(BLK * D % NT == 0, "tile must split evenly over threads");
  float* sq = smem;
  float* sdo = sq + BLK * DP;
  float* sk = sdo + BLK * DP;
  float* sv = sk + KC * DP;
  float* ss = sv + KC * DP;
  float* sl = ss + BLK * SP;
  float* sd = sl + BLK;

  const int win_eff = win > 0 ? win : (1 << 30);
  const int q0 = (row0 + i) * BLK;
  load_rows_f32<T, D, NT>(sq, qh, q0, BLK);
  load_rows_f32<T, D, NT>(sdo, doh, q0, BLK);
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    sl[rr] = lh[q0 + rr];
    sd[rr] = dh[q0 + rr];
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  const int last = last_col_params(i, p_r);
  for (int j = first_col_params(i, w_r); j <= last; ++j) {
    const int k0 = (row0 + j) * BLK;
    for (int c0 = 0; c0 < BLK; c0 += KC) {
      __syncthreads();  // the previous chunk's readers are done
      load_rows_f32<T, D, NT>(sk, kh, k0 + c0, KC);
      load_rows_f32<T, D, NT>(sv, vh, k0 + c0, KC);
      __syncthreads();
      for (int e = threadIdx.x; e < BLK * KC; e += NT) {
        const int rr = e / KC, cc = e % KC;
        const int qp = i * BLK + rr, kp = j * BLK + c0 + cc;
        const bool keep = (kp <= qp && qp - kp < win_eff) || kp < pre;
        float p, ds;
        bwd_pair<D>(sq + rr * DP, sk + cc * DP, sdo + rr * DP, sv + cc * DP,
                    keep, scale, sl[rr], sd[rr], &p, &ds);
        ss[rr * SP + cc] = ds;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = threadIdx.x + a * NT;
        const int rr = e / D, d = e % D;
        float o = acc[a];
#pragma unroll 8
        for (int cc = 0; cc < KC; ++cc) o = fmaf(ss[rr * SP + cc], sk[cc * DP + d], o);
        acc[a] = o;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT;
    const int rr = e / D, d = e % D;
    dqh[static_cast<size_t>(q0 + rr) * D + d] = from_f32<T>(acc[a]);
  }
}

template <int BLK, int D>
struct DkvShape {
  static constexpr int KC = BLK < 32 ? BLK : 32;  // keys per accumulator chunk
  static constexpr int QC = KC;                    // query rows per step
  static constexpr int DP = D + 1;
  static constexpr int SP = KC + 1;
  static constexpr int ACC = KC * D / PREFILL_NT;
  static constexpr int FLOATS = 2 * KC * DP + 2 * QC * DP + 2 * QC * SP + 2 * QC;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert(BYTES <= SMEM_LIMIT, "a dk/dv key chunk fits a block");
};

// dk/dv of key-column tile j for kv head hk: the block owns the tile and
// sums over the g query heads of its group directly, so no per-q-head
// partial is written. It takes the tile's keys in chunks of KC; for each
// chunk it holds K and V in shared memory and dK, dV in f32 registers,
// and walks every query head gi, then rows i over
// [cm_first_row(j), cm_last_row(j)], then that row tile's queries in
// chunks of QC: P and dS for the QC x KC pairs into shared memory, then
// dV += P^T dO and dK += dS^T Q. qg/dog point at the group's first query
// head's (S, D) plane (heads are consecutive planes), lg/dg at its (S,)
// lse and delta rows; kh/vh/dkh/dvh at the kv head's planes.
template <typename T, int BLK, int D>
__device__ __forceinline__ void dkv_col_tile(
    const T* __restrict__ qg, const T* __restrict__ kh,
    const T* __restrict__ vh, const T* __restrict__ dog,
    const float* __restrict__ lg, const float* __restrict__ dg,
    T* __restrict__ dkh, T* __restrict__ dvh, int g, int S, int row0, int j,
    int n_r, int w_r, int p_r, int win, int pre, float scale, float* smem) {
  using Sh = DkvShape<BLK, D>;
  constexpr int NT = PREFILL_NT;
  constexpr int KC = Sh::KC, QC = Sh::QC, DP = Sh::DP, SP = Sh::SP;
  constexpr int ACC = Sh::ACC;
  static_assert(KC * D % NT == 0, "chunk must split evenly over threads");
  float* sk = smem;
  float* sv = sk + KC * DP;
  float* sq = sv + KC * DP;
  float* sdo = sq + QC * DP;
  float* sp = sdo + QC * DP;
  float* sds = sp + QC * SP;
  float* sl = sds + QC * SP;
  float* sd = sl + QC;

  const int win_eff = win > 0 ? win : (1 << 30);
  const int first = cm_first_row_params(j, p_r);
  const int last = cm_last_row_params(j, n_r, w_r);
  const size_t plane = static_cast<size_t>(S) * D;
  for (int c0 = 0; c0 < BLK; c0 += KC) {
    const int kr0 = (row0 + j) * BLK + c0;
    __syncthreads();  // the previous chunk's readers are done
    load_rows_f32<T, D, NT>(sk, kh, kr0, KC);
    load_rows_f32<T, D, NT>(sv, vh, kr0, KC);
    float dk[ACC], dv[ACC];
#pragma unroll
    for (int a = 0; a < ACC; ++a) dk[a] = dv[a] = 0.f;
    for (int gi = 0; gi < g; ++gi) {
      const T* qh = qg + gi * plane;
      const T* doh = dog + gi * plane;
      const float* lh = lg + static_cast<size_t>(gi) * S;
      const float* dh = dg + static_cast<size_t>(gi) * S;
      for (int i = first; i <= last; ++i) {
        for (int r0 = 0; r0 < BLK; r0 += QC) {
          const int qr0 = (row0 + i) * BLK + r0;
          __syncthreads();
          load_rows_f32<T, D, NT>(sq, qh, qr0, QC);
          load_rows_f32<T, D, NT>(sdo, doh, qr0, QC);
          for (int rr = threadIdx.x; rr < QC; rr += NT) {
            sl[rr] = lh[qr0 + rr];
            sd[rr] = dh[qr0 + rr];
          }
          __syncthreads();
          for (int e = threadIdx.x; e < QC * KC; e += NT) {
            const int rr = e / KC, cc = e % KC;
            const int qp = i * BLK + r0 + rr, kp = j * BLK + c0 + cc;
            const bool keep = (kp <= qp && qp - kp < win_eff) || kp < pre;
            bwd_pair<D>(sq + rr * DP, sk + cc * DP, sdo + rr * DP,
                        sv + cc * DP, keep, scale, sl[rr], sd[rr],
                        &sp[rr * SP + cc], &sds[rr * SP + cc]);
          }
          __syncthreads();
#pragma unroll
          for (int a = 0; a < ACC; ++a) {
            const int e = threadIdx.x + a * NT;
            const int cc = e / D, d = e % D;
            float av = dv[a], ak = dk[a];
#pragma unroll 8
            for (int rr = 0; rr < QC; ++rr) {
              av = fmaf(sp[rr * SP + cc], sdo[rr * DP + d], av);
              ak = fmaf(sds[rr * SP + cc], sq[rr * DP + d], ak);
            }
            dv[a] = av;
            dk[a] = ak;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = threadIdx.x + a * NT;
      const int cc = e / D, d = e % D;
      const size_t off = static_cast<size_t>(kr0 + cc) * D + d;
      dkh[off] = from_f32<T>(dk[a]);
      dvh[off] = from_f32<T>(dv[a]);
    }
  }
}

// Host dispatch over the kernels' template parameters: calls
// f(TypeTag<T>, BLK, D) with BLK and D as std::integral_constant for
// dtype 0 (float32) / 1 (bfloat16), blk in 16, 32, 64, 128 and D in 16,
// 32, 64, 128 and nemotron-4's 192 (kernel.HEAD_DIMS): every prefill and
// backward kernel (tri_fwd.cu, fwd_bb.cu, packed_fwd.cu, tri_bwd.cu,
// packed_bwd.cu; fused_step.cu and packed_decode.cu switch over the same
// set).
template <typename F>
inline int dispatch_tile(int dtype, int blk, int D, F&& f) {
  auto by_d = [&](auto t, auto b) -> int {
    switch (D) {
      case 16: return f(t, b, std::integral_constant<int, 16>{});
      case 32: return f(t, b, std::integral_constant<int, 32>{});
      case 64: return f(t, b, std::integral_constant<int, 64>{});
      case 128: return f(t, b, std::integral_constant<int, 128>{});
      case 192: return f(t, b, std::integral_constant<int, 192>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  auto by_blk = [&](auto t) -> int {
    switch (blk) {
      case 16: return by_d(t, std::integral_constant<int, 16>{});
      case 32: return by_d(t, std::integral_constant<int, 32>{});
      case 64: return by_d(t, std::integral_constant<int, 64>{});
      case 128: return by_d(t, std::integral_constant<int, 128>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  return dispatch_dtype(dtype, by_blk);
}

}  // namespace tri

// The bf16 tensor-core body of tri_fwd.cu and fwd_bb.cu (uses cp_async16).
#include "attn_mma.cuh"
