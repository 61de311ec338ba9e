// Tile bodies shared by the attention kernels (packed_fwd.cu,
// packed_decode.cu, fused_step.cu, tri_fwd.cu, tri_bwd.cu, packed_bwd.cu,
// fwd_bb.cu).
//
// prefill_row_tile is one prefill accumulator owner: one q-row tile of one
// packed member (or of the one request of tri_fwd) for one query head,
// walking the member-local lambdas of its row through member_map_params
// with an f32 online softmax, one prefill_key_tile a lambda (fwd_bb.cu runs
// that key-tile step alone, one block per tile of the n x n grid).
// dq_row_tile and dkv_col_tile are the backward's owners: a q-row tile's
// dq, and a key-column tile's dk/dv over every query head of its kv head
// (tri_bwd.cu with row0 = 0, packed_bwd.cu with a member's first tile
// row). decode_member is one decode accumulator owner: one live slot's
// single query for all g query heads of one kv head, streaming the slot's
// cache tiles with cp.async. Each kernel reads its own member table and
// hands these bodies plain integers, so the (7, R), (5, R) and (8, R) row
// layouts stay with their kernels, and a fused launch runs exactly the code
// of the two split kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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
  static constexpr int KC = BLK < 32 ? BLK : 32;
  static constexpr int DP = D + 1;
  static constexpr int SP = KC + 1;
  static constexpr int ACC = BLK * D / PREFILL_NT;
  static constexpr int FLOATS = 2 * BLK * DP + 2 * KC * DP + BLK * SP + 2 * BLK;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
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
// dtype 0 (float32) / 1 (bfloat16), blk and D in 16, 32, 64, 128.
template <typename T>
struct TypeTag {
  using type = T;
};

template <typename F>
inline int dispatch_tile(int dtype, int blk, int D, F&& f) {
  auto by_d = [&](auto t, auto b) -> int {
    switch (D) {
      case 16: return f(t, b, std::integral_constant<int, 16>{});
      case 32: return f(t, b, std::integral_constant<int, 32>{});
      case 64: return f(t, b, std::integral_constant<int, 64>{});
      case 128: return f(t, b, std::integral_constant<int, 128>{});
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
  if (dtype == 0) return by_blk(TypeTag<float>{});
  if (dtype == 1) return by_blk(TypeTag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
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
