// The tensor-core tile bodies of the bf16 triangular backward (tri_bwd.cu)
// and of the packed backward (packed_bwd.cu, row0 > 0) for Hopper
// (sm_90a), built on the forward's fragments and helpers (attn_mma.cuh):
// wgmma m64nNk16 (f32 += bf16 x bf16), swizzled TMA tiles,
// mbarriers, the C-to-A repack of a 64 x 64 f32 fragment into bf16 A
// operands, and accumulate_pv's RS product against an MN-major tile.
//
// Unit of work. The backward works in 64 x 64 sub-tiles (wgmma's M): every
// tile it loads is 64 rows of a (rows, D) bf16 tensor, one TMA box per
// swizzle atom, so a blk 128 tile is 2 x 2 sub-tiles and blk 64 and 128
// run one code. A 64-row tile serves K-major in one product and MN-major
// in another (the forward's S = Q K^T and O += P V):
//
//   dq (one warpgroup, 64 query rows)    dk/dv (two warpgroups, 64 keys)
//   S    = Q K_j^T    ss, both K-major    WG0: S^T  = K Q_i^T    ss
//   dP   = dO V_j^T   ss, both K-major    WG1: dP^T = V dO_i^T   ss
//   dQ  += dS K_j     rs, K MN-major      WG0: dV  += P^T dO_i   rs
//                                         WG1: dK  += dS^T Q_i   rs
//
// dk/dv compute in the transposed orientation, so their keys are wgmma's
// M and lse and delta vary along the fragment's columns: each ring stage
// holds the query chunk's lse and delta (64 f32 each) beside its Q and dO,
// copied by cp.async.bulk onto the stage's mbarrier. WG0 writes its f32
// P^T to shared memory (one of two 16 KB buffers) and arrives on a named
// barrier; WG1 waits there and forms dS^T from it and its own dP^T. Each
// warpgroup holds one D-wide f32 accumulator (dV or dK), one 64 x 64
// fragment and its bf16 repack: D / 2 + 32 + 16 registers of data.
//
// Head dims 16-192 run one code. At nemotron-4's D 192 a 64-row tile is
// three 128-byte swizzle atoms of 8 KB side by side (tma_tile issues a box
// an atom, as the forward's ring does), S = Q K^T and dP = dO V^T take 12
// k16 steps across them (issue_ss), and dQ += dS K, dV += P^T dO and dK +=
// dS^T Q are m64n192k16 (Wgmma<192>::rs, the atoms 8 KB apart along N).
// The accumulator is then 96 registers a thread; P^T's hand-off buffers
// stay 64 x 64 f32 whatever D is. Shared memory at D 192: dq 148,504
// bytes (the K/V ring of two stages), dk/dv 231,992 (three Q/dO stages),
// 456 bytes short of the 232,448 a block may take: a byte more in the
// dk/dv layout fails the static_assert in BwdShape, and the way out is a
// ring of two stages at D 192.
//
// Numerics (tests/test_torch_tri_bwd_numerics.py holds a plain emulation of
// them against the reference's kernels): S and dP in f32; s scaled, then
// the reference's token mask writes the finite MASK_VALUE; p = exp2((s -
// lse) log2 e), log2 e applied to the difference and never folded into the
// scale (MASK_VALUE log2 e overflows; here that turns a masked p into
// exp2(-inf) = 0, as the reference's exp(MASK_VALUE - lse) is); dS = p (dP
// - delta) scale in f32 from the f32 p; P and dS rounded to bf16 only as A
// operands of the RS products (FlashAttention's choice). dk/dv sum the
// group's query heads in one f32 accumulator.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "attn_tiles.cuh"

namespace tri {
namespace tc {

constexpr int QB = 64;  // rows of a backward sub-tile: wgmma's M

template <int D>
struct BwdShape {
  using Sh = Shape<QB, D>;
  static constexpr int SW = Sh::SW;
  static constexpr int TILE = QB * D * 2;  // bytes of a 64-row bf16 tile
  static constexpr int DQ_ST = 2;          // stages of dq's K/V ring
  static constexpr int DKV_ST = 3;         // stages of dk/dv's Q/dO ring
  static constexpr int DQ_NT = 128;        // one warpgroup
  static constexpr int DKV_NT = 256;       // two warpgroups
  // dq: Q, dO, the K/V ring, then an mbarrier for Q/dO and one a stage
  static constexpr size_t DQ_BYTES =
      (2 + 2 * DQ_ST) * TILE + 8 * (1 + DQ_ST) + 1024;
  // dk/dv: K, V, the Q/dO ring, the ring's lse and delta, two P^T
  // hand-off buffers (QB x QB f32), an mbarrier for K/V and two a stage
  static constexpr size_t DKV_BYTES = (2 + 2 * DKV_ST) * TILE +
                                      DKV_ST * 2 * QB * 4 + 2 * QB * QB * 4 +
                                      8 * (1 + 2 * DKV_ST) + 1024;
  static_assert(TILE % 1024 == 0, "tiles keep the swizzle's 1 KB period");
  static_assert(DQ_BYTES <= SMEM_LIMIT && DKV_BYTES <= SMEM_LIMIT,
                "dq and dk/dv fit one block's shared memory");
};

// The four tensor maps of the backward (64-row boxes) and the rows where
// this block's q/do head planes and k/v head plane start in them.
struct BwdSrc {
  const CUtensorMap *tq, *tk, *tv, *tdo;
  int q_row, kv_row;
};

// Where two runs of a block's dk/dv columns stand: steps through the ring
// (its stages' parities) and columns done (the K/V barrier's parity).
struct BwdRing {
  int steps, cols;
};

// `bytes` from global src to shared dst by the bulk copy engine,
// completing on bar (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// An mbarrier whose phase completes after `count` arrivals (no copies).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// c += A B^T over D for 64-row K-major tiles a and b (issued, not waited
// for: the caller fences before and commits after).
template <int D>
__device__ __forceinline__ void issue_ss(float (&c)[32], const unsigned char* a,
                                         const unsigned char* b) {
  constexpr int SW = BwdShape<D>::SW, SWZ = Shape<QB, D>::SWIZZLE;
  const uint32_t a0 = smem_u32(a), b0 = smem_u32(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (32 * kk / SW) * QB * SW + (32 * kk) % SW;
    Wgmma<QB>::ss(c, desc(a0 + off, 16, 8 * SW, SWZ),
                  desc(b0 + off, 16, 8 * SW, SWZ));
  }
}

// A warpgroup's D-wide f32 accumulator over 64 rows, in bf16, to rows
// [r0, r0 + QB) of the (S, D) plane dst.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2],
                                          bf16* __restrict__ dst, int r0) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(
          dst + static_cast<size_t>(row + 8 * r) * D + 8 * c + col) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
}

// dq of the 64 query rows `sub` of q-row tile i (tile edge BLK) of a
// member whose tiles start at tile row row0: walks j over [first_col(i),
// last_col(i)] in the reference's order, each tile's 64-key sub-tiles in
// turn, K and V through a TMA ring of ST stages. dqh points at this head's
// (S, D) dq plane, lh / dh at its (S,) lse and delta rows. One warpgroup.
template <int BLK, int D>
__device__ __forceinline__ void dq_sub_row(const BwdSrc& src,
                                           bf16* __restrict__ dqh,
                                           const float* __restrict__ lh,
                                           const float* __restrict__ dh,
                                           int row0, int i, int sub, int w_r,
                                           int p_r, int win, int pre,
                                           float scale, unsigned char* smem) {
  using Bs = BwdShape<D>;
  constexpr int TILE = Bs::TILE, ST = Bs::DQ_ST, NSUB = BLK / QB;
  unsigned char* sq = smem;
  unsigned char* sdo = smem + TILE;
  unsigned char* ring = smem + 2 * TILE;  // stage u: K at 2 u TILE, V after
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + 2 * ST * TILE);
  uint64_t* full = bar_q + 1;
  const int win_eff = win > 0 ? win : (1 << 30);
  const int first = first_col_params(i, w_r);
  const int steps = (last_col_params(i, p_r) - first + 1) * NSUB;
  const int qp0 = i * BLK + QB * sub;  // member-local position of row 0
  const int qg0 = row0 * BLK + qp0;    // its row in the plane
  auto load_kv = [&](int s) {
    if (threadIdx.x != 0 || s >= steps) return;
    const int kr = (row0 + first + s / NSUB) * BLK + QB * (s % NSUB);
    unsigned char* dst = ring + (s % ST) * 2 * TILE;
    mbar_expect(full + s % ST, 2 * TILE);
    tma_tile<QB, D>(dst, src.tk, src.kv_row + kr, full + s % ST);
    tma_tile<QB, D>(dst + TILE, src.tv, src.kv_row + kr, full + s % ST);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q);
#pragma unroll
    for (int x = 0; x < ST; ++x) mbar_init(full + x);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar_q, 2 * TILE);
    tma_tile<QB, D>(sq, src.tq, src.q_row + qg0, bar_q);
    tma_tile<QB, D>(sdo, src.tdo, src.q_row + qg0, bar_q);
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load_kv(s);

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5) + (lane >> 2);
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = lh[qg0 + rw + 8 * r];
    dlt[r] = dh[qg0 + rw + 8 * r];
  }
  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  for (int s = 0; s < steps; ++s) {
    load_kv(s + ST - 1);
    if (s == 0) mbar_wait(bar_q, 0);
    mbar_wait(full + s % ST, (s / ST) & 1);
    const int kp0 = (first + s / NSUB) * BLK + QB * (s % NSUB);
    const unsigned char* sk = ring + (s % ST) * 2 * TILE;
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    wgmma_fence();
    issue_ss<D>(sc, sq, sk);
    issue_ss<D>(dp, sdo, sk + TILE);
    wgmma_commit();
    wgmma_wait();
    hold(sc);
    hold(dp);
    const bool inside = block_inside(qp0, kp0, QB, win_eff, pre);
#pragma unroll
    for (int c = 0; c < QB / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * c + e, r = e >> 1;
        float v = sc[x] * scale;
        if (!inside && !keep_pair(qp0 + rw + 8 * r,
                                  kp0 + 8 * c + 2 * t + (e & 1), win_eff, pre))
          v = MASK_VALUE;
        const float p = exp2f((v - lse[r]) * LOG2E);
        sc[x] = p * (dp[x] - dlt[r]) * scale;
      }
    uint32_t ds[QB / 16][4];
    repack<QB>(sc, ds);
    accumulate_pv<QB, D>(acc, ds, sk);  // dQ += dS K, K MN-major
    __syncthreads();  // this stage is refilled at step s + 1
  }
  store_acc<D>(acc, dqh, qg0);
}

// dk (WG1) and dv (WG0) of the 64 keys `half` of key-column tile j (tile
// edge BLK) for one kv head: walks every query head gi of the group, then
// rows i over [cm_first_row(j), cm_last_row(j)], then each row tile's
// 64-row query chunks, Q, dO, lse and delta through a TMA ring of ST
// stages; the group's heads sum in one f32 accumulator. ring carries the
// stages' and the barriers' phases from a block's previous column.
// qg/dog (through src) and lg/dg start at the group's first query head
// (heads are consecutive planes of S rows); dkh/dvh at the kv head's
// (S, D) planes. Two warpgroups, which run decoupled within a column:
// every thread releases a stage on its `empty` mbarrier when it is done
// with it, and P^T alternates between two buffers, WG0 arriving on
// READY + b when buffer b holds a step's P^T and WG1 on FREE + b when it
// has read it, so WG0 computes step s + 1's P^T while WG1 finishes step s.
template <int BLK, int D>
__device__ __forceinline__ void dkv_sub_col(const BwdSrc& src,
                                            const float* __restrict__ lg,
                                            const float* __restrict__ dg,
                                            bf16* __restrict__ dkh,
                                            bf16* __restrict__ dvh, int g,
                                            int S, int row0, int j, int half,
                                            int n_r, int w_r, int p_r,
                                            int win, int pre, float scale,
                                            unsigned char* smem,
                                            BwdRing& ring_at) {
  using Bs = BwdShape<D>;
  constexpr int TILE = Bs::TILE, ST = Bs::DKV_ST, NSUB = BLK / QB;
  constexpr int NT = Bs::DKV_NT, READY = 1, FREE = 3;  // named barriers
  unsigned char* sk = smem;
  unsigned char* sv = smem + TILE;
  unsigned char* ring = smem + 2 * TILE;  // stage u: Q at 2 u TILE, dO after
  float* rows = reinterpret_cast<float*>(ring + 2 * ST * TILE);  // lse, delta
  float* pt = rows + ST * 2 * QB;  // two P^T buffers, f32
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(pt + 2 * QB * QB);
  uint64_t* full = bar_kv + 1;  // a stage's copies landed
  uint64_t* empty = full + ST;  // every thread is done with a stage
  const int win_eff = win > 0 ? win : (1 << 30);
  const int first = cm_first_row_params(j, p_r);
  const int span = (cm_last_row_params(j, n_r, w_r) - first + 1) * NSUB;
  const int steps = g * span;
  const int kp0 = j * BLK + QB * half;  // member-local position of key 0
  const int kg0 = row0 * BLK + kp0;     // its row in the plane
  const int t0 = ring_at.steps;
  // step s: head s / span, query chunk first * NSUB + s % span, into stage
  // (t0 + s) % ST once every thread has released that stage's step before
  auto load_q = [&](int s) {
    if (threadIdx.x != 0 || s >= steps) return;
    const int at_t = t0 + s, u = at_t % ST;
    if (at_t >= ST) mbar_wait(empty + u, (at_t / ST - 1) & 1);
    const int gi = s / span;
    const int qr = (row0 + first) * BLK + QB * (s % span);
    const size_t at = static_cast<size_t>(gi) * S + qr;
    unsigned char* dst = ring + u * 2 * TILE;
    mbar_expect(full + u, 2 * TILE + 2 * QB * 4);
    tma_tile<QB, D>(dst, src.tq, src.q_row + static_cast<int>(at), full + u);
    tma_tile<QB, D>(dst + TILE, src.tdo, src.q_row + static_cast<int>(at),
                    full + u);
    bulk_copy(rows + u * 2 * QB, lg + at, QB * 4, full + u);
    bulk_copy(rows + u * 2 * QB + QB, dg + at, QB * 4, full + u);
  };

  if (ring_at.cols == 0) {  // a block's first column
    if (threadIdx.x == 0) {
      mbar_init(bar_kv);
#pragma unroll
      for (int x = 0; x < ST; ++x) {
        mbar_init(full + x);
        mbar_init(empty + x, NT);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    mbar_expect(bar_kv, 2 * TILE);
    tma_tile<QB, D>(sk, src.tk, src.kv_row + kg0, bar_kv);
    tma_tile<QB, D>(sv, src.tv, src.kv_row + kg0, bar_kv);
  }
  load_q(0);

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int kw = 16 * (tid >> 5) + (lane >> 2);  // this lane's key row
  float acc[D / 2];  // WG0: dV, WG1: dK
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  mbar_wait(bar_kv, ring_at.cols & 1);
  for (int s = 0; s < steps; ++s) {
    load_q(s + 1);  // one step ahead: WG0 may lead WG1 by ST - 1 steps
    __syncwarp();
    const int u = (t0 + s) % ST, b = s & 1;
    mbar_wait(full + u, ((t0 + s) / ST) & 1);
    const int qp0 = first * BLK + QB * (s % span);
    const unsigned char* sq = ring + u * 2 * TILE;
    const unsigned char* sdo = sq + TILE;
    const float* lse = rows + u * 2 * QB;
    const float* dlt = lse + QB;
    float* pb = pt + b * QB * QB;  // float4 c of thread tid at 4 (128 c + tid)
    float sc[32];  // WG0: S^T, then P^T; WG1: dP^T, then dS^T
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    wgmma_fence();
    issue_ss<D>(sc, wg ? sv : sk, wg ? sdo : sq);
    wgmma_commit();
    wgmma_wait();
    hold(sc);
    if (wg == 0) {
      const bool inside = block_inside(qp0, kp0, QB, win_eff, pre);
#pragma unroll
      for (int c = 0; c < QB / 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * c + e;
          float v = sc[x] * scale;
          if (!inside &&
              !keep_pair(qp0 + 8 * c + 2 * t + (e & 1), kp0 + kw + 8 * (e >> 1),
                         win_eff, pre))
            v = MASK_VALUE;
          sc[x] = exp2f((v - ((e & 1) ? l2.y : l2.x)) * LOG2E);
        }
      }
      if (s >= 2) named_sync(FREE + b, NT);  // WG1 has read step s - 2's
#pragma unroll
      for (int c = 0; c < QB / 8; ++c)
        *reinterpret_cast<float4*>(pb + 4 * (128 * c + tid)) = make_float4(
            sc[4 * c], sc[4 * c + 1], sc[4 * c + 2], sc[4 * c + 3]);
      named_arrive(READY + b, NT);
    } else {
      named_sync(READY + b, NT);
#pragma unroll
      for (int c = 0; c < QB / 8; ++c) {
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * c + 2 * t);
        const float4 p4 =
            *reinterpret_cast<const float4*>(pb + 4 * (128 * c + tid));
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * c + e] =
              p[e] * (sc[4 * c + e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
      if (s + 2 < steps) named_arrive(FREE + b, NT);  // step s + 2 may write
    }
    uint32_t a[QB / 16][4];
    repack<QB>(sc, a);
    accumulate_pv<QB, D>(acc, a, wg ? sq : sdo);  // dK += dS^T Q, dV += P^T dO
    mbar_arrive(empty + u);
  }
  __syncthreads();  // K, V and the P^T buffers are rewritten by the next column
  ring_at.steps += steps;
  ring_at.cols += 1;
  store_acc<D>(acc, wg ? dkh : dvh, kg0);
}

// The bf16 tensor-core body runs at blk 64 and 128 (kernel.tile_body);
// float32, and bf16 at blk 16 and 32, keep the CUDA-core body.
template <typename T, int BLK>
constexpr bool kTensorCores = std::is_same_v<T, __nv_bfloat16> && BLK >= QB;

// The bf16 body reads q, k, v, do by TMA and lse, delta by bulk copy, and
// writes 4-byte pairs: every pointer must be 16-byte aligned.
inline bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* x : ptrs) bits |= reinterpret_cast<uintptr_t>(x);
  return bits & 15;
}

// Host side: the maps of q, do (B H S rows) and k, v (B Hkv S rows) in
// 64-row boxes, swizzled as the forward's.
template <int D>
inline int make_bwd_tmaps(CUtensorMap (&maps)[4], const void* q, const void* k,
                          const void* v, const void* dout, int B, int H,
                          int Hkv, int S) {
  constexpr int SW = BwdShape<D>::SW;
  const long long q_rows = static_cast<long long>(B) * H * S;
  const long long kv_rows = static_cast<long long>(B) * Hkv * S;
  if (int err = make_tmap(&maps[0], q, q_rows, D, QB, SW)) return err;
  if (int err = make_tmap(&maps[1], k, kv_rows, D, QB, SW)) return err;
  if (int err = make_tmap(&maps[2], v, kv_rows, D, QB, SW)) return err;
  return make_tmap(&maps[3], dout, q_rows, D, QB, SW);
}

}  // namespace tc
}  // namespace tri
