// The decode body of packed_decode.cu and of the fused step's decode half
// (fused_step.cu), for Hopper (sm_90a): one decode round, each live slot's
// single query over its cache tokens [kv_first, kv_len) for the g query
// heads of one kv head, an f32 softmax on the CUDA cores.
//
// Chunks. A member's walk from its first tile kv_first / blk is cut into
// chunks of CT = DECODE_CHUNK / blk tiles (DECODE_CHUNK cache tokens; the
// last chunk may be shorter), and every (chunk, head slice) is a block of
// its own, so a round of four slots with up to 2000 cache tokens spreads
// over ~112 of the card's 132 SMs where one block a (member, kv head) gave
// 16. A member's chunking depends only on its own kv_first, kv_tiles and
// blk, never on the other members, the table width or the grid: a slot's
// output is the same bits whatever else the round holds. A block finds its
// (member, chunk) by a prefix sum over the decode columns' chunk counts
// (one warp, the columns read in parallel); blocks
// walk the round's chunks x, x + blocks, ... so a grid sized from an
// understated tile count is slower, never wrong. Columns that own no tiles
// (the empty columns with slot 0, the pad member with slot == B and
// DECODE_NO_EMIT) have no chunks and touch no memory.
//
// Merge in the launch. A member of one chunk writes its output directly. A
// chunk of a longer member writes its partial state (m, l and acc over its
// heads x D, f32) to the workspace, counts itself in its (member, head
// slice) arrival counter (atomicAdd after __threadfence; the partials use
// no atomics), and the block that arrives last merges the member's chunks
// in chunk order 0 .. n - 1 (m = max m_c, l = sum l_c exp(m_c - m), acc =
// sum acc_c exp(m_c - m), out = acc / l; the loops over the chunks are
// unrolled by 8 so their loads from L2 overlap) and resets the counter to
// 0, so the next launch finds zeros. Which block merges varies between runs;
// what it computes does not, so two runs are bitwise equal. With one chunk
// the merge would give the chunk's own acc / l, the value written. Both
// divide by __fdividef (within 2 ulp; l >= 1), which calls no slow path.
// A merge through a thread-block cluster's distributed shared memory would
// need no workspace, but the fused kernel's one grid would put its prefill
// blocks in clusters too, so the partials go through L2.
//
// The walk of a chunk. Every thread copies its 16-byte pieces of each
// tile's K and V rows by cp.async into a ring of STAGES stages and arrives
// on the stage's mbarrier when they land (decode_issue); a chunk of 128
// tokens fits whole in every supported geometry, so all its tiles are in
// flight from the start. Rows are padded by 16 bytes, so the 16-byte loads
// of eight consecutive keys' rows hit distinct banks. A tile then takes
// two block barriers:
//   - scores: each thread owns one key of the tile and up to ceil(8 / (NT /
//     blk)) heads, and computes each score over all of D (four chains, d
//     mod 4, summed (0 + 1) + (2 + 3); the key's row read 16 bytes at a
//     time, the queries' broadcast from shared memory): no shuffle tree
//     per (key, head). Barrier.
//   - softmax: one warp a head, the tile's max and p = exp(s - m_new) over
//     the warp (one max and one sum tree a head a tile), alpha and l.
//     Barrier.
//   - PV: each thread owns ceil(8 D / VEC / NT) (head, 16-byte column of
//     D) items, e / (D / VEC) and e % (D / VEC) for e = tid + NT i, in
//     registers: acc = acc * alpha, then one fmaf a key in key order. Where
//     NT is a multiple of D / VEC (D up to 128) a thread's items share one
//     column and one load a key; at D 192 (48 or 24 columns) they do not.
// The ring stage of tile t - 1 is refilled after the first barrier of tile
// t (every thread is past its PV), and the scores / p buffer alternates
// between two halves, so nothing else waits. Each output element is
// computed by the same sequence of operations at any thread count: the
// fused decode half at its prefill body's count and packed_decode at 256
// give the same bits.
//
// Bound on this card. Decode reads every cached K/V byte of the live
// members once and does 4 g flops a cached element pair (an f32 cache: 4
// flops a byte at g = 8, 13.4 TFLOP/s at 3.35 TB/s, a fifth of the f32
// CUDA-core rate), so HBM bandwidth bounds it and the f32 FMAs stay, as the
// reference computes; what the body needs is parallelism across SMs and
// copies in flight, which the chunks and the ring give.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_tiles.cuh"

namespace tri {

// Cache tokens of one decode chunk (kernel.py's DECODE_CHUNK): a multiple of
// every supported blk.
constexpr int DECODE_CHUNK = 128;
// Query heads of one kv head a block serves (kernel.py's DECODE_HEADS): a
// group of g > 8 takes ceil(g / 8) head slices, blocks of their own.
constexpr int DECODE_HEADS = 8;

template <typename TC, int BLK, int D>
struct DecodeShape {
  static_assert(DECODE_CHUNK % BLK == 0, "a chunk is whole tiles");
  static constexpr int CT = DECODE_CHUNK / BLK;      // tiles a chunk
  static constexpr int VEC = 16 / sizeof(TC);        // elements a 16 B load
  static constexpr int DP = D + VEC;                 // padded row, elements
  static constexpr size_t TILE = 2 * BLK * DP * sizeof(TC);  // K then V
  // the queries (f32), two halves of scores / p, m, l, alpha and the
  // merge flag
  static constexpr size_t STATE =
      sizeof(float) * (DECODE_HEADS * D + 2 * DECODE_HEADS * BLK +
                       3 * DECODE_HEADS) + 16;
  static constexpr int FIT =
      static_cast<int>((SMEM_LIMIT - STATE - 16 * CT) / TILE);
  static constexpr int STAGES = CT < FIT ? CT : FIT;
  static constexpr size_t BARS = 16 * ((8 * STAGES + 15) / 16);
  static constexpr size_t BYTES = STAGES * TILE + BARS + STATE;
  static_assert(STAGES >= 1 && BYTES <= SMEM_LIMIT, "one tile fits");
};

// The decode columns of a member table, as each kernel lays them out, and
// the launch's other operands.
template <typename TQ, typename TC>
struct DecodeArgs {
  const TQ* q;    // (B, H, D)
  const TC* kc;   // (B, S_cache, Hkv, D)
  const TC* vc;
  TQ* out;        // (B + 1, H, D)
  const int *slot, *tiles, *len, *first;  // n_cols entries each
  int n_cols;
  // partials: acc (n_cols, MC, H, D), then (m, l) (n_cols, MC, H, 2), f32,
  // MC = ceil(S_cache / DECODE_CHUNK)
  float* ws;
  int* arrivals;  // (n_cols, head slices), 0 between launches
  int B, H, Hkv, S_cache;
  float scale;
};

// Head slices of a launch: ceil(g / DECODE_HEADS) a kv head.
__host__ __device__ inline int decode_head_slices(int H, int Hkv) {
  const int g = H / Hkv;
  return Hkv * ((g + DECODE_HEADS - 1) / DECODE_HEADS);
}

// Chunk blocks of a launch over a round of `tiles` live tiles in n_cols
// columns: sum_r ceil(kv_tiles_r / CT) <= ceil(tiles / CT) + n_cols
// (kernel.py's decode_grid).
inline int decode_chunk_blocks(int tiles, int n_cols, int blk) {
  const int ct = DECODE_CHUNK / blk;
  return (max(tiles, 0) + ct - 1) / ct + n_cols;
}

// Chunks of decode column r: none for a column that owns no tiles, else
// ceil(kv_tiles / CT), the tiles counted up to the cache's last
// (make_decode_table's kv_len <= S_cache keeps them all).
template <typename TQ, typename TC>
__device__ __forceinline__ int decode_chunks(const DecodeArgs<TQ, TC>& a,
                                             int r, int blk) {
  const int slot = a.slot[r], kv_tiles = a.tiles[r];
  if (slot < 0 || slot >= a.B || kv_tiles <= 0 ||
      kv_tiles == DECODE_NO_EMIT || a.len[r] <= 0)
    return 0;
  const int tiles = min(kv_tiles, a.S_cache / blk - a.first[r] / blk);
  const int ct = DECODE_CHUNK / blk;
  return tiles <= 0 ? 0 : (tiles + ct - 1) / ct;
}

// Called by one whole warp: lane 0 writes to own the column r that block
// chunk x falls in (or -1 past the round's last chunk), the chunk within
// it and the column's chunks (kernel.py's decode_owner). Each lane reads
// a column's entries, so the table costs one round trip from memory; a
// prefix sum over the warp finds the column.
template <typename TQ, typename TC>
__device__ __forceinline__ void decode_owner(const DecodeArgs<TQ, TC>& a,
                                            int x, int blk, int* own) {
  const int lane = threadIdx.x % 32;
  int r = -1, c = 0, nc = 0;
  for (int i0 = 0, base = 0; i0 < a.n_cols; i0 += 32) {
    const int i = i0 + lane;
    const int n_i = i < a.n_cols ? decode_chunks(a, i, blk) : 0;
    int incl = n_i;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int lo = base + incl - n_i;
    const unsigned hit = __ballot_sync(0xffffffffu, x >= lo && x < lo + n_i);
    if (hit) {
      const int src = __ffs(hit) - 1;
      r = i0 + src;
      c = x - __shfl_sync(0xffffffffu, lo, src);
      nc = __shfl_sync(0xffffffffu, n_i, src);
      break;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) {
    own[0] = r;
    own[1] = c;
    own[2] = nc;
  }
}

// The loader of the K/V ring. Every thread copies its 16-byte pieces of
// tile rows [tok0, tok0 + BLK) of K and V into one stage by cp.async
// (consecutive threads on consecutive pieces of a row), then arrives on
// the stage's mbarrier once they have landed
// (cp.async.mbarrier.arrive.noinc), so the phase completes when all NT
// threads' pieces are in and no thread waits on a block barrier for them.
// Issued as one cp.async.bulk a token row by one warp instead, the copies
// held a chunk's walk at ~6 us a tile whether L2 was cold or warm
// (scripts/decode_variants.py builds that loader).
template <typename TC, int BLK, int D, int NT>
__device__ __forceinline__ void decode_issue(TC* stage, uint64_t* bar,
                                             const TC* ks, const TC* vs,
                                             int tok0, size_t tok_stride) {
  using Sh = DecodeShape<TC, BLK, D>;
  constexpr int PIECES = D / Sh::VEC;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < 2 * BLK * PIECES; e += NT) {
    const int row = e / PIECES, pc = e - row * PIECES;
    const int tr = row < BLK ? row : row - BLK;
    const TC* src = (row < BLK ? ks : vs) +
                    static_cast<size_t>(tok0 + tr) * tok_stride + pc * Sh::VEC;
    cp_async16(stage + row * Sh::DP + pc * Sh::VEC, src);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   tc::smem_u32(bar))
               : "memory");
}

// A ring stage's mbarrier: one arrival a thread a fill.
template <int NT>
__device__ __forceinline__ void decode_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_u32(bar)),
               "r"(NT));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// 16 bytes of cache elements at p as f32.
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The decode chunks of one launch for head slice hs: this block walks the
// round's chunks x0, x0 + xstep, ... until the columns' chunks run out.
template <typename TQ, typename TC, int BLK, int D, int NT>
__device__ __forceinline__ void decode_walk(const DecodeArgs<TQ, TC>& a,
                                            int x0, int xstep, int hs,
                                            unsigned char* smem) {
  using Sh = DecodeShape<TC, BLK, D>;
  constexpr int GH = DECODE_HEADS, S = Sh::STAGES, CT = Sh::CT;
  constexpr int VEC = Sh::VEC, DP = Sh::DP, NW = NT / 32;
  static_assert(NT % 32 == 0 && NT % BLK == 0, "a key a thread");
  // scores: key tid % BLK, heads sg + SG i
  constexpr int SG = NT / BLK;
  constexpr int HPS = (GH + SG - 1) / SG;
  // PV: item i of a thread is (head, 16-byte column) e / NC, e % NC of
  // e = tid + NT i; where NT is a multiple of NC (D <= 128) all of a
  // thread's items share its column tid % NC and one load a key
  constexpr int NC = D / VEC;
  constexpr int HPT = (GH * NC + NT - 1) / NT;
  constexpr bool ONE_COL = NT % NC == 0;

  TC* ring = reinterpret_cast<TC*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * Sh::TILE);
  float* sq = reinterpret_cast<float*>(smem + S * Sh::TILE + Sh::BARS);
  float* sbuf = sq + GH * D;   // two halves of GH x BLK scores / p
  float* sm = sbuf + 2 * GH * BLK;
  float* sl = sm + GH;
  float* sa = sl + GH;
  int* flag = reinterpret_cast<int*>(sa + GH);
  int* own = flag + 1;  // the chunk's column, chunk and the column's chunks

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = a.H / a.Hkv, per_kv = (g + GH - 1) / GH;
  const int hk = hs / per_kv, h0 = (hs - hk * per_kv) * GH;
  const int gs = min(GH, g - h0);
  const int HS = a.Hkv * per_kv;
  const int MC = (a.S_cache / BLK + CT - 1) / CT;
  const size_t tok_stride = static_cast<size_t>(a.Hkv) * D;
  const int kk = tid % BLK, sg = tid / BLK;
  auto item_col = [&](int i) { return ONE_COL ? tid % NC : (tid + NT * i) % NC; };
  auto item_head = [&](int i) { return (tid + NT * i) / NC; };

  if (tid == 0)
    for (int s = 0; s < S; ++s) decode_bar_init<NT>(&bars[s]);
  __syncthreads();
  uint32_t seq = 0;  // tiles issued so far: tile u in stage u % S, phase u / S

  for (int x = x0;; x += xstep) {
    // warp 0 finds chunk x's (column, chunk)
    if (warp == 0) decode_owner(a, x, BLK, own);
    __syncthreads();
    const int r = own[0], c = own[1], nc = own[2];
    if (r < 0) return;  // surplus block, or past the round's last chunk
    const int slot = a.slot[r], kv_len = a.len[r], kv_first = a.first[r];
    const int tile0 = kv_first / BLK + c * CT;
    const int nt = min(CT, min(a.tiles[r], a.S_cache / BLK - kv_first / BLK) -
                               c * CT);
    const TC* ks = a.kc + static_cast<size_t>(slot) * a.S_cache * tok_stride +
                   hk * D;
    const TC* vs = a.vc + static_cast<size_t>(slot) * a.S_cache * tok_stride +
                   hk * D;
    for (int t = 0; t < min(nt, S); ++t) {
      const int st = (seq + t) % S;
      decode_issue<TC, BLK, D, NT>(ring + st * 2 * BLK * DP, &bars[st], ks, vs,
                                   (tile0 + t) * BLK, tok_stride);
    }
    const TQ* qs = a.q + (static_cast<size_t>(slot) * a.H + hk * g + h0) * D;
    for (int e = tid; e < gs * D; e += NT) sq[e] = to_f32(qs[e]);
    for (int i = tid; i < GH; i += NT) {
      sm[i] = MASK_VALUE;
      sl[i] = 0.f;
    }
    float acc[HPT][VEC];
#pragma unroll
    for (int i = 0; i < HPT; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const uint32_t u = seq + t;
      const int st = u % S;
      tc::mbar_wait(&bars[st], (u / S) & 1);
      const TC* sk = ring + st * 2 * BLK * DP;
      const TC* sv = sk + BLK * DP;
      float* ss = sbuf + (t & 1) * GH * BLK;

      // scores: this thread's key against its heads, over D in four
      // chains (d mod 4) summed as (0 + 1) + (2 + 3)
      {
        float s[HPS][4];
#pragma unroll
        for (int i = 0; i < HPS; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        const TC* krow = sk + kk * DP;
#pragma unroll 4
        for (int ci = 0; ci < NC; ++ci) {
          float kf[VEC];
          load16(krow + ci * VEC, kf);
#pragma unroll
          for (int i = 0; i < HPS; ++i) {
            const int h = sg + SG * i;
            if (h < gs) {
              const float4* qv =
                  reinterpret_cast<const float4*>(sq + h * D + ci * VEC);
#pragma unroll
              for (int e4 = 0; e4 < VEC / 4; ++e4) {
                const float4 q4 = qv[e4];
                s[i][0] = fmaf(q4.x, kf[4 * e4], s[i][0]);
                s[i][1] = fmaf(q4.y, kf[4 * e4 + 1], s[i][1]);
                s[i][2] = fmaf(q4.z, kf[4 * e4 + 2], s[i][2]);
                s[i][3] = fmaf(q4.w, kf[4 * e4 + 3], s[i][3]);
              }
            }
          }
        }
        const int kp = (tile0 + t) * BLK + kk;
        const bool keep = kp >= kv_first && kp < kv_len;
#pragma unroll
        for (int i = 0; i < HPS; ++i) {
          const int h = sg + SG * i;
          const float dot = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
          if (h < gs) ss[h * BLK + kk] = keep ? dot * a.scale : MASK_VALUE;
        }
      }
      __syncthreads();
      // every thread is past tile t - 1: its stage takes tile t - 1 + S
      if (S > 1 && t >= 1 && t - 1 + S < nt) {
        const int fs = (seq + t - 1) % S;
        decode_issue<TC, BLK, D, NT>(ring + fs * 2 * BLK * DP, &bars[fs], ks,
                                     vs, (tile0 + t - 1 + S) * BLK,
                                     tok_stride);
      }

      // softmax: one warp a head
      for (int h = warp; h < gs; h += NW) {
        float mx = -INFINITY;
        for (int k = lane; k < BLK; k += 32) mx = fmaxf(mx, ss[h * BLK + k]);
        const float m_prev = sm[h];
        const float m_new = fmaxf(m_prev, warp_max(mx));
        float ps = 0.f;
        for (int k = lane; k < BLK; k += 32) {
          const float p = expf(ss[h * BLK + k] - m_new);
          ss[h * BLK + k] = p;
          ps += p;
        }
        ps = warp_sum(ps);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sa[h] = alpha;
          sl[h] = fmaf(sl[h], alpha, ps);
          sm[h] = m_new;
        }
      }
      __syncthreads();

      // PV: this thread's column of D for its heads, keys in order
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int h = item_head(i);
        if (h < gs) {
          const float alpha = sa[h];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = __fmul_rn(acc[i][e], alpha);
        }
      }
#pragma unroll 4
      for (int k = 0; k < BLK; ++k) {
        float vf[VEC];
        if constexpr (ONE_COL) load16(sv + k * DP + item_col(0) * VEC, vf);
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          const int h = item_head(i);
          if (h < gs) {
            if constexpr (!ONE_COL) load16(sv + k * DP + item_col(i) * VEC, vf);
            const float p = ss[h * BLK + k];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
          }
        }
      }
      // one stage: the next tile waits until every thread is past this one
      if (S == 1 && t + 1 < nt) {
        __syncthreads();
        decode_issue<TC, BLK, D, NT>(ring, &bars[0], ks, vs,
                                     (tile0 + t + 1) * BLK, tok_stride);
      }
    }
    seq += nt;

    const int hrow = hk * g + h0;  // the slice's first query head
    if (nc == 1) {
      TQ* os = a.out + (static_cast<size_t>(slot) * a.H + hrow) * D;
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int h = item_head(i);
        if (h < gs) {
          const float l = sl[h];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            os[h * D + item_col(i) * VEC + e] =
                from_f32<TQ>(__fdividef(acc[i][e], l));
        }
      }
    } else {
      float* wacc = a.ws;
      float* wml = a.ws + static_cast<size_t>(a.n_cols) * MC * a.H * D;
      const size_t cell = static_cast<size_t>(r * MC + c) * a.H + hrow;
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int h = item_head(i);
        if (h < gs) {
          float4* dst = reinterpret_cast<float4*>(wacc + (cell + h) * D +
                                                  item_col(i) * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4)
            dst[e4] = make_float4(acc[i][4 * e4], acc[i][4 * e4 + 1],
                                  acc[i][4 * e4 + 2], acc[i][4 * e4 + 3]);
        }
      }
      for (int h = tid; h < gs; h += NT) {
        wml[(cell + h) * 2] = sm[h];
        wml[(cell + h) * 2 + 1] = sl[h];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* count = a.arrivals + r * HS + hs;
        const bool last = atomicAdd(count, 1) == nc - 1;
        if (last) *count = 0;  // the next launch finds zeros
        *flag = last;
      }
      __syncthreads();
      if (*flag) {
        __threadfence();
        TQ* os = a.out + (static_cast<size_t>(slot) * a.H + hrow) * D;
        const size_t cell0 = static_cast<size_t>(r * MC) * a.H + hrow;
        const size_t step = a.H;  // from chunk to chunk
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          const int h = item_head(i), cc = item_col(i);
          if (h >= gs) continue;
          float m = __ldcg(wml + (cell0 + h) * 2);
#pragma unroll 8
          for (int ci = 1; ci < nc; ++ci)
            m = fmaxf(m, __ldcg(wml + (cell0 + ci * step + h) * 2));
          float l = 0.f, o[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = 0.f;
#pragma unroll 8
          for (int ci = 0; ci < nc; ++ci) {
            const size_t at = cell0 + ci * step + h;
            const float w = expf(__ldcg(wml + at * 2) - m);
            l = fmaf(__ldcg(wml + at * 2 + 1), w, l);
            const float4* src =
                reinterpret_cast<const float4*>(wacc + at * D + cc * VEC);
#pragma unroll
            for (int e4 = 0; e4 < VEC / 4; ++e4) {
              const float4 v = __ldcg(src + e4);
              o[4 * e4] = fmaf(v.x, w, o[4 * e4]);
              o[4 * e4 + 1] = fmaf(v.y, w, o[4 * e4 + 1]);
              o[4 * e4 + 2] = fmaf(v.z, w, o[4 * e4 + 2]);
              o[4 * e4 + 3] = fmaf(v.w, w, o[4 * e4 + 3]);
            }
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            os[h * D + cc * VEC + e] = from_f32<TQ>(__fdividef(o[e], l));
        }
      }
    }
    __syncthreads();  // the ring, the queries and the state are free again
  }
}

}  // namespace tri
