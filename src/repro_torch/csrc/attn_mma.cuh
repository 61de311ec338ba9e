// The tensor-core tile body of the bf16 triangular forward (tri_fwd.cu),
// of the packed forward (packed_fwd.cu) and the fused step's prefill half
// (fused_step.cu), and of tri_fwd's bounding-box baseline (fwd_bb.cu), for
// Hopper (sm_90a).
// attn_tiles.cuh includes it after its cp.async helpers, which it uses.
// The backward (tri_bwd.cu) builds its four products on these fragments,
// descriptors, TMA tiles and mbarriers in attn_mma_bwd.cuh: S = Q K^T and
// dP = dO V^T in the SS form below (or, for dk/dv, their transposes with
// the keys as M), dQ += dS K, dV += P^T dO and dK += dS^T Q in the RS form
// of accumulate_pv, with P and dS repacked from the C fragment as P is
// here; its numerics follow the order below with lse in place of the
// running max.
//
// Geometry. A block owns BLK query rows, one warp per 16 rows: NT = 2 BLK
// threads. At BLK 64 and 128 both products are wgmma.mma_async (m64nNk16,
// f32 += bf16 x bf16), one warpgroup per 64 rows; at BLK 16 and 32 (the
// tile edges models/layers.py picks for short sequences) they are
// mma.sync.m16n8k16, one warp per 16 rows. wgmma's m64 accumulator gives
// each warp its 16 rows in the C-fragment layout of mma.sync m16n8 (lane
// holds rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1} of
// every 8 columns), so the mask, the online softmax, the repack of P into
// the A operand and the epilogue are one code for both paths; only
// the product instructions differ.
//
// Shared memory. On the wgmma path one thread loads each bf16 tile by TMA
// (cp.async.bulk.tensor, completion on an mbarrier) in 2 D / SW boxes of
// SW / 2 columns x BLK rows, swizzled over SW = min(2 D, 128) bytes: each
// row of a box is one SW-byte request, and the swizzle is the one wgmma's
// descriptors name (K-major for Q and K in S = Q K^T, MN-major for V in
// O += P V, which bf16 allows). Atoms start on 1 KB boundaries (at D 192
// a tile is three atoms of BLK x 128 bytes, three boxes, and every tile
// 24 KB or 48 KB). Head dims 16-192 take this body, and the backward's
// (attn_mma_bwd.cuh) too. Filled in
// 16-byte pieces (cp.async 16 bytes a thread, or TMA boxes 16 bytes wide
// into a no-swizzle layout), the same products were bound by the copies
// on the H100; whole 128-byte rows lift that. On the mma.sync path
// cp.async.cg writes a tile 16 bytes a copy into the no-swizzle
// core-matrix layout ((r / 8) (D / 8) + c) 128 + (r % 8) 16 for
// the 16 bytes of row r, columns 8c..8c+7 (a warp writes 512 contiguous
// bytes), which ldmatrix reads without bank conflicts.
//
// Numerics (tests/test_torch_tri_fwd_numerics.py holds a plain emulation of
// them against the reference's kernels): S in f32, scaled, then the
// reference's token mask writes the finite MASK_VALUE; m is the row's max
// over the tile and the previous m (a quad of lanes shares a row: two
// shuffles); p = exp2((s - m) log2 e), log2 e applied to the difference
// and never folded into the scale, because MASK_VALUE log2 e overflows to
// -inf and a fully masked row would give exp2(-inf + inf) = NaN where the
// reference gives m = MASK_VALUE, l = BLK and weight 0 once a live key
// arrives; l sums the f32 p; P is rounded to bf16 for the PV product
// (FlashAttention's choice: ~2^-9 relative a term, as out's own rounding).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "packing.cuh"

namespace tri {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

template <int BLK, int D>
struct Shape {
  static constexpr bool WGMMA = BLK >= 64;  // wgmma + TMA, else mma.sync
  static constexpr int NT = 2 * BLK;        // one warp per 16 rows
  static constexpr int TILE = BLK * D * 2;  // bytes of a bf16 tile
  static constexpr int OS = D + 8;          // bf16 row stride of out's staging
  // wgmma path: a tile is 2 D / SW atoms of BLK rows x SW bytes, swizzled
  // over SW bytes (128, or the whole row where it is shorter)
  static constexpr int SW = 2 * D < 128 ? 2 * D : 128;
  static constexpr int ATOMS = 2 * D / SW;
  // descriptor layout type of that swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int SWIZZLE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  // row_tile: Q, the K/V ring, then an mbarrier for Q and one a stage;
  // fwd_bb: Q, K, V, its arrival flag and one mbarrier; both with 1 KB to
  // align the start (a swizzle pattern repeats every 8 SW bytes)
  static constexpr size_t ring_bytes(int stages) {
    return (1 + 2 * stages) * static_cast<size_t>(TILE) + 8 * (1 + stages) +
           1024;
  }
  // row_tile's K/V ring: two stages, or one where two do not fit (BLK 128
  // at D 192: 246,808 bytes; one stage takes 148,496 and gives up the
  // overlap of the next tile's copy with this tile's products)
  static constexpr int STAGES = ring_bytes(2) <= SMEM_LIMIT ? 2 : 1;
  static constexpr size_t ROW_BYTES = ring_bytes(STAGES);
  static constexpr size_t BB_BYTES = 3 * TILE + 16 + 1024;
  static_assert(BLK * OS * 2 <= 2 * TILE, "out's staging fits two tiles");
  static_assert(ROW_BYTES <= SMEM_LIMIT && BB_BYTES <= SMEM_LIMIT,
                "a row walk fits one block's shared memory");
};

// One warp's 16 rows: this lane's rows g = lane / 4 and g + 8.
struct Rows {
  float m[2], l[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk (row r, columns 8c..8c+7).
template <int D>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return static_cast<uint32_t>(((r >> 3) * (D / 8) + c) * 128 + (r & 7) * 16);
}

// Rows [r0, r0 + ROWS) of an (S, D) plane into the layout at dst: chunk e
// (row 8 ((e / 8) / (D / 8)) + e % 8, column chunk (e / 8) % (D / 8)) lands
// at dst + 16 e.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows_async(unsigned char* dst,
                                                const bf16* __restrict__ src,
                                                int r0) {
  for (int e = threadIdx.x; e < ROWS * D / 8; e += NT) {
    const int rest = e >> 3;
    const int r = (rest / (D / 8)) * 8 + (e & 7), c = rest % (D / 8);
    cp_async16(dst + 16 * e, src + static_cast<size_t>(r0 + r) * D + 8 * c);
  }
}

// The first 1024-byte boundary at or after p in shared memory.
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// wgmma matrix descriptor: start address, LBO and SBO in 16-byte units,
// base offset 0 (atoms start on their swizzle period), layout type (1 =
// 128 B swizzle, 2 = 64 B, 3 = 32 B). For a K-major operand SBO is the
// stride of 8-row groups and LBO is unused; for an MN-major one LBO is the
// stride of atoms along N and SBO that of 8-row groups along K.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of bar's phase, which completes when `bytes` more have
// landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Rows [row, row + BLK) of the (rows, D) bf16 tensor behind map into dst,
// one TMA box (SW / 2 columns x BLK rows, swizzled) an atom, completing on
// bar.
template <int BLK, int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int row,
                                         uint64_t* bar) {
  constexpr int SW = Shape<BLK, D>::SW;
#pragma unroll
  for (int a = 0; a < Shape<BLK, D>::ATOMS; ++a)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(dst + a * BLK * SW)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(a * SW / 2), "r"(row),
        "r"(smem_u32(bar))
        : "memory");
}

// Keeps the compiler from touching r across the asm around it (an
// accumulator is only final after wgmma_wait).
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(r[x])::"memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (4 f32 of an m16n8 C fragment) += a (m16k16, row) b (k16n8, col).
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, f32 += bf16 x bf16, scale-d 1: ss with A and B K-major
// in shared memory (S = Q K^T, N = BLK), rs with A in registers and B
// MN-major in shared memory (O += P V, N = D).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ static __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ static __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Head dim 192 (nemotron-4): only the PV product has N = D; S = Q K^T keeps
// N = BLK and takes 12 k16 steps over the three 128-byte atoms of a row.
template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The Q fragments of this warp's 16 rows (mma.sync path), for the row walk.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4],
                                       const unsigned char* sq) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const int row = 16 * (threadIdx.x >> 5) + 8 * (mat & 1) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], smem_u32(sq) + chunk_off<D>(row, 2 * kk + (mat >> 1)));
}

// S = Q K^T of this thread's rows against the tile's BLK keys, f32.
template <int BLK, int D>
__device__ __forceinline__ void scores(float (&s)[BLK / 2],
                                       const unsigned char* sq,
                                       const unsigned char* sk,
                                       const uint32_t (&qf)[D / 16][4]) {
#pragma unroll
  for (int x = 0; x < BLK / 2; ++x) s[x] = 0.f;
  if constexpr (Shape<BLK, D>::WGMMA) {
    // K-major, swizzled: a step is 16 columns (32 bytes) of one atom
    using Sh = Shape<BLK, D>;
    constexpr int SW = Sh::SW;
    const int wg = threadIdx.x >> 7;
    const uint32_t q0 = smem_u32(sq) + wg * 64 * SW, k0 = smem_u32(sk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (32 * kk / SW) * BLK * SW + (32 * kk) % SW;
      Wgmma<BLK>::ss(s, desc(q0 + off, 16, 8 * SW, Sh::SWIZZLE),
                     desc(k0 + off, 16, 8 * SW, Sh::SWIZZLE));
    }
    wgmma_commit();
    wgmma_wait();
    hold(s);
  } else {
    const int lane = threadIdx.x & 31, mat = lane >> 3;
    const uint32_t base = smem_u32(sk);
#pragma unroll
    for (int nc = 0; nc < BLK / 8; nc += 2)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, base + chunk_off<D>(8 * (nc + (mat >> 1)) + (lane & 7),
                                       2 * kk + (mat & 1)));
        mma16816(&s[4 * nc], qf[kk], b[0], b[1]);
        mma16816(&s[4 * nc + 4], qf[kk], b[2], b[3]);
      }
  }
}

// The reference's token mask: query position qp attends key position kp.
__device__ __forceinline__ bool keep_pair(int qp, int kp, int win_eff,
                                          int pre) {
  return (kp <= qp && qp - kp < win_eff) || kp < pre;
}

// No pair of the rows x rows block at query positions [qp0, qp0 + rows)
// and key positions [kp0, kp0 + rows) is masked: below the diagonal and
// inside the window, or wholly inside the prefix.
__device__ __forceinline__ bool block_inside(int qp0, int kp0, int rows,
                                             int win_eff, int pre) {
  return (kp0 + rows - 1 <= qp0 && qp0 + rows - 1 - kp0 < win_eff) ||
         kp0 + rows <= pre;
}

// An f32 C fragment over COLS columns as bf16 A fragments of 16 columns.
template <int COLS>
__device__ __forceinline__ void repack(const float (&c)[COLS / 2],
                                       uint32_t (&a)[COLS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < COLS / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// Scale, mask and online softmax of one tile's scores in place (s becomes
// p), O rescaled by alpha, P packed into bf16 A fragments (16 keys each).
// qrow / kcol: token positions of row g and of column 2 (lane % 4) of the
// tile; full: block_inside (the mask is skipped).
template <int BLK, int D>
__device__ __forceinline__ void softmax(float (&s)[BLK / 2],
                                        float (&o)[D / 2],
                                        uint32_t (&p)[BLK / 16][4], Rows& st,
                                        int qrow, int kcol, bool full,
                                        int win_eff, int pre, float scale) {
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int c = 0; c < BLK / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * c + e] * scale;
      if (!full && !keep_pair(qrow + 8 * (e >> 1), kcol + 8 * c + (e & 1),
                              win_eff, pre))
        x = MASK_VALUE;
      s[4 * c + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = exp2f((st.m[r] - mx[r]) * LOG2E);
    st.m[r] = mx[r];
  }
#pragma unroll
  for (int x = 0; x < BLK / 2; ++x) {
    const float pv = exp2f((s[x] - mx[(x >> 1) & 1]) * LOG2E);
    s[x] = pv;
    sum[(x >> 1) & 1] += pv;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
  repack<BLK>(s, p);
}

// O += P V over the tile's BLK keys.
template <int BLK, int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 2],
                                              const uint32_t (&p)[BLK / 16][4],
                                              const unsigned char* sv) {
  if constexpr (Shape<BLK, D>::WGMMA) {
    // MN-major V, swizzled: atoms BLK SW bytes apart along D, a step is 16
    // keys (rows)
    using Sh = Shape<BLK, D>;
    constexpr int SW = Sh::SW;
    const uint64_t dv = desc(smem_u32(sv), BLK * SW, 8 * SW, Sh::SWIZZLE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLK / 16; ++kk)
      Wgmma<D>::rs(o, p[kk], dv + ((16 * SW * kk) >> 4));
    wgmma_commit();
    wgmma_wait();
    hold(o);
  } else {
    const int lane = threadIdx.x & 31, mat = lane >> 3;
    const uint32_t base = smem_u32(sv);
#pragma unroll
    for (int kk = 0; kk < BLK / 16; ++kk)
#pragma unroll
      for (int dc = 0; dc < D / 8; dc += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, base + chunk_off<D>(16 * kk + 8 * (mat & 1) + (lane & 7),
                                         dc + (mat >> 1)));
        mma16816(&o[4 * dc], p[kk], b[0], b[1]);
        mma16816(&o[4 * dc + 4], p[kk], b[2], b[3]);
      }
  }
}

// l of this thread's two rows, summed over the quad.
__device__ __forceinline__ void reduce_l(Rows& st) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
  }
}

// Out's BLK rows from the bf16 staging (row stride OS) to rows
// [q0, q0 + BLK) of the (S, D) plane oh, 16 bytes a store.
template <int BLK, int D>
__device__ __forceinline__ void copy_out(const bf16* so, bf16* __restrict__ oh,
                                         int q0) {
  constexpr int OS = Shape<BLK, D>::OS;
  __syncthreads();
  for (int e = threadIdx.x; e < BLK * D / 8; e += 2 * BLK) {
    const int row = e / (D / 8), c = e % (D / 8);
    *reinterpret_cast<uint4*>(oh + static_cast<size_t>(q0 + row) * D + 8 * c) =
        *reinterpret_cast<const uint4*>(so + row * OS + 8 * c);
  }
}

// out = O / l in bf16 through the staging at stage, and, where lh is not
// null, lse = m + log(l).
template <int BLK, int D>
__device__ __forceinline__ void store_out(const float (&o)[D / 2], Rows st,
                                          unsigned char* stage,
                                          bf16* __restrict__ oh,
                                          float* __restrict__ lh, int q0) {
  constexpr int OS = Shape<BLK, D>::OS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;
  bf16* so = reinterpret_cast<bf16*>(stage);
  reduce_l(st);
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(so + (row + 8 * r) * OS + 8 * c +
                                         2 * t) =
          __floats2bfloat162_rn(o[4 * c + 2 * r] / st.l[r],
                                o[4 * c + 2 * r + 1] / st.l[r]);
  if (t == 0 && lh != nullptr)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lh[q0 + row + 8 * r] = st.m[r] + logf(st.l[r]);
  copy_out<BLK, D>(so, oh, q0);
}

// Where a body's tiles come from: on the wgmma path TMA through the tensor
// maps (rows of (rows, D) bf16 tensors: q, k, v flattened over batch and
// head) from row offsets q_row / kv_row; on the mma.sync path cp.async
// from the (S, D) planes qh / kh / vh.
struct Src {
  const CUtensorMap *tq, *tk, *tv;
  int q_row, kv_row;
  const bf16 *qh, *kh, *vh;
};

// One forward accumulator owner, a block of NT threads: q-row tile i of a
// member whose tiles start at tile row row0 (0 for tri_fwd's one request)
// walks the member-local lambdas of its row through member_map_params in
// the reference's order. Q is read at tile row row0 + i, K and V at
// row0 + tj; the token mask is member-local, (ti, tj), the reference's
// _packed_token_mask. Q stays in shared memory (and, on the mma.sync path,
// in registers); K/V go through a ring of STAGES stages, the copies of the
// next STAGES - 1 tiles in flight while this tile's products run. oh
// points at this head's (S, D) out plane, lh at its (S,) log-sum-exp row
// or is null (the fused step writes no lse).
template <int BLK, int D>
__device__ __forceinline__ void row_tile(const Src& src, bf16* __restrict__ oh,
                                         float* __restrict__ lh, int row0,
                                         int i, int n_r, int w_r, int p_r,
                                         int win, int pre, float scale,
                                         unsigned char* smem) {
  using Sh = Shape<BLK, D>;
  constexpr int NT = Sh::NT, TILE = Sh::TILE, ST = Sh::STAGES;
  unsigned char* sq = smem;
  unsigned char* ring = smem + TILE;  // stage s: K at 2 s TILE, V after it
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + 2 * ST * TILE);
  uint64_t* full = bar_q + 1;  // one a stage
  const int win_eff = win > 0 ? win : (1 << 30);
  const int steps = last_col_params(i, p_r) - first_col_params(i, w_r) + 1;
  const int lam0 = segment_origin_params(i, w_r, p_r);
  const int lane = threadIdx.x & 31;
  const int rw = 16 * (threadIdx.x >> 5) + (lane >> 2);
  // tile s of the row into stage s % ST: by one thread through TMA, or by
  // all through cp.async (one commit group a tile, empty past the row)
  auto load_kv = [&](int s) {
    if constexpr (Sh::WGMMA) {
      if (threadIdx.x != 0 || s >= steps) return;
    }
    if (s < steps) {
      int ti, tj;
      member_map_params(lam0 + s, n_r, w_r, p_r, &ti, &tj);
      unsigned char* dst = ring + (s % ST) * 2 * TILE;
      const int row = (row0 + tj) * BLK;
      if constexpr (Sh::WGMMA) {
        mbar_expect(full + s % ST, 2 * TILE);
        tma_tile<BLK, D>(dst, src.tk, src.kv_row + row, full + s % ST);
        tma_tile<BLK, D>(dst + TILE, src.tv, src.kv_row + row, full + s % ST);
      } else {
        load_rows_async<BLK, D, NT>(dst, src.kh, row);
        load_rows_async<BLK, D, NT>(dst + TILE, src.vh, row);
      }
    }
    if constexpr (!Sh::WGMMA) cp_async_commit();
  };

  if constexpr (Sh::WGMMA) {
    if (threadIdx.x == 0) {
      mbar_init(bar_q);
#pragma unroll
      for (int x = 0; x < ST; ++x) mbar_init(full + x);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect(bar_q, TILE);
      tma_tile<BLK, D>(sq, src.tq, src.q_row + (row0 + i) * BLK, bar_q);
    }
  } else {
    load_rows_async<BLK, D, NT>(sq, src.qh, (row0 + i) * BLK);
  }
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load_kv(s);

  Rows st = {{MASK_VALUE, MASK_VALUE}, {0.f, 0.f}};
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  uint32_t qf[D / 16][4];
  for (int s = 0; s < steps; ++s) {
    load_kv(s + ST - 1);
    if constexpr (Sh::WGMMA) {
      if (s == 0) mbar_wait(bar_q, 0);
      mbar_wait(full + s % ST, (s / ST) & 1);
    } else {
      cp_async_wait<ST - 1>();
      __syncthreads();
      if (s == 0) load_q<D>(qf, sq);
    }
    int ti, tj;
    member_map_params(lam0 + s, n_r, w_r, p_r, &ti, &tj);
    const unsigned char* sk = ring + (s % ST) * 2 * TILE;
    float sc[BLK / 2];
    uint32_t p[BLK / 16][4];
    scores<BLK, D>(sc, sq, sk, qf);
    softmax<BLK, D>(sc, o, p, st, ti * BLK + rw, tj * BLK + 2 * (lane & 3),
                    block_inside(ti * BLK, tj * BLK, BLK, win_eff, pre),
                    win_eff, pre,
                    scale);
    accumulate_pv<BLK, D>(o, p, sk + TILE);
    __syncthreads();  // this stage is refilled at step s + 1
  }
  store_out<BLK, D>(o, st, ring, oh, lh, (row0 + i) * BLK);
}

// One live tile (i, j) of fwd_bb: its softmax partial (O, m, l in f32, the
// token mask applied) at part: O row-major (BLK x D), then m, then l of the
// BLK rows, 16 bytes a store (lanes 2t and 2t + 1 swap halves, so each
// holds four consecutive columns of one row).
template <int BLK, int D>
__device__ __forceinline__ void bb_partial(const Src& src, int i, int j,
                                           int win_eff, float scale,
                                           unsigned char* smem,
                                           float* __restrict__ part) {
  using Sh = Shape<BLK, D>;
  constexpr int NT = Sh::NT, TILE = Sh::TILE;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int rw = 16 * (threadIdx.x >> 5) + (lane >> 2);
  uint32_t qf[D / 16][4];
  if constexpr (Sh::WGMMA) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 3 * TILE + 8);
    if (threadIdx.x == 0) {
      mbar_init(bar);
      mbar_expect(bar, 3 * TILE);
      tma_tile<BLK, D>(smem, src.tq, src.q_row + i * BLK, bar);
      tma_tile<BLK, D>(smem + TILE, src.tk, src.kv_row + j * BLK, bar);
      tma_tile<BLK, D>(smem + 2 * TILE, src.tv, src.kv_row + j * BLK, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    mbar_wait(bar, 0);
  } else {
    load_rows_async<BLK, D, NT>(smem, src.qh, i * BLK);
    load_rows_async<BLK, D, NT>(smem + TILE, src.kh, j * BLK);
    load_rows_async<BLK, D, NT>(smem + 2 * TILE, src.vh, j * BLK);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    load_q<D>(qf, smem);
  }
  Rows st = {{MASK_VALUE, MASK_VALUE}, {0.f, 0.f}};
  float o[D / 2], sc[BLK / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  uint32_t p[BLK / 16][4];
  scores<BLK, D>(sc, smem, smem + TILE, qf);
  softmax<BLK, D>(sc, o, p, st, i * BLK + rw, j * BLK + 2 * t,
                  block_inside(i * BLK, j * BLK, BLK, win_eff, 0), win_eff,
                  0, scale);
  accumulate_pv<BLK, D>(o, p, smem + 2 * TILE);
  reduce_l(st);

  const bool odd = t & 1;
  const int row = rw + (odd ? 8 : 0), col = 4 * (t >> 1);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float* x = o + 4 * c;
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? x[0] : x[2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? x[1] : x[3], 1);
    float4 w;
    w.x = odd ? r0 : x[0];
    w.y = odd ? r1 : x[1];
    w.z = odd ? x[2] : r0;
    w.w = odd ? x[3] : r1;
    *reinterpret_cast<float4*>(part + row * D + 8 * c + col) = w;
  }
  if (t < 2) {
    part[BLK * D + row] = st.m[t];
    part[BLK * D + BLK + row] = st.l[t];
  }
}

// The merge of fwd_bb's row tile i: the count = i + 1 partials from
// row_part in ascending j (the reference's grid order), read through L2
// with 16-byte __ldcg (other blocks wrote them in this launch); each thread
// keeps the running (M, L) of one row and four columns of every 8, then
// writes out through the staging at smem and lse.
template <int BLK, int D>
__device__ __forceinline__ void bb_merge(const float* row_part, int count,
                                         unsigned char* smem,
                                         bf16* __restrict__ oh,
                                         float* __restrict__ lh, int q0) {
  constexpr int PART = BLK * D + 2 * BLK, OS = Shape<BLK, D>::OS;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2) + (t & 1) * 8;
  const int col = 4 * (t >> 1);
  float4 acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = MASK_VALUE, l_run = 0.f;
  for (int jj = 0; jj < count; ++jj) {
    const float* p = row_part + static_cast<size_t>(jj) * PART;
    const float m_j = __ldcg(p + BLK * D + row);
    const float l_j = __ldcg(p + BLK * D + BLK + row);
    const float m_new = fmaxf(m_run, m_j);
    const float w_run = expf(m_run - m_new), w_j = expf(m_j - m_new);
    l_run = l_run * w_run + l_j * w_j;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(p + row * D + 8 * c + col));
      acc[c].x = acc[c].x * w_run + a.x * w_j;
      acc[c].y = acc[c].y * w_run + a.y * w_j;
      acc[c].z = acc[c].z * w_run + a.z * w_j;
      acc[c].w = acc[c].w * w_run + a.w * w_j;
    }
  }
  bf16* so = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(so + row * OS + 8 * c + col);
    dst[0] = __floats2bfloat162_rn(acc[c].x / l_run, acc[c].y / l_run);
    dst[1] = __floats2bfloat162_rn(acc[c].z / l_run, acc[c].w / l_run);
  }
  if (t < 2) lh[q0 + row] = m_run + logf(l_run);
  copy_out<BLK, D>(so, oh, q0);
}


// Host side: the TMA map of a (rows, D) bf16 tensor at base, in boxes of
// SW / 2 columns x BLK rows swizzled over SW bytes (tma_tile).
// cuTensorMapEncodeTiled comes from the driver through the runtime, so
// nothing links libcuda.
inline int make_tmap(CUtensorMap* map, const void* base, long long rows, int D,
                     int BLK, int SW) {
  static decltype(&cuTensorMapEncodeTiled) encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(SW / 2),
                             static_cast<cuuint32_t>(BLK)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                 : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The maps of q (B H S rows) and k, v (B Hkv S rows) on the wgmma path;
// left zero (unused) on the mma.sync path.
template <int BLK, int D>
inline int make_tmaps(CUtensorMap (&maps)[3], const void* q, const void* k,
                      const void* v, int B, int H, int Hkv, int S) {
  if constexpr (Shape<BLK, D>::WGMMA) {
    constexpr int SW = Shape<BLK, D>::SW;
    const long long kv_rows = static_cast<long long>(B) * Hkv * S;
    if (int err = make_tmap(&maps[0], q, static_cast<long long>(B) * H * S, D,
                            BLK, SW))
      return err;
    if (int err = make_tmap(&maps[1], k, kv_rows, D, BLK, SW)) return err;
    return make_tmap(&maps[2], v, kv_rows, D, BLK, SW);
  }
  return 0;
}

}  // namespace tc
}  // namespace tri
