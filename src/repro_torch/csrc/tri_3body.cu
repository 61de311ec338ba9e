// The 3-body triplet reduction over the tetrahedron for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/tri_3body/kernel.py:
//   three_body_tet (_tet_kernel, _triplet_tile, _strict_masks)
//             -> three_body_tet_launch: grid tet(n), one block per unique
//             tile triple k <= j <= i; block lambda = blockIdx.x maps
//             itself to (i, j, k) through the device tet_map (packing.cuh:
//             cbrtf and clamped integer probes) and writes out[lambda] of
//             the packed (tet(n), 1) f32 output. The tiles are independent,
//             so nothing orders the blocks.
//   three_body_bb3 (_bb3_kernel) -> three_body_bb3_launch: grid (n, n, n),
//             blockIdx = (k, j, i), the 3-D bounding box. A block outside
//             the simplex (not k <= j <= i) writes its zero and loads
//             nothing; the others run the same tile body as
//             three_body_tet, so their values are its bits.
//   dummy_tet (_dummy_kernel) -> dummy_tet_launch: grid tet(n), one warp a
//             block; lane 0 maps lambda -> (i, j, k) and writes i + j + k
//             (exact in f32: at most 3 * 1623). The cost of the map alone.
//
// Tile body (b = BLK rows a tile, d features; x f32 or bf16, cast to f32
// on load): with A = Xi Xj^T, B = Xj Xk^T, C = Xi Xk^T,
//   s = sum_{a, c} (A B)[a, c] * C[a, c];
// strict masks A to a > b and B to b > c over global point indices (only
// diagonal tiles change). The block stages Xi, Xj, Xk feature-major in
// shared memory, builds A^T and B there (masked), then each of the 256
// threads (16 x 16) owns an 8 x 8 (BLK 128) or 4 x 4 (BLK 64) register
// tile of (a, c): rows ty * 4 + 64 g + e, columns tx * 4 + 64 g + e, read
// as float4s from shared memory. It accumulates (A B) over b, then C over
// the features, multiplies and sums its entries; the warps' sums meet in
// a fixed tree (shuffles, then warp 0..7 in order), so two runs give the
// same bits. Every multiply-add is an explicit fmaf.
//
// Bound on this card. A tile does 2 b^3 + 6 b^2 d flops against (3 b d)
// inputs and one output, so the kernels are bound by f32 operations on
// the CUDA cores (67 TFLOP/s): live tiles only, tet(n) of them for both.
// Shared memory: 3 b d + 2 b^2 floats, 224 KB at b 128, d 64, so one
// block an SM; the register tiling keeps 4 FMAs per shared-memory float
// read. No tensor cores yet (wgmma is a later step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "packing.cuh"

namespace {

constexpr int NT = 256;  // 16 x 16 threads

// acc[r][c] = sum_f u[f * BLK + row(r)] * v[f * BLK + col(c)] with
// row(g * 4 + e) = g * 64 + ty * 4 + e and col likewise from tx.
template <int BLK>
__device__ __forceinline__ void outer_acc(const float* __restrict__ u,
                                          const float* __restrict__ v, int len,
                                          int ty, int tx,
                                          float (&acc)[BLK / 16][BLK / 16]) {
  constexpr int G = BLK / 64, RM = BLK / 16;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RM; ++c) acc[r][c] = 0.f;
  for (int f = 0; f < len; ++f) {
    float uv[RM], vv[RM];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(u + f * BLK + g * 64 + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(v + f * BLK + g * 64 + tx * 4);
      uv[g * 4 + 0] = a.x; uv[g * 4 + 1] = a.y; uv[g * 4 + 2] = a.z; uv[g * 4 + 3] = a.w;
      vv[g * 4 + 0] = b.x; vv[g * 4 + 1] = b.y; vv[g * 4 + 2] = b.z; vv[g * 4 + 3] = b.w;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RM; ++c) acc[r][c] = fmaf(uv[r], vv[c], acc[r][c]);
  }
}

// Writes acc (rows row(r), columns col(c)) to dst[row * BLK + col]. With
// `strict`, an entry is kept only where its global indices are ordered:
// row_off + row > col_off + col when `row_greater`, the reverse otherwise.
template <int BLK>
__device__ __forceinline__ void store_masked(float* __restrict__ dst,
                                             const float (&acc)[BLK / 16][BLK / 16],
                                             int ty, int tx, int strict,
                                             int row_off, int col_off,
                                             bool row_greater) {
  constexpr int G = BLK / 64;
#pragma unroll
  for (int gr = 0; gr < G; ++gr)
#pragma unroll
    for (int er = 0; er < 4; ++er) {
      const int row = gr * 64 + ty * 4 + er;
#pragma unroll
      for (int gc = 0; gc < G; ++gc) {
        float o[4];
#pragma unroll
        for (int ec = 0; ec < 4; ++ec) {
          const int col = gc * 64 + tx * 4 + ec;
          const int gr_i = row_off + row, gc_i = col_off + col;
          const bool keep = !strict || (row_greater ? gr_i > gc_i : gc_i > gr_i);
          o[ec] = keep ? acc[gr * 4 + er][gc * 4 + ec] : 0.f;
        }
        *reinterpret_cast<float4*>(dst + row * BLK + gc * 64 + tx * 4) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
}

// s(i, j, k) of x (N, d); the result is valid in thread 0.
template <typename T, int BLK>
__device__ __forceinline__ float triplet_tile(const T* __restrict__ x, int d,
                                              int i, int j, int k, int strict,
                                              float* smem) {
  constexpr int RM = BLK / 16;
  float* xi = smem;  // d x BLK each, feature-major
  float* xj = xi + d * BLK;
  float* xk = xj + d * BLK;
  float* at = xk + d * BLK;  // at[b * BLK + a] = A[a][b]
  float* bm = at + BLK * BLK;  // bm[b * BLK + c] = B[b][c]
  float* red = bm + BLK * BLK;
  const size_t ri = static_cast<size_t>(i) * BLK, rj = static_cast<size_t>(j) * BLK,
               rk = static_cast<size_t>(k) * BLK;
  for (int e = threadIdx.x; e < BLK * d; e += NT) {
    const int r = e / d, f = e - r * d;
    xi[f * BLK + r] = tri::to_f32(x[(ri + r) * d + f]);
    xj[f * BLK + r] = tri::to_f32(x[(rj + r) * d + f]);
    xk[f * BLK + r] = tri::to_f32(x[(rk + r) * d + f]);
  }
  __syncthreads();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[RM][RM];
  // A^T: rows b of Xj, columns a of Xi; strict keeps i BLK + a > j BLK + b
  outer_acc<BLK>(xj, xi, d, ty, tx, acc);
  store_masked<BLK>(at, acc, ty, tx, strict, j * BLK, i * BLK, false);
  // B: rows b of Xj, columns c of Xk; strict keeps j BLK + b > k BLK + c
  outer_acc<BLK>(xj, xk, d, ty, tx, acc);
  store_masked<BLK>(bm, acc, ty, tx, strict, j * BLK, k * BLK, true);
  __syncthreads();
  outer_acc<BLK>(at, bm, BLK, ty, tx, acc);  // (A B)[a][c]
  float cc[RM][RM];
  outer_acc<BLK>(xi, xk, d, ty, tx, cc);  // C[a][c]
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RM; ++c) s = fmaf(acc[r][c], cc[r][c], s);
  s = tri::warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float tot = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) tot += red[w];
  return tot;
}

template <typename T, int BLK>
__global__ void __launch_bounds__(NT, 1)
three_body_tet_kernel(const T* __restrict__ x, float* __restrict__ out, int d,
                      int strict) {
  extern __shared__ float4 smem4[];
  int i, j, k;
  tri::tet_map(static_cast<int>(blockIdx.x), &i, &j, &k);
  const float s = triplet_tile<T, BLK>(x, d, i, j, k, strict,
                                       reinterpret_cast<float*>(smem4));
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T, int BLK>
__global__ void __launch_bounds__(NT, 1)
three_body_bb3_kernel(const T* __restrict__ x, float* __restrict__ out, int n,
                      int d, int strict) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x, j = blockIdx.y, i = blockIdx.z;
  const size_t cell = (static_cast<size_t>(i) * n + j) * n + k;
  if (!(k <= j && j <= i)) {  // the simplex guard, by block coordinates
    if (threadIdx.x == 0) out[cell] = 0.f;
    return;
  }
  const float s = triplet_tile<T, BLK>(x, d, i, j, k, strict,
                                       reinterpret_cast<float*>(smem4));
  if (threadIdx.x == 0) out[cell] = s;
}

__global__ void dummy_tet_kernel(float* __restrict__ out) {
  if (threadIdx.x == 0) {
    int i, j, k;
    tri::tet_map(static_cast<int>(blockIdx.x), &i, &j, &k);
    out[blockIdx.x] = static_cast<float>(i + j + k);
  }
}

inline size_t tile_smem(int d, int blk) {
  return sizeof(float) * (3 * static_cast<size_t>(d) * blk +
                          2 * static_cast<size_t>(blk) * blk + NT / 32);
}

// Calls f(TypeTag<T>, BLK) for dtype 0 (float32) / 1 (bfloat16) and blk
// 64 or 128 when the tile's shared memory fits.
template <typename F>
int dispatch_3body(int dtype, int blk, int d, F&& f) {
  if (d < 1 || tile_smem(d, blk) > static_cast<size_t>(tri::SMEM_LIMIT))
    return static_cast<int>(cudaErrorInvalidValue);
  auto by_blk = [&](auto t) -> int {
    switch (blk) {
      case 64: return f(t, std::integral_constant<int, 64>{});
      case 128: return f(t, std::integral_constant<int, 128>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  return tri::dispatch_dtype(dtype, by_blk);
}

}  // namespace

// x: (N, d) row-major, dtype 0 = float32, 1 = bfloat16; N a multiple of
// blk. out: packed (tet(N / blk), 1) f32.
extern "C" int three_body_tet_launch(const void* x, void* out, int N, int d,
                                     int blk, int strict, int dtype,
                                     void* stream) {
  return dispatch_3body(dtype, blk, d, [&](auto t, auto blk_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value;
    const long long n = N / BLK;
    const long long tiles = n * (n + 1) * (n + 2) / 6;
    const size_t bytes = tile_smem(d, BLK);
    auto kern = three_body_tet_kernel<T, BLK>;
    if (int err = tri::set_smem(kern, bytes)) return err;
    kern<<<static_cast<unsigned>(tiles), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(out), d, strict);
    return static_cast<int>(cudaGetLastError());
  });
}

// The same sums over the n x n x n grid; out: (n, n, n) f32, zeros outside
// the simplex.
extern "C" int three_body_bb3_launch(const void* x, void* out, int N, int d,
                                     int blk, int strict, int dtype,
                                     void* stream) {
  return dispatch_3body(dtype, blk, d, [&](auto t, auto blk_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value;
    const int n = N / BLK;
    const size_t bytes = tile_smem(d, BLK);
    auto kern = three_body_bb3_kernel<T, BLK>;
    if (int err = tri::set_smem(kern, bytes)) return err;
    kern<<<dim3(n, n, n), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(out), n, d, strict);
    return static_cast<int>(cudaGetLastError());
  });
}

// out: (tet(n), 1) f32, i + j + k of every lambda.
extern "C" int dummy_tet_launch(void* out, int n, void* stream) {
  const long long tiles = static_cast<long long>(n) * (n + 1) * (n + 2) / 6;
  dummy_tet_kernel<<<static_cast<unsigned>(tiles), 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
