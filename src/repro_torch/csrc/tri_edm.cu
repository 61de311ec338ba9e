// The paper's Euclidean-distance-map experiment for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/tri_edm/kernel.py:
//   edm_ltm   (_ltm_kernel)   -> edm_ltm_launch: grid tri(n), one block per
//             lower-triangle tile; block lambda = blockIdx.x maps itself to
//             (i, j) through the device g(lambda) (tri::ltm_map,
//             packing.cuh) and writes tile lambda of the packed
//             (tri(n), b, b) f32 output. This is the paper's LTM mapping,
//             literally: the tiles are independent, so nothing orders the
//             blocks.
//   edm_bb    (_bb_kernel)    -> edm_bb_launch: grid (n, n), the paper's
//             bounding box. A block with j > i is discarded by its block
//             coordinates: it writes its zero tile of the full (N, N)
//             output, as the reference does, and loads nothing. The others
//             run the same tile body as edm_ltm.
//   dummy_ltm (_dummy_kernel) -> dummy_ltm_launch: grid tri(n), one warp a
//             block; lane 0 maps lambda -> (i, j) and writes i + j. It
//             measures the card's cost of the mapping alone (the paper's
//             tau / beta).
//
// Tile body. The block loads X_i and X_j (b x d, cast to f32) feature-major
// into shared memory and takes the row norms; each thread then keeps one
// column's features and norm in registers and writes
// d^2 = max(sq_i + sq_j - 2 <x_i, x_j>, 0) (sqrt unless `squared`) down its
// column, so that a warp stores neighbouring columns of one row. Products
// and sums are rounded one at a time (__fmul_rn / __fadd_rn: no
// contraction into FMAs, no TF32), so the plain PyTorch version, which sums
// the same products in the same order, gives the same bits. The
// self-distance on the diagonal of a diagonal tile is exactly 0. b (8, 16,
// 32, 64 or 128) and the paper's d of 1 to 4 are template parameters, so
// the index arithmetic is shifts and the feature loop unrolls; a larger d
// runs the same body with d read at run time.
//
// Bound on this card. At d <= 4 a tile does ~3 d b^2 flops against b^2
// stored floats, so both EDM kernels are bound by the bytes they write:
// LTM tri(n) b^2 floats, BB N^2 (the reference's function: its upper
// tiles are zeros it must store). At N = 65536, b = 64 that is 8.6 GB and
// 17.2 GB. Every output offset is computed in size_t: both exceed 2^31
// elements there. Build without --use_fast_math: ltm_map's isqrt relies on
// the correctly rounded sqrtf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "packing.cuh"

namespace {

constexpr int NT = 256;

// One EDM tile: rows [i*BLK, (i+1)*BLK) against rows [j*BLK, (j+1)*BLK) of
// x (N, d), written to out with row stride ld. DF is d when it is 1..4 (the
// paper's features, held in registers), 0 for a runtime d read from shared
// memory. Thread t owns column c = t % BLK and rows t / BLK + k NT / BLK,
// so a warp stores consecutive columns of one row and reads its row's
// features as one broadcast.
template <typename T, int BLK, int DF>
__device__ __forceinline__ void edm_tile(const T* __restrict__ x, int d,
                                         int i, int j, int squared,
                                         float* __restrict__ out, size_t ld,
                                         float* smem) {
  constexpr int RSTEP = NT / BLK;
  const int dd = DF > 0 ? DF : d;
  float* xi = smem;  // d x BLK, feature-major
  float* xj = xi + dd * BLK;
  float* sqi = xj + dd * BLK;
  float* sqj = sqi + BLK;
  const size_t ri = static_cast<size_t>(i) * BLK, rj = static_cast<size_t>(j) * BLK;
  for (int e = threadIdx.x; e < BLK * dd; e += NT) {
    const int r = e / dd, k = e - r * dd;
    xi[k * BLK + r] = tri::to_f32(x[(ri + r) * dd + k]);
    xj[k * BLK + r] = tri::to_f32(x[(rj + r) * dd + k]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BLK; r += NT) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < dd; ++k) {
      a = __fadd_rn(a, __fmul_rn(xi[k * BLK + r], xi[k * BLK + r]));
      b = __fadd_rn(b, __fmul_rn(xj[k * BLK + r], xj[k * BLK + r]));
    }
    sqi[r] = a;
    sqj[r] = b;
  }
  __syncthreads();
  const int c = threadIdx.x % BLK;
  float xc[DF > 0 ? DF : 1];
#pragma unroll
  for (int k = 0; k < DF; ++k) xc[k] = xj[k * BLK + c];
  const float sqc = sqj[c];
  for (int r = threadIdx.x / BLK; r < BLK; r += RSTEP) {
    float dot = 0.f;
    if constexpr (DF > 0) {
#pragma unroll
      for (int k = 0; k < DF; ++k) dot = __fadd_rn(dot, __fmul_rn(xi[k * BLK + r], xc[k]));
    } else {
      for (int k = 0; k < dd; ++k)
        dot = __fadd_rn(dot, __fmul_rn(xi[k * BLK + r], xj[k * BLK + c]));
    }
    float d2 = fmaxf(__fsub_rn(__fadd_rn(sqi[r], sqc), 2.f * dot), 0.f);
    if (i == j && r == c) d2 = 0.f;
    out[static_cast<size_t>(r) * ld + c] = squared ? d2 : sqrtf(d2);
  }
}

template <typename T, int BLK, int DF>
__global__ void __launch_bounds__(NT)
edm_ltm_kernel(const T* __restrict__ x, float* __restrict__ out, int d,
               int squared) {
  extern __shared__ float smem[];
  int i, j;
  tri::ltm_map(static_cast<int>(blockIdx.x), &i, &j);
  edm_tile<T, BLK, DF>(x, d, i, j, squared,
                       out + static_cast<size_t>(blockIdx.x) * BLK * BLK, BLK,
                       smem);
}

template <typename T, int BLK, int DF>
__global__ void __launch_bounds__(NT)
edm_bb_kernel(const T* __restrict__ x, float* __restrict__ out, int N, int d,
              int squared) {
  extern __shared__ float smem[];
  const int j = blockIdx.x, i = blockIdx.y;
  float* tile = out + static_cast<size_t>(i) * BLK * N + static_cast<size_t>(j) * BLK;
  if (j > i) {  // the paper's BB guard, by block coordinates
    const int c = threadIdx.x % BLK;
    for (int r = threadIdx.x / BLK; r < BLK; r += NT / BLK)
      tile[static_cast<size_t>(r) * N + c] = 0.f;
    return;
  }
  edm_tile<T, BLK, DF>(x, d, i, j, squared, tile, static_cast<size_t>(N), smem);
}

__global__ void dummy_ltm_kernel(float* __restrict__ out) {
  if (threadIdx.x == 0) {
    int i, j;
    tri::ltm_map(static_cast<int>(blockIdx.x), &i, &j);
    out[blockIdx.x] = static_cast<float>(i + j);
  }
}

inline size_t tile_smem(int d, int blk) {
  return sizeof(float) * (2 * static_cast<size_t>(d) * blk + 2 * static_cast<size_t>(blk));
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls f(TypeTag<T>, BLK, DF) with BLK and DF as std::integral_constant
// for dtype 0 (float32) / 1 (bfloat16), blk in 8..128, DF = d for d <= 4
// and 0 (runtime d) above.
template <typename F>
int dispatch_edm(int dtype, int blk, int d, F&& f) {
  auto by_d = [&](auto t, auto b) -> int {
    switch (d) {
      case 1: return f(t, b, std::integral_constant<int, 1>{});
      case 2: return f(t, b, std::integral_constant<int, 2>{});
      case 3: return f(t, b, std::integral_constant<int, 3>{});
      case 4: return f(t, b, std::integral_constant<int, 4>{});
      default: return f(t, b, std::integral_constant<int, 0>{});
    }
  };
  auto by_blk = [&](auto t) -> int {
    switch (blk) {
      case 8: return by_d(t, std::integral_constant<int, 8>{});
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

template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// x: (N, d) row-major, dtype 0 = float32, 1 = bfloat16; N a multiple of
// blk. out: packed (tri(N / blk), blk, blk) f32.
extern "C" int edm_ltm_launch(const void* x, void* out, int N, int d, int blk,
                              int squared, int dtype, void* stream) {
  return dispatch_edm(dtype, blk, d, [&](auto t, auto blk_c, auto df_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DF = decltype(df_c)::value;
    const int n = N / BLK;
    const long long tiles = static_cast<long long>(n) * (n + 1) / 2;
    const size_t bytes = tile_smem(d, BLK);
    auto kern = edm_ltm_kernel<T, BLK, DF>;
    if (int err = set_smem(kern, bytes)) return err;
    kern<<<static_cast<unsigned>(tiles), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(out), d, squared);
    return static_cast<int>(cudaGetLastError());
  });
}

// The same over the n x n grid; out: full (N, N) f32, zeros where j > i.
extern "C" int edm_bb_launch(const void* x, void* out, int N, int d, int blk,
                             int squared, int dtype, void* stream) {
  return dispatch_edm(dtype, blk, d, [&](auto t, auto blk_c, auto df_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DF = decltype(df_c)::value;
    const int n = N / BLK;
    const size_t bytes = tile_smem(d, BLK);
    auto kern = edm_bb_kernel<T, BLK, DF>;
    if (int err = set_smem(kern, bytes)) return err;
    kern<<<dim3(n, n), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(out), N, d, squared);
    return static_cast<int>(cudaGetLastError());
  });
}

// out: (tri(n), 1) f32, i + j of every lambda.
extern "C" int dummy_ltm_launch(void* out, int n, void* stream) {
  const long long tiles = static_cast<long long>(n) * (n + 1) / 2;
  dummy_ltm_kernel<<<static_cast<unsigned>(tiles), 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
