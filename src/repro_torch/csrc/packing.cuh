// Device forms of the block-space maps (core/mapping.py) and the packed
// member-table primitives (core/packing.py). Integer semantics match the
// reference's traced int32 forms: a correctly rounded float32 sqrt (no
// fast-math: nvcc's default -prec-sqrt=true emits sqrt.rn.f32) followed
// by overflow-clamped probes, exact for lam <= LTM_TRACED_MAX_LAM; the
// tetrahedral tet_map takes cbrtf (1 ulp without fast-math) and two
// clamped probes each way, exact for lam <= TET_TRACED_MAX_LAM. Last, the
// host side every C entry shares: the shared-memory limit, the dtype
// dispatch and the opt-in above the 48 KB default.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tri {

constexpr int ISQRT_MAX_R = 46340;          // floor(sqrt(INT32_MAX))
constexpr int DECODE_NO_EMIT = 1 << 30;     // pad-member kv_tiles sentinel
constexpr float MASK_VALUE = -0.7f * 3.40282346638528859812e+38f;

__device__ __forceinline__ int tri_n(int n) { return (n * (n + 1)) / 2; }

__device__ __forceinline__ int isqrt_i32(int x) {
  int r = static_cast<int>(floorf(sqrtf(static_cast<float>(x))));
  r = min(r, ISQRT_MAX_R);
  const int up = min(r + 1, ISQRT_MAX_R);
  if (up * up <= x && up == r + 1) r += 1;
  if (r * r > x) r -= 1;
  return r;
}

// g(lambda): lower triangle, row-major, diagonal included.
__device__ __forceinline__ void ltm_map(int lam, int* i, int* j) {
  const int r = (isqrt_i32(8 * lam + 1) - 1) / 2;
  *i = r;
  *j = lam - tri_n(r);
}

constexpr int TET_MAX_I = 1624;  // TET_TRACED_MAX_I: tri(i) * (i + 2) < 2^31
constexpr int TET_PROBES = 2;    // TET_PROBES_UP == TET_PROBES_DOWN

// T3(i) = i(i+1)(i+2)/6 in int32, exact for i <= TET_MAX_I.
__device__ __forceinline__ int tet_n(int i) { return (tri_n(i) * (i + 2)) / 3; }

// lambda -> (i, j, k), k <= j <= i, plane-major: the plane i is the floor
// of cbrtf(6 lam) repaired by clamped probes (the candidate lies within
// [-1, +2] of it), then (j, k) = g(lam - tet(i)).
__device__ __forceinline__ void tet_map(int lam, int* i, int* j, int* k) {
  int c = static_cast<int>(floorf(cbrtf(6.0f * static_cast<float>(lam))));
#pragma unroll
  for (int t = 0; t < TET_PROBES; ++t)
    if (tet_n(min(c + 1, TET_MAX_I)) <= lam) c += 1;
#pragma unroll
  for (int t = 0; t < TET_PROBES; ++t)
    if (tet_n(min(c, TET_MAX_I)) > lam) c -= 1;
  c = min(c, TET_MAX_I - 1);
  *i = c;
  ltm_map(lam - tet_n(c), j, k);
}

// Banded lower triangle of width w tiles: triangular head, then rows of w.
__device__ __forceinline__ void band_map(int lam, int w, int* i, int* j) {
  const int head = tri_n(w - 1);
  if (lam < head) {
    ltm_map(lam, i, j);
    return;
  }
  const int q = (lam - head) / w;
  const int c = (lam - head) - q * w;
  *i = (w - 1) + q;
  *j = *i - (w - 1) + c;
}

// {(i, j): j <= i or j < p}: rows below p are p wide, later rows i + 1.
__device__ __forceinline__ void prefix_full_map(int lam, int n, int p,
                                                int* i, int* j) {
  (void)n;
  const int head = p * p;
  if (lam < head) {
    *i = lam / p;
    *j = lam % p;
    return;
  }
  const int rem = lam - head + tri_n(p);
  const int r = (isqrt_i32(8 * rem + 1) - 1) / 2;
  *i = r;
  *j = rem - tri_n(r);
}

// Member-local lambda -> (i, j) from the normalized (n, w, p) parameters
// (band family when p == 0, prefix family otherwise).
__device__ __forceinline__ void member_map_params(int local, int n, int w,
                                                  int p, int* i, int* j) {
  if (p > 0) {
    prefix_full_map(local, n, p, i, j);
  } else {
    band_map(local, w, i, j);
  }
}

// Largest r with starts[r] <= lam: the reference's fixed-trip binary
// search (bit_length(R - 1) probes).
__device__ __forceinline__ int request_from_starts(int lam, const int* starts,
                                                   int num_requests) {
  int lo = 0, hi = num_requests - 1;
  const int trips = num_requests > 1 ? 32 - __clz(num_requests - 1) : 0;
  for (int t = 0; t < trips; ++t) {
    const int mid = (lo + hi + 1) / 2;
    if (starts[mid] <= lam) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ int first_col_params(int i, int w) {
  return max(0, i - w + 1);
}

__device__ __forceinline__ int last_col_params(int i, int p) {
  return max(i, p - 1);
}

// Column bounds of the column-major walk (dk/dv): prefix columns < p span
// every row, others start on the diagonal; band columns end w - 1 rows
// below it (w == n unbanded, so n - 1).
__device__ __forceinline__ int cm_first_row_params(int j, int p) {
  return j < p ? 0 : j;
}

__device__ __forceinline__ int cm_last_row_params(int j, int n, int w) {
  return min(j + w - 1, n - 1);
}

// Member-local lambda of the first tile of row i (both families).
__device__ __forceinline__ int segment_origin_params(int i, int w, int p) {
  if (p > 0) return i < p ? i * p : p * p + tri_n(i) - tri_n(p);
  return i < w - 1 ? tri_n(i) : tri_n(w - 1) + (i - (w - 1)) * w;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes global -> shared by cp.async, completing in the thread's
// current group; cp_async_wait<N> waits until at most N of the thread's
// groups are still in flight.
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

// True when every pointer lies on a 16-byte boundary (cp.async's).
template <typename... P>
inline bool aligned16(const P*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

// Shared memory a block may take on sm_90 (SMEM_LIMIT in kernels/build.py).
constexpr int SMEM_LIMIT = 227 * 1024;

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls f(TypeTag<T>) for dtype 0 (float32) / 1 (bfloat16).
template <typename F>
inline int dispatch_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(TypeTag<float>{});
  if (dtype == 1) return f(TypeTag<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Opts kern in to `bytes` of dynamic shared memory above the 48 KB default.
template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace tri
