// The paper's bounding-box baseline of the triangular attention forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:fwd_bb
// (_bb_fwd_kernel): flash attention of one request over the n x n tile
// grid with the paper's block guard j <= i (ltm, or band through the token
// mask; the reference's guard drops the above-diagonal tiles a
// prefix-causal row needs, so the wrapper refuses prefix schedules). Out in
// q's dtype, lse (B, H, S) f32, GQA head h reading kv head h / (H / Hkv).
//
// Design. A q-row block that walked j = 0..n-1 and skipped j > i as loop
// steps would pay nothing like a discarded block, and BB would look as
// cheap as the triangle. So, as in the paper, every tile of the n x n grid
// is its own block: grid (n * n, H, B), blockIdx.x = i * n + j. A block
// with j > i returns before any load (the discarded block). A live block
// computes its tile's softmax partial (m, l, acc in f32, the token mask
// applied, so band windows are right) with the prefill key-tile body that
// tri_fwd.cu runs (tri::prefill_key_tile, attn_tiles.cuh), and writes it to
// a scratch slot indexed by lambda = ltm_inverse(i, j) = tri(i) + j:
// B * H * tri(n) * (BLK * D + 2 * BLK) f32. It then counts itself in its
// row's arrival counter (atomicAdd after __threadfence; the partials
// themselves use no atomics). The row's last block to arrive merges the
// i + 1 partials in ascending j, as the reference's grid order accumulates
// them, and writes out and lse. Which block merges varies between runs;
// what it computes does not, so two runs are bitwise equal. One launch, as
// the reference's: tiles_launched = n^2 B H, tiles_domain = tri(n) B H.
//
// Bound on this card. The live tiles do fwd's arithmetic (4 BLK^2 D flops a
// tile), so fwd_bb is bound by the tensor-core rate like tri_fwd, plus the
// partials' round trip through device memory (2 x 2.2 GB at B 1, H 32,
// S 4096, D 128, BLK 64). This first version runs the products on the f32
// CUDA cores, as tri_fwd does, so the two isolate the space of
// computation as far as the designs allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = tri::PREFILL_NT;

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
fwd_bb_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, float* __restrict__ part,
              int* __restrict__ arrivals, int H, int Hkv, int S, int n,
              int win, float scale) {
  using Sh = tri::FwdShape<BLK, D>;
  constexpr int ACC = Sh::ACC;
  constexpr int PART = BLK * D + 2 * BLK;  // acc, then m, then l
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* ss = smem + BLK * Sh::DP + Sh::KC * Sh::DP + Sh::KC * D;
  float* sm = ss + BLK * Sh::SP;
  float* sl = sm + BLK;
  float* sa = sl + BLK;

  const int i = static_cast<int>(blockIdx.x) / n;
  const int j = static_cast<int>(blockIdx.x) - i * n;
  if (j > i) return;  // the paper's BB guard, by block coordinates

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  const T* qh = q + (static_cast<size_t>(b) * H + h) * plane;
  const T* kh = k + (static_cast<size_t>(b) * Hkv + hk) * plane;
  const T* vh = v + (static_cast<size_t>(b) * Hkv + hk) * plane;

  float acc[ACC];
  tri::prefill_begin<T, BLK, D>(qh, i * BLK, smem, acc);
  tri::prefill_key_tile<T, BLK, D>(kh, vh, j * BLK, i, j,
                                   win > 0 ? win : (1 << 30), 0, scale, smem,
                                   acc);

  const size_t cell = (static_cast<size_t>(b) * H + h) * static_cast<size_t>(tri::tri_n(n));
  const size_t row_lam = cell + static_cast<size_t>(tri::tri_n(i));
  float* mine = part + (row_lam + j) * PART;
#pragma unroll
  for (int a = 0; a < ACC; ++a) mine[threadIdx.x + a * NT] = acc[a];
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    mine[BLK * D + rr] = sm[rr];
    mine[BLK * D + BLK + rr] = sl[rr];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* row = arrivals + (static_cast<size_t>(b) * H + h) * n + i;
    is_last = atomicAdd(row, 1) == i;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // Merge the row's partials j' = 0..i in ascending order: running (M, L)
  // per row in sm / sl, the weights of the running state and of the
  // partial in sa / ss, the running acc in registers. Partials are read
  // through L2 (__ldcg): other blocks wrote them in this launch.
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    sm[rr] = tri::MASK_VALUE;
    sl[rr] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();
  for (int jj = 0; jj <= i; ++jj) {
    const float* p = part + (row_lam + jj) * PART;
    for (int rr = threadIdx.x; rr < BLK; rr += NT) {
      const float m_j = __ldcg(p + BLK * D + rr);
      const float l_j = __ldcg(p + BLK * D + BLK + rr);
      const float m_new = fmaxf(sm[rr], m_j);
      const float w_run = expf(sm[rr] - m_new), w_j = expf(m_j - m_new);
      sl[rr] = sl[rr] * w_run + l_j * w_j;
      sm[rr] = m_new;
      sa[rr] = w_run;
      ss[rr] = w_j;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = threadIdx.x + a * NT;
      const int rr = e / D;
      acc[a] = acc[a] * sa[rr] + __ldcg(p + e) * ss[rr];
    }
    __syncthreads();
  }
  T* oh = out + (static_cast<size_t>(b) * H + h) * plane;
  float* lh = lse + (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT;
    const int rr = e / D, d = e % D;
    oh[static_cast<size_t>(i * BLK + rr) * D + d] = tri::from_f32<T>(acc[a] / sl[rr]);
  }
  for (int rr = threadIdx.x; rr < BLK; rr += NT) lh[i * BLK + rr] = sm[rr] + logf(sl[rr]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse, part
// f32). part: B * H * tri(n) * (blk * D + 2 * blk) f32 scratch; arrivals:
// B * H * n int32, zero at launch. win: window in tokens (0 = none).
extern "C" int fwd_bb_launch(const void* q, const void* k, const void* v,
                             void* out, void* lse, void* part, void* arrivals,
                             int B, int H, int Hkv, int S, int D, int blk,
                             int n, int win, float scale, int dtype,
                             void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    auto kern = fwd_bb_kernel<T, BLK, DD>;
    constexpr size_t bytes = tri::FwdShape<BLK, DD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(n * n, H, B), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), static_cast<float*>(part),
        static_cast<int*>(arrivals), H, Hkv, S, n, win, scale);
    return static_cast<int>(cudaGetLastError());
  });
}
