// Triangular-domain attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:fwd
// (_fwd_kernel): flash attention over one request's ltm / band / prefix
// tile domain, online softmax in f32, GQA head h reads kv head h / (H / Hkv),
// out in q's dtype and lse (B, H, S) in f32. It is the forward of every
// layer of a training step (and of its recompute under remat).
//
// Design. The Pallas grid walks its row-major lambdas in order on one core
// and carries the softmax state from a row's first tile to its last. CUDA
// blocks run in no order, so each accumulator owner, one (batch, head,
// q-row tile), is one block: grid (n, H, B). The block runs the prefill
// body of the packed kernels (tri::prefill_row_tile, attn_tiles.cuh) with
// row0 = 0 and the schedule's (n, w_b, p_b, window, prefix): it walks its
// row's lambdas through the device g(lambda) in the reference's order and
// loads no tile outside the domain. Rows are issued longest first
// (blockIdx.x 0 is row n - 1), so the long serial walks start early and do
// not form the tail.
//
// Bound on this card. Per tile the block does 4 * blk^2 * D flops over
// 2 * blk * D loaded K/V values, so at blk 64, D 128 the kernel is bound by
// the tensor-core rate (bf16). This first version does the products on
// the f32 CUDA cores from shared memory, as packed_fwd does, and runs far
// from that bound; wgmma (or mma.sync) with P in bf16 is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = tri::PREFILL_NT;

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
tri_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int H, int Hkv, int S, int n, int w,
               int p, int win, int pre, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = n - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t plane = static_cast<size_t>(S) * D;
  tri::prefill_row_tile<T, BLK, D>(
      q + (static_cast<size_t>(b) * H + h) * plane,
      k + (static_cast<size_t>(b) * Hkv + hk) * plane,
      v + (static_cast<size_t>(b) * Hkv + hk) * plane,
      out + (static_cast<size_t>(b) * H + h) * plane,
      lse + (static_cast<size_t>(b) * H + h) * S, 0, i, n, w, p, win, pre,
      scale, reinterpret_cast<float*>(smem));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse is f32).
// (n, w, p): tiles per side, band width in tiles (n unbanded), prefix
// width in tiles (0 = none); win / pre: window and prefix in tokens.
extern "C" int tri_fwd_launch(const void* q, const void* k, const void* v,
                              void* out, void* lse, int B, int H, int Hkv,
                              int S, int D, int blk, int n, int w, int p,
                              int win, int pre, float scale, int dtype,
                              void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    auto kern = tri_fwd_kernel<T, BLK, DD>;
    constexpr size_t bytes = tri::FwdShape<BLK, DD>::BYTES;
    if (int err = tri::set_smem(kern, bytes)) return err;
    kern<<<dim3(n, H, B), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), H, Hkv, S, n, w, p, win, pre, scale);
    return static_cast<int>(cudaGetLastError());
  });
}
