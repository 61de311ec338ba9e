// Packed ragged prefill attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py:packed_fwd
// (_packed_fwd_kernel): flash attention over R requests concatenated along
// S, each request attending only its own ltm / band / prefix tile domain,
// online softmax in f32, GQA head h reads kv head h / (H / Hkv).
//
// Design. The Pallas grid walks its lambda steps in order on one core and
// carries the softmax state from a row's first tile to its last. CUDA
// blocks run in no order, so this kernel gives each accumulator owner,
// one (batch, head, packed q-row tile), its own block: grid
// (total q-row tiles, H, B). The block finds its member by binary search
// over the table's tile-row offsets, then walks the member-local lambdas
// of its row [segment_origin(i), segment_origin(i) + row width) through
// member_map_params -- the paper's g(lambda) on the device -- in the
// reference's order. Every K/V tile it reads is in the domain: no tile
// outside the triangle (or band, or prefix) is ever loaded.
//
// Bound on this card. Per tile step the block does 4 * blk^2 * D flops
// over 2 * blk * D loaded K/V values: at blk = 64, D = 128 the kernel sits
// above the H100's bf16 ridge, so the bound is the tensor-core rate.
// This first version does the products on the f32 CUDA cores (scalar
// FMAs from shared memory), which is simple and exact against the f32
// reference; it therefore runs far from the tensor-core bound. The next
// step is wgmma (or mma.sync) for QK^T and PV with P rounded to bf16.
//
// Shared memory: the Q tile (blk x D, f32, padded rows), one key chunk of
// KC = min(blk, 32) keys of K and V, the chunk's scores and the per-row
// softmax state. Keys are consumed in chunks of KC, which keeps the
// softmax one key per lane and the footprint at ~75 KB for blk = 64,
// D = 128. The block's body is tri::prefill_row_tile (attn_tiles.cuh),
// which the fused step kernel runs too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"

namespace {

constexpr int NT = tri::PREFILL_NT;

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
packed_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ tbl,
                  int n_members, int H, int Hkv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  // (7, R) table: starts | rows | n | w_b | p_b | win | pre
  const int R = n_members;
  const int* rows = tbl + R;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = tri::request_from_starts(tile, rows, R);
  const size_t head_elems = static_cast<size_t>(S) * D;
  tri::prefill_row_tile<T, BLK, D>(
      q + (static_cast<size_t>(b) * H + h) * head_elems,
      k + (static_cast<size_t>(b) * Hkv + hk) * head_elems,
      v + (static_cast<size_t>(b) * Hkv + hk) * head_elems,
      out + (static_cast<size_t>(b) * H + h) * head_elems,
      lse + (static_cast<size_t>(b) * H + h) * S, rows[r], tile - rows[r],
      tbl[2 * R + r], tbl[3 * R + r], tbl[4 * R + r], tbl[5 * R + r],
      tbl[6 * R + r], scale, reinterpret_cast<float*>(smem));
}

template <typename T, int BLK, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const void* tbl, int n_members, int B, int H,
               int Hkv, int S, int total_tiles, float scale,
               cudaStream_t stream) {
  auto kern = packed_fwd_kernel<T, BLK, D>;
  constexpr size_t bytes = tri::FwdShape<BLK, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(total_tiles, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), static_cast<const int*>(tbl), n_members, H,
      Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}

__global__ void member_map_probe_kernel(const int* __restrict__ local,
                                        const int* __restrict__ nwp,
                                        int* __restrict__ out_i,
                                        int* __restrict__ out_j, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  tri::member_map_params(local[e], nwp[e], nwp[count + e], nwp[2 * count + e],
                         &out_i[e], &out_j[e]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; lse is f32).
extern "C" int packed_fwd_launch(const void* q, const void* k, const void* v,
                                 void* out, void* lse, const void* tbl,
                                 int n_members, int B, int H, int Hkv, int S,
                                 int D, int blk, int total_tiles, float scale,
                                 int dtype, void* stream) {
  return tri::dispatch_tile(dtype, blk, D, [&](auto t, auto blk_c, auto d_c) {
    using T = typename decltype(t)::type;
    constexpr int BLK = decltype(blk_c)::value, DD = decltype(d_c)::value;
    return launch_fwd<T, BLK, DD>(
        q, k, v, out, lse, tbl, n_members, B, H, Hkv, S, total_tiles, scale,
        static_cast<cudaStream_t>(stream));
  });
}

// Evaluates member_map_params for `count` (local, n, w, p) tuples: the
// device g(lambda) the kernel above walks, exposed for tests.
extern "C" int member_map_probe(const void* local, const void* nwp,
                                void* out_i, void* out_j, int count,
                                void* stream) {
  const int threads = 256;
  const int blocks = (count + threads - 1) / threads;
  member_map_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(local), static_cast<const int*>(nwp),
      static_cast<int*>(out_i), static_cast<int*>(out_j), count);
  return static_cast<int>(cudaGetLastError());
}
