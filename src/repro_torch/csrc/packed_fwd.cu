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
// D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packing.cuh"

namespace {

constexpr int NT = 256;

template <int BLK, int D>
struct FwdShape {
  static constexpr int KC = BLK < 32 ? BLK : 32;
  static constexpr int DP = D + 1;
  static constexpr int SP = KC + 1;
  static constexpr int ACC = BLK * D / NT;
  static constexpr int FLOATS = BLK * DP + KC * DP + KC * D + BLK * SP + 3 * BLK;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <typename T, int BLK, int D>
__global__ void __launch_bounds__(NT)
packed_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, const int* __restrict__ tbl,
                  int n_members, int H, int Hkv, int S, float scale) {
  using Sh = FwdShape<BLK, D>;
  constexpr int KC = Sh::KC, DP = Sh::DP, SP = Sh::SP, ACC = Sh::ACC;
  static_assert(BLK * D % NT == 0, "tile must split evenly over threads");
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BLK * DP;
  float* sv = sk + KC * DP;
  float* ss = sv + KC * D;
  float* sm = ss + BLK * SP;
  float* sl = sm + BLK;
  float* sa = sl + BLK;

  const int R = n_members;
  const int* starts = tbl;
  const int* rows = tbl + R;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = tri::request_from_starts(tile, rows, R);
  const int i = tile - rows[r];
  const int n_r = tbl[2 * R + r], w_r = tbl[3 * R + r], p_r = tbl[4 * R + r];
  const int win = tbl[5 * R + r], pre = tbl[6 * R + r];
  const int win_eff = win > 0 ? win : (1 << 30);
  const int first = tri::first_col_params(i, w_r);
  const int last = tri::last_col_params(i, p_r);
  const int lam0 = tri::segment_origin_params(i, w_r, p_r);
  (void)starts;

  const size_t head_elems = static_cast<size_t>(S) * D;
  const T* qh = q + (static_cast<size_t>(b) * H + h) * head_elems;
  const T* kh = k + (static_cast<size_t>(b) * Hkv + hk) * head_elems;
  const T* vh = v + (static_cast<size_t>(b) * Hkv + hk) * head_elems;
  const int q0 = (rows[r] + i) * BLK;

  for (int e = threadIdx.x; e < BLK * D; e += NT) {
    const int rr = e / D, d = e % D;
    sq[rr * DP + d] = tri::to_f32(qh[static_cast<size_t>(q0 + rr) * D + d]);
  }
  for (int rr = threadIdx.x; rr < BLK; rr += NT) {
    sm[rr] = tri::MASK_VALUE;
    sl[rr] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = 0; s <= last - first; ++s) {
    int ii, j;
    tri::member_map_params(lam0 + s, n_r, w_r, p_r, &ii, &j);
    const int k0 = (rows[r] + j) * BLK;
    for (int c0 = 0; c0 < BLK; c0 += KC) {
      for (int e = threadIdx.x; e < KC * D; e += NT) {
        const int cc = e / D, d = e % D;
        const size_t off = static_cast<size_t>(k0 + c0 + cc) * D + d;
        sk[cc * DP + d] = tri::to_f32(kh[off]);
        sv[cc * D + d] = tri::to_f32(vh[off]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < BLK * KC; e += NT) {
        const int rr = e / KC, cc = e % KC;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(sq[rr * DP + d], sk[cc * DP + d], dot);
        const int qp = ii * BLK + rr, kp = j * BLK + c0 + cc;
        const bool keep = (kp <= qp && qp - kp < win_eff) || kp < pre;
        ss[rr * SP + cc] = keep ? dot * scale : tri::MASK_VALUE;
      }
      __syncthreads();
      for (int rr = warp; rr < BLK; rr += NT / 32) {
        const float sval = lane < KC ? ss[rr * SP + lane] : -INFINITY;
        const float m_prev = sm[rr];
        const float m_new = fmaxf(m_prev, tri::warp_max(sval));
        const float p = lane < KC ? expf(sval - m_new) : 0.f;
        const float psum = tri::warp_sum(p);
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

  T* oh = out + (static_cast<size_t>(b) * H + h) * head_elems;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = threadIdx.x + a * NT;
    const int rr = e / D, d = e % D;
    oh[static_cast<size_t>(q0 + rr) * D + d] = tri::from_f32<T>(acc[a] / sl[rr]);
  }
  float* lh = lse + (static_cast<size_t>(b) * H + h) * S;
  for (int rr = threadIdx.x; rr < BLK; rr += NT) lh[q0 + rr] = sm[rr] + logf(sl[rr]);
}

template <typename T, int BLK, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const void* tbl, int n_members, int B, int H,
               int Hkv, int S, int total_tiles, float scale,
               cudaStream_t stream) {
  auto kern = packed_fwd_kernel<T, BLK, D>;
  constexpr size_t bytes = FwdShape<BLK, D>::BYTES;
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

template <typename T, int BLK>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               void* lse, const void* tbl, int R, int B, int H, int Hkv,
               int S, int tiles, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_fwd<T, BLK, 16>(q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    case 32: return launch_fwd<T, BLK, 32>(q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    case 64: return launch_fwd<T, BLK, 64>(q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    case 128: return launch_fwd<T, BLK, 128>(q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_blk(int blk, int D, const void* q, const void* k, const void* v,
                 void* out, void* lse, const void* tbl, int R, int B, int H,
                 int Hkv, int S, int tiles, float scale, cudaStream_t st) {
  switch (blk) {
    case 16: return dispatch_d<T, 16>(D, q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    case 32: return dispatch_d<T, 32>(D, q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    case 64: return dispatch_d<T, 64>(D, q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    case 128: return dispatch_d<T, 128>(D, q, k, v, out, lse, tbl, R, B, H, Hkv, S, tiles, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_blk<float>(blk, D, q, k, v, out, lse, tbl, n_members, B, H,
                               Hkv, S, total_tiles, scale, st);
  if (dtype == 1)
    return dispatch_blk<__nv_bfloat16>(blk, D, q, k, v, out, lse, tbl,
                                       n_members, B, H, Hkv, S, total_tiles,
                                       scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
