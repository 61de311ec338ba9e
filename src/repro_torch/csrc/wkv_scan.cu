// The RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/wkv_scan/kernel.py:
//   wkv (_wkv_kernel) -> wkv_launch. Per (batch b, head h) stream the
//   state S (hd x hd, f32) runs over t = 0 .. L-1:
//     out_t[j] = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//     S[i][j] <- e^{lw_t[i]} S[i][j] + k_t[i] v_t[j]
//   r, k, v, lw (B, L, H, hd) f32 or bf16 (one dtype), u (H, hd) f32,
//   s0 and s_L (B, H, hd, hd) f32, out (B, L, H, hd) in r's dtype;
//   hd in {8, 16, 32, 64}.
//
// The Pallas grid (B, H, L / block_l) carries S in scratch from one chunk
// to the next, in order. Here each stream is split over time into chunks
// of WKV_CHUNK steps, one block a (stream, chunk): B * H * ceil(L / C)
// blocks, chained in the same launch. A block
//   (a) stages its steps WKV_SUB at a time through a cp.async ring of
//       WKV_STAGES stages, so the next steps load while these run; each
//       staged step is turned into f32 r, k, e^{lw}, v once, with its
//       u-bonus sum_i r u k and its r_t * prod_{tau < t} e^{lw_tau};
//   (b) runs the recurrence over its steps, chunk 0 from s0 (its outputs
//       final), every other chunk from S = 0: that gives its local
//       outputs, its local state dS_c and P_c = prod_t e^{lw_t};
//   (c) waits for S_{c-1} (its predecessor's flag), publishes
//       S_c = diag(P_c) S_{c-1} + dS_c (s_L for the last chunk), and
//   (d) adds (r_t * prod_{tau < t} e^{lw_tau}) S_{c-1} to each local
//       output: every factor is at most 1, so nothing overflows.
// Blocks take (stream, chunk) in the order of tickets drawn from an atomic
// counter, chunk-major, so a block's predecessor has always started and
// the waits cannot deadlock (decoupled look-back). counters[0] is the
// ticket counter, counters[1 + stream] the stream's published chunks; the
// block that draws the last ticket and the last chunk of each stream set
// theirs back to 0, so every counter is 0 between launches. Chunk 0 reads
// s0 before it publishes, and the last chunk writes s_L after all others
// published, so s0 and s_L may be the same buffer. No atomics touch the
// data: two runs give the same bits.
//
// Inside a chunk's block thread (j, q) = (tid % hd, tid / hd) keeps rows
// q hd/P .. (q+1) hd/P - 1 of column j of S in registers (P = 4 threads a
// column, or 2 at hd 8). At hd >= 32 a warp holds one row block, so each
// float4 of r, k, e^{lw} a step is one broadcast to the whole warp (with
// the row blocks spread over a warp's lanes the block was bound by shared
// memory wavefronts). A step's P partial sums of out_t[j] go to shared
// memory, and the block sums them in row-block order once a stage's steps
// are done. The correction reads S_{c-1} staged in shared memory, each
// thread a column's rows 16 at a time against its steps q + P x. expf,
// not __expf: built without fast-math like every source here.
//
// A call of L <= WKV_CHUNK (every decode step) has nothing to chain and
// runs wkv_walk_kernel instead: one block a stream stages its L steps in
// shared memory by plain loads and walks them from s0 (a ring and the
// chunked kernel's extra barriers only add latency to one step; the walk
// is the faster at L = 1, scripts/scan_variants.py). There the P threads
// of a column are adjacent lanes and sum out_t[j] in shuffles, so its
// bits are those of L one-step calls, not those of a longer call's chunk
// 0. It reads s0 before it writes s_L: the decode step updates its cache
// in place.
//
// Bound on this card. Each (b, t, h) moves 4 hd inputs and hd outputs
// against about 4 hd^2 flops, so at hd 64 the call is bound by bytes
// (3.35 TB/s) over f32 CUDA-core operations (67 TFLOP/s). This kernel
// does about 8 hd^2 f32 operations a (b, t, h) (the local pass and the
// correction), in B * H * ceil(L / C) blocks; the chain adds one flag
// hop a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "packing.cuh"

namespace {

constexpr int WKV_CHUNK = 64;  // steps a block takes of its stream
constexpr int WKV_SUB = 16;    // steps a ring stage holds
constexpr int WKV_STAGES = 2;  // ring stages

// An int another block publishes after a fence.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <typename T, int HD>
struct Wkv {
  static constexpr int P = HD >= 16 ? 4 : 2;  // threads a column
  static constexpr int R = HD / P;            // rows a thread
  static constexpr int NT = HD * P;
  static constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  static constexpr int VEC = 16 / sizeof(T);  // elements a cp.async
  static constexpr int PIECES = HD / VEC;     // cp.asyncs a row
  // a step's u-bonus: G adjacent lanes, HD / G elements each
  static constexpr int G = NT / WKV_SUB >= 1 ? NT / WKV_SUB : 1;
  static constexpr int GSTEPS = NT / G;
  static constexpr int STAGE = 4 * WKV_SUB * HD;  // r, k, lw, v
  static constexpr size_t RING = sizeof(T) * WKV_STAGES * STAGE;
  // work (r, k, e^lw, v: 4 x SUB x HD) then the output partials (P x SUB
  // x HD), which S_{c-1} (HD x HD) takes over after the walk; rp and the
  // local outputs (CHUNK x HD each), the bonus (CHUNK) and P_c (HD)
  static constexpr int WORK = (4 + P) * WKV_SUB * HD;
  static constexpr size_t FLOATS = WORK + 2 * WKV_CHUNK * HD + WKV_CHUNK + HD;
  static constexpr size_t SMEM = RING + FLOATS * sizeof(float);
  // a chunk's correction: steps q + P x of a thread, S_{c-1} rows IB at a time
  static constexpr int XN = WKV_CHUNK / P;
  static constexpr int IB = HD < 16 ? HD : 16;
  static_assert(R % 4 == 0 && G <= 32 && HD % G == 0 && WKV_SUB % GSTEPS == 0 &&
                    WORK >= HD * HD && WKV_CHUNK % P == 0,
                "tiling");
};

template <typename T, int HD>
__global__ void __launch_bounds__(Wkv<T, HD>::NT, 1)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ lw,
               const float* __restrict__ u, const float* s0, T* __restrict__ out,
               float* s_l, float* slot, int* counters, int L, int H, int nchunks) {
  using S = Wkv<T, HD>;
  constexpr int P = S::P, R = S::R, NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* wr = reinterpret_cast<float*>(smem + S::RING);
  float* wk = wr + WKV_SUB * HD;
  float* ww = wk + WKV_SUB * HD;
  float* wv = ww + WKV_SUB * HD;
  float* po = wv + WKV_SUB * HD;  // output partials, one row block of S each
  float* sprev = wr;              // S_{c-1}, once the walk is done
  float* rp = wr + S::WORK;       // r_t * prod_{tau < t} e^{lw_tau}
  float* so = rp + WKV_CHUNK * HD;  // local outputs
  float* bonus = so + WKV_CHUNK * HD;
  float* pc = bonus + WKV_CHUNK;  // P_c
  __shared__ int ticket;

  // thread (j, q): column j, rows q R .. q R + R - 1 (one q a warp at hd >= 32)
  const int tid = threadIdx.x, j = tid % HD, q = tid / HD, i0 = q * R;
  if (tid == 0) {
    const int t = atomicAdd(counters, 1);
    if (t == static_cast<int>(gridDim.x) - 1) atomicExch(counters, 0);
    ticket = t;
  }
  __syncthreads();
  const int nstreams = gridDim.x / nchunks;
  const int bh = ticket % nstreams, c = ticket / nstreams;
  const int b = bh / H, h = bh % H;
  const int t0 = c * WKV_CHUNK, n = min(WKV_CHUNK, L - t0);
  const int nsub = (n + WKV_SUB - 1) / WKV_SUB;
  const size_t step = static_cast<size_t>(H) * HD;  // between time steps
  const size_t base = (static_cast<size_t>(b) * L * H + h) * HD + t0 * step;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD;

  auto issue = [&](int kk) {
    if (kk < nsub) {
      const int nk = min(WKV_SUB, n - kk * WKV_SUB);
      T* stage = ring + (kk % WKV_STAGES) * S::STAGE;
      const size_t g0 = base + static_cast<size_t>(kk) * WKV_SUB * step;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const T* src = a == 0 ? r : a == 1 ? k : a == 2 ? lw : v;
        for (int e = tid; e < nk * S::PIECES; e += NT) {
          const int row = e / S::PIECES, pe = e % S::PIECES;
          tri::cp_async16(stage + (a * WKV_SUB + row) * HD + pe * S::VEC,
                           src + g0 + static_cast<size_t>(row) * step + pe * S::VEC);
        }
      }
    }
    tri::cp_async_commit();
  };
  // sub-chunk kk's outputs: the P row blocks' partials summed in order
  auto reduce = [&](int kk) {
    const int nk = min(WKV_SUB, n - kk * WKV_SUB), tk = kk * WKV_SUB;
    for (int e = tid; e < nk * HD; e += NT) {
      float o = po[e];
#pragma unroll
      for (int qq = 1; qq < P; ++qq) o += po[qq * WKV_SUB * HD + e];
      if (c == 0) {
        out[base + static_cast<size_t>(tk + e / HD) * step + e % HD] = tri::from_f32<T>(o);
      } else {
        so[tk * HD + e] = o;
      }
    }
  };
#pragma unroll
  for (int kk = 0; kk < WKV_STAGES; ++kk) issue(kk);

  float s[R];
#pragma unroll
  for (int m = 0; m < R; ++m)
    s[m] = c == 0 ? s0[sbase + static_cast<size_t>(i0 + m) * HD + j] : 0.f;
  constexpr int PER = HD / S::G;
  const int g = tid % S::G;
  float ub[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) ub[m] = u[static_cast<size_t>(h) * HD + g + S::G * m];
  float prow = 1.f;  // prod of e^{lw} of row tid over the steps so far (tid < HD)

  for (int kk = 0; kk < nsub; ++kk) {
    const int nk = min(WKV_SUB, n - kk * WKV_SUB), tk = kk * WKV_SUB;
    const T* sr = ring + (kk % WKV_STAGES) * S::STAGE;
    const T* sk = sr + WKV_SUB * HD;
    const T* sl = sk + WKV_SUB * HD;
    const T* sv = sl + WKV_SUB * HD;
    tri::cp_async_wait<WKV_STAGES - 1>();
    __syncthreads();  // the stage landed; the last steps are done
    if (kk > 0) reduce(kk - 1);
    for (int e = tid; e < nk * HD; e += NT) {
      wr[e] = tri::to_f32(sr[e]);
      wk[e] = tri::to_f32(sk[e]);
      ww[e] = expf(tri::to_f32(sl[e]));
      wv[e] = tri::to_f32(sv[e]);
    }
#pragma unroll
    for (int p0 = 0; p0 < WKV_SUB; p0 += S::GSTEPS) {
      const int tt = p0 + tid / S::G;
      float acc = 0.f;
      if (tt < nk) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          const int i = tt * HD + g + S::G * m;
          acc = fmaf(tri::to_f32(sr[i]) * ub[m], tri::to_f32(sk[i]), acc);
        }
      }
#pragma unroll
      for (int o = 1; o < S::G; o <<= 1) acc += __shfl_xor_sync(S::MASK, acc, o);
      if (g == 0 && tt < nk) bonus[tk + tt] = acc;
    }
    __syncthreads();  // work and the bonus are written; the stage is free
    issue(kk + WKV_STAGES);
    if (c > 0 && tid < HD) {  // chunk 0 corrects nothing
#pragma unroll
      for (int tt = 0; tt < WKV_SUB; ++tt) {
        if (tt < nk) {
          rp[(tk + tt) * HD + tid] = wr[tt * HD + tid] * prow;
          prow *= ww[tt * HD + tid];
        }
      }
    }
#pragma unroll 2
    for (int tt = 0; tt < nk; ++tt) {
      const float* rt = wr + tt * HD + i0;
      const float* kt = wk + tt * HD + i0;
      const float* wt = ww + tt * HD + i0;
      const float vj = wv[tt * HD + j];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int m = 0; m < R; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + m);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + m);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + m);
        a0 = fmaf(r4.x, s[m], a0);
        a1 = fmaf(r4.y, s[m + 1], a1);
        a0 = fmaf(r4.z, s[m + 2], a0);
        a1 = fmaf(r4.w, s[m + 3], a1);
        s[m] = fmaf(w4.x, s[m], k4.x * vj);
        s[m + 1] = fmaf(w4.y, s[m + 1], k4.y * vj);
        s[m + 2] = fmaf(w4.z, s[m + 2], k4.z * vj);
        s[m + 3] = fmaf(w4.w, s[m + 3], k4.w * vj);
      }
      float part = a0 + a1;
      if (q == 0) part = fmaf(bonus[tk + tt], vj, part);
      po[(q * WKV_SUB + tt) * HD + j] = part;
    }
  }
  __syncthreads();  // the last steps' partials are written
  reduce(nsub - 1);

  int* flag = counters + 1 + bh;
  if (c == 0) {  // S_0 is the walk's state
#pragma unroll
    for (int m = 0; m < R; ++m) __stcg(slot + sbase + static_cast<size_t>(i0 + m) * HD + j, s[m]);
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(flag, 1);
    return;
  }
  if (tid < HD) pc[tid] = prow;
  if (tid == 0) {
    while (ld_acquire(flag) != c) {
    }
  }
  __syncthreads();  // S_{c-1} is published
  for (int e = tid; e < HD * HD; e += NT) sprev[e] = __ldcg(slot + sbase + e);
  __syncthreads();  // S_{c-1} staged; pc and the local outputs written
  const bool last = c == nchunks - 1;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = i0 + m;
    const float sc = fmaf(pc[i], sprev[i * HD + j], s[m]);
    if (last) {
      s_l[sbase + static_cast<size_t>(i) * HD + j] = sc;
    } else {
      __stcg(slot + sbase + static_cast<size_t>(i) * HD + j, sc);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicExch(flag, last ? 0 : c + 1);
  // out_t += (r_t * prod_{tau < t} e^{lw_tau}) S_{c-1}, t = q + P x
  float acc[S::XN];
#pragma unroll
  for (int x = 0; x < S::XN; ++x) acc[x] = 0.f;
#pragma unroll
  for (int ib = 0; ib < HD; ib += S::IB) {
    float col[S::IB];
#pragma unroll
    for (int i = 0; i < S::IB; ++i) col[i] = sprev[(ib + i) * HD + j];
#pragma unroll
    for (int x = 0; x < S::XN; ++x) {
      const float* rt = rp + (q + P * x) * HD + ib;
      if (q + P * x < n) {
#pragma unroll
        for (int i = 0; i < S::IB; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
          acc[x] = fmaf(r4.x, col[i], acc[x]);
          acc[x] = fmaf(r4.y, col[i + 1], acc[x]);
          acc[x] = fmaf(r4.z, col[i + 2], acc[x]);
          acc[x] = fmaf(r4.w, col[i + 3], acc[x]);
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < S::XN; ++x) {
    const int tt = q + P * x;
    if (tt < n)
      out[base + static_cast<size_t>(tt) * step + j] = tri::from_f32<T>(so[tt * HD + j] + acc[x]);
  }
}

// A call of one chunk (L <= WKV_CHUNK): one block a stream walks its L
// steps from s0, staged in shared memory (r, k, e^{lw}, v; L x HD floats
// each); thread (j, q) = (tid / P, tid % P), so a column's P partial sums
// meet in shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(Wkv<T, HD>::NT)
    wkv_walk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ lw,
                    const float* __restrict__ u, const float* s0, T* __restrict__ out,
                    float* s_l, int L, int H) {
  using S = Wkv<T, HD>;
  constexpr int P = S::P, R = S::R, NT = S::NT;
  extern __shared__ __align__(16) float wsm[];
  float* sr = wsm;
  float* sk = sr + L * HD;
  float* sw = sk + L * HD;
  float* sv = sw + L * HD;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, j = tid / P, q = tid % P, i0 = q * R;
  const size_t step = static_cast<size_t>(H) * HD;  // between time steps
  const size_t base = (static_cast<size_t>(b) * L * H + h) * HD;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD;

  float s[R], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    s[m] = s0[sbase + static_cast<size_t>(i0 + m) * HD + j];
    uu[m] = u[static_cast<size_t>(h) * HD + i0 + m];
  }
#pragma unroll 4
  for (int e = tid; e < L * HD; e += NT) {
    const size_t g = base + static_cast<size_t>(e / HD) * step + e % HD;
    sr[e] = tri::to_f32(r[g]);
    sk[e] = tri::to_f32(k[g]);
    sw[e] = expf(tri::to_f32(lw[g]));
    sv[e] = tri::to_f32(v[g]);
  }
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    const float* rt = sr + t * HD + i0;
    const float* kt = sk + t * HD + i0;
    const float* wt = sw + t * HD + i0;
    const float vj = sv[t * HD + j];
    float a0 = 0.f, a1 = 0.f, bonus = 0.f;
#pragma unroll
    for (int m = 0; m < R; m += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(rt + m);
      const float4 k4 = *reinterpret_cast<const float4*>(kt + m);
      const float4 w4 = *reinterpret_cast<const float4*>(wt + m);
      a0 = fmaf(r4.x, s[m], a0);
      a1 = fmaf(r4.y, s[m + 1], a1);
      a0 = fmaf(r4.z, s[m + 2], a0);
      a1 = fmaf(r4.w, s[m + 3], a1);
      bonus = fmaf(r4.x * uu[m], k4.x, bonus);
      bonus = fmaf(r4.y * uu[m + 1], k4.y, bonus);
      bonus = fmaf(r4.z * uu[m + 2], k4.z, bonus);
      bonus = fmaf(r4.w * uu[m + 3], k4.w, bonus);
      s[m] = fmaf(w4.x, s[m], k4.x * vj);
      s[m + 1] = fmaf(w4.y, s[m + 1], k4.y * vj);
      s[m + 2] = fmaf(w4.z, s[m + 2], k4.z * vj);
      s[m + 3] = fmaf(w4.w, s[m + 3], k4.w * vj);
    }
    float part = fmaf(bonus, vj, a0 + a1);
#pragma unroll
    for (int o = 1; o < P; o <<= 1) part += __shfl_xor_sync(S::MASK, part, o);
    if (q == 0) out[base + static_cast<size_t>(t) * step + j] = tri::from_f32<T>(part);
  }
#pragma unroll
  for (int m = 0; m < R; ++m) s_l[sbase + static_cast<size_t>(i0 + m) * HD + j] = s[m];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* out, void* s_l, void* slot, void* counters, int B, int L,
           int H, int hd, cudaStream_t stream) {
  auto go = [&](auto hd_c) -> int {
    constexpr int HD = decltype(hd_c)::value;
    using S = Wkv<T, HD>;
    const int nchunks = (L + WKV_CHUNK - 1) / WKV_CHUNK;
    const long long blocks = static_cast<long long>(B) * H * nchunks;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (nchunks == 1) {
      const size_t bytes = 4 * sizeof(float) * L * HD;
      auto walk = wkv_walk_kernel<T, HD>;
      if (int err = tri::set_smem(walk, bytes)) return err;
      walk<<<static_cast<unsigned>(blocks), S::NT, bytes, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(lw), static_cast<const float*>(u),
          static_cast<const float*>(s0), static_cast<T*>(out), static_cast<float*>(s_l), L, H);
      return static_cast<int>(cudaGetLastError());
    }
    if (slot == nullptr || counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    auto kern = wkv_kernel<T, HD>;
    if (int err = tri::set_smem(kern, S::SMEM)) return err;
    kern<<<static_cast<unsigned>(blocks), S::NT, S::SMEM, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(lw), static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<T*>(out), static_cast<float*>(s_l), static_cast<float*>(slot),
        static_cast<int*>(counters), L, H, nchunks);
    return static_cast<int>(cudaGetLastError());
  };
  switch (hd) {
    case 8: return go(std::integral_constant<int, 8>{});
    case 16: return go(std::integral_constant<int, 16>{});
    case 32: return go(std::integral_constant<int, 32>{});
    case 64: return go(std::integral_constant<int, 64>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, lw: (B, L, H, hd) of `dtype` (0 f32, 1 bf16), 16-byte aligned;
// u (H, hd) f32; s0, s_l (B, H, hd, hd) f32, possibly the same buffer; out
// (B, L, H, hd) of `dtype`; slot (B, H, hd, hd) f32 scratch and counters
// (1 + B * H) int32, all 0, both needed only when L > WKV_CHUNK (else
// may be null). hd in {8, 16, 32, 64}.
extern "C" int wkv_launch(const void* r, const void* k, const void* v, const void* lw,
                          const void* u, const void* s0, void* out, void* s_l, void* slot,
                          void* counters, int B, int L, int H, int hd, int dtype,
                          void* stream) {
  if (L < 1 || B < 1 || H < 1 || !tri::aligned16(r, k, v, lw))
    return static_cast<int>(cudaErrorInvalidValue);
  return tri::dispatch_dtype(dtype, [&](auto t) -> int {
    using T = typename decltype(t)::type;
    return launch<T>(r, k, v, lw, u, s0, out, s_l, slot, counters, B, L, H, hd,
                     static_cast<cudaStream_t>(stream));
  });
}
