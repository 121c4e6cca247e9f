// FlashAttention-2 forward for Hopper (sm_90a), float32 arithmetic on the
// CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_fwd (the
// Pallas TPU kernel behind kernels/flash_attention/ops.py::mha, which
// models/attention.py::mha calls once a layer in the transformer's prefill
// and forward).  q is (B*Hq, Sq, D), k and v are (B*Hkv, Sk, D), and q head h
// reads kv head h / G (G = Hq / Hkv).  A key at position kp is live for the
// query at position qp = row + q_offset when kp <= qp (causal) and
// kp > qp - window (window > 0).  Per query row it keeps the running max m,
// the denominator l and the f32 accumulator over kv tiles, then writes
// out = acc / max(l, 1e-30) in q's dtype and lse = m + log(max(l, 1e-30)).
//
// What bounds it: operations.  At the 32k prefill of h2o-danube-3-4b one call
// does 4*Hq*D flops on each of 125.8 M live (query, key) pairs a head, 1.9e12
// flops, against 0.5 GB to read q, k, v and write out.  This first kernel
// runs them as float32 FMAs on the CUDA cores (a later one moves them to the
// tensor cores).  The design:
//   * grid (B*Hq, ceil(Sq/64)); a block of 256 threads holds a 64-row q tile
//     and the rows' (m, l, acc) on chip, and streams its kv head's 64-key k
//     and v tiles through shared memory (f32, the k rows padded to an odd
//     stride so that the 16 key lanes of a warp hit 16 banks);
//   * the kv loop runs only over the tiles that the causal and window mask
//     leaves live for some row of the block: [q0 + q_offset - window + 1,
//     q0 + rows - 1 + q_offset] clipped to [0, Sk), at most
//     ceil((window + 63) / 64) + 1 tiles, where the TPU kernel visits all
//     Sk / bk and masks them.  That is exact: in the recurrence a wholly
//     masked tile leaves (m, l, acc) as they were (p = 0, alpha = 1);
//   * each thread computes a 4 x 4 register tile of the 64 x 64 scores
//     (rows ty + 16i, keys tx + 16j), the scores go to shared memory (over
//     the k tile), one warp a row updates (m, l) by shuffles, and each
//     thread accumulates 4 rows x ceil(D/16) columns of P V in registers;
//   * ragged tails: rows past Sq are not written and keys past Sk are
//     masked, so any Sq and Sk work (Pallas needs multiples of the block).
// D may be at most 128 (kDMax).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // q rows a block
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr int kDC = kDMax / 16;    // accumulator columns a thread
constexpr int kPS = kBK + 1;       // score tile row stride
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool live(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// Shared memory of one block, in floats: Qs (kBQ x DP), the k tile (kBK x
// DP) which the score tile (kBQ x kPS) reuses, Vs (kBK x D), m, l, alpha.
__host__ __device__ inline int smem_floats(int D) {
  const int DP = D | 1;
  const int kt = kBK * DP > kBQ * kPS ? kBK * DP : kBQ * kPS;
  return kBQ * DP + kt + kBK * D + 3 * kBQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int G, int Sq, int Sk, int D,
                 float scale, int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D | 1;
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Ps = Ks;                                   // after the scores
  float* Vs = Ks + (kBK * DP > kBQ * kPS ? kBK * DP : kBQ * kPS);
  float* m_s = Vs + kBK * D;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const T* qh = q + ((long long)h * Sq + q0) * D;
  const T* kh = k + (long long)(h / G) * Sk * D;
  const T* vh = v + (long long)(h / G) * Sk * D;

  for (int r = warp; r < kBQ; r += kThreads / 32)
    for (int c = lane; c < D; c += 32)
      Qs[r * DP + c] = r < nq ? to_f(qh[(long long)r * D + c]) : 0.f;
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;

  // the live key range of the block's rows, in whole tiles
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  const int t0 = kbeg / kBK;
  const int t1 = kend > kbeg ? (kend + kBK - 1) / kBK : t0;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    const int nk = min(kBK, Sk - k0);
    for (int r = warp; r < kBK; r += kThreads / 32) {
      const bool ok = r < nk;
      const long long off = (long long)(k0 + r) * D;
      for (int c = lane; c < D; c += 32) {
        Ks[r * DP + c] = ok ? to_f(kh[off + c]) : 0.f;
        Vs[r * D + c] = ok ? to_f(vh[off + c]) : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
    __syncthreads();                 // the k tile is read; Ps overwrites it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const bool ok = kk < nk && live(q0 + r + q_offset, k0 + kk, causal,
                                        window);
        Ps[r * kPS + kk] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // (m, l) of each row, one warp a row; p overwrites the scores
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      const int qp = q0 + r + q_offset;
      const float a = Ps[r * kPS + lane], b = Ps[r * kPS + lane + 32];
      float mx = fmaxf(a, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const bool oka = lane < nk && live(qp, k0 + lane, causal, window);
      const bool okb = lane + 32 < nk &&
                       live(qp, k0 + lane + 32, causal, window);
      const float pa = oka ? expf(a - m_new) : 0.f;
      const float pb = okb ? expf(b - m_new) : 0.f;
      float sum = pa + pb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[r * kPS + lane] = pa;
      Ps[r * kPS + lane + 32] = pb;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= al;
    }
    for (int j = 0; j < nk; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = Vs[j * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
    __syncthreads();                 // before the next tile overwrites
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      T* orow = out + ((long long)h * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) orow[d] = from_f<T>(acc[i][c] / l);
      }
    }
  }
  if (tid < nq)
    lse[(long long)h * Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BHq, int G, int Sq, int Sk, int D, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const int bytes = 4 * smem_floats(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BHq, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, G, Sq, Sk,
      D, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q (BHq, Sq, D), k and v (BHq / G, Sk, D),
// out like q, lse (BHq, Sq) float32; all contiguous, 1 <= D <= 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int BHq, int G, int Sq, int Sk,
                         int D, float scale, int causal, int window,
                         int q_offset, int dtype, void* stream) {
  if (BHq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (D < 1 || D > kDMax || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                         window, q_offset, s);
  return launch<__nv_bfloat16>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale,
                               causal, window, q_offset, s);
}
