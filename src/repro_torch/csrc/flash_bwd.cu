// FlashAttention-2 backward for Hopper (sm_90a), float32 arithmetic on the
// CUDA cores: two kernels, dK/dV and dQ.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_bwd, its two
// Pallas TPU kernels (_dkv_kernel, grid (BHkv, Tk, G, Tq), and _dq_kernel,
// grid (BHq, Tq, Tk)), behind kernels/flash_attention/ops.py::mha's custom
// VJP, which the transformer's training step runs once a layer.  q, dout and
// dq are (B*Hq, Sq, D), k, v, dk and dv (B*Hkv, Sk, D); q head h reads kv
// head h / G (G = Hq / Hkv); lse (the forward's logsumexp) and delta
// (sum(out * dout) over D, computed by the caller) are (B*Hq, Sq) float32.
// The mask is flash_fwd's: a key at position kp is live for the query at
// position qp = row + q_offset when kp <= qp (causal) and kp > qp - window
// (window > 0).  Both kernels recompute, for a (q tile, k tile) pair,
//   s = q k^T * scale,  p = live ? exp(s - lse) : 0,  dp = dout v^T,
//   ds = p * (dp - delta) * scale,
// and accumulate in float32 dv += p^T dout and dk += ds^T q (dK/dV kernel)
// or dq += ds k (dQ kernel), written once in the inputs' dtype.
//
// What bounds it: operations.  At train_4k of h2o-danube-3-4b (S 4096, 32 q
// heads, D 120, window 4096) the dK/dV kernel does 8*D flops on each of
// 8.39 M live pairs a head and the dQ kernel 6*D, 2.6e11 and 1.9e11 flops a
// layer, against ~0.1 GB of inputs and outputs.  This first version runs
// them as float32 FMAs on the CUDA cores (a later one moves them to the
// tensor cores, as for flash_fwd).  The design:
//   * dK/dV: grid (B*Hkv, ceil(Sk/64)), 256 threads a block.  A block keeps
//     its 64-key k and v tiles in shared memory and their dk and dv in
//     registers, loops over the G q heads of its kv head and, for each, over
//     only the q tiles that hold a row the mask lets see one of its keys
//     (q_tiles in kernel.py mirrors these bounds), and writes dk and dv
//     once.  No atomics: a result does not depend on the order in which
//     blocks run, and a second run gives the same bits.  Under a causal mask
//     the first key tiles see the most rows, and they are scheduled first.
//   * dQ: grid (B*Hq, ceil(Sq/64)): a block keeps its q and dout tiles and
//     the rows' lse and delta on chip and loops over the kv tiles that
//     kv_tiles gives (flash_fwd's bounds); ds goes to shared memory over the
//     v tile once dp is formed.  Blocks take q tiles from the last down, so
//     the heaviest rows of a causal mask are scheduled first.
//   * each thread computes a 4 x 4 register tile of the 64 x 64 s and dp
//     (rows ty + 16i, keys tx + 16j) and accumulates 4 rows x ceil(D/16)
//     columns; tiles are f32 in shared memory with the rows padded to an odd
//     stride, so that the 16 key lanes of a warp hit 16 banks;
//   * ragged tails: rows past Sq and keys past Sk are masked (their p is 0)
//     and not written, so any Sq, Sk >= 1 work (Pallas needs multiples of
//     the block).  A row with no live key has p = 0 everywhere and
//     contributes nothing; its dq is 0.
// D may be at most 128 (kDMax).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // q rows a tile
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr int kDC = kDMax / 16;    // accumulator columns a thread
constexpr int kPS = kBK + 1;       // p / ds tile row stride

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

// rows [0, n) of a contiguous (rows, D) slab into a 64-row f32 tile of row
// stride DP; rows past n are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int n, int D, int DP) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[r * DP + c] = r < n ? to_f(src[e]) : 0.f;
  }
}

// s = Q K^T and dp = dO V^T for the thread's rows ty + 16i, keys tx + 16j
__device__ __forceinline__ void products(const float* Qs, const float* Os,
                                         const float* Ks, const float* Vs,
                                         int D, int DP, int tx, int ty,
                                         float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; ++c) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * DP + c];
      oa[i] = Os[(ty + 16 * i) * DP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = Ks[(tx + 16 * j) * DP + c];
      vb[j] = Vs[(tx + 16 * j) * DP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
}

// shared memory of a dK/dV block, in floats: k, v, q, dout tiles (64 x DP
// each), p and ds (64 x kPS each), lse and delta of the q rows
__host__ __device__ inline int dkv_smem_floats(int D) {
  return 4 * 64 * (D | 1) + 2 * kBQ * kPS + 2 * kBQ;
}

// of a dQ block: q, dout, k tiles, then the v tile which ds reuses
__host__ __device__ inline int dq_smem_floats(int D) {
  const int t = 64 * (D | 1);
  return 3 * t + (t > kBQ * kPS ? t : kBQ * kPS) + 2 * kBQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int G, int Sq, int Sk, int D,
                     float scale, int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D | 1;
  float* Ks = smem;
  float* Vs = Ks + kBK * DP;
  float* Qs = Vs + kBK * DP;
  float* Os = Qs + kBQ * DP;
  float* Ps = Os + kBQ * DP;
  float* Ss = Ps + kBQ * kPS;
  float* lse_s = Ss + kBQ * kPS;
  float* dl_s = lse_s + kBQ;

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int nk = min(kBK, Sk - k0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  load_tile(Ks, k + ((long long)hk * Sk + k0) * D, nk, D, DP);
  load_tile(Vs, v + ((long long)hk * Sk + k0) * D, nk, D, DP);
  float ak[4][kDC], av[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) ak[i][c] = av[i][c] = 0.f;

  // the rows that see a key of the tile: qp >= k0 (causal) and
  // qp < k0 + nk - 1 + window (window), in whole q tiles
  const int rbeg = causal ? max(0, k0 - q_offset) : 0;
  const int rend = window > 0 ? min(Sq, k0 + nk - 1 + window - q_offset) : Sq;
  const int t0 = rbeg / kBQ;
  const int t1 = rend > rbeg ? (rend + kBQ - 1) / kBQ : t0;

  for (int g = 0; g < G; ++g) {
    const long long row0 = (long long)(hk * G + g) * Sq;
    for (int t = t0; t < t1; ++t) {
      const int q0 = t * kBQ;
      const int nq = min(kBQ, Sq - q0);
      __syncthreads();               // the last tile's p, ds, q, dout read
      load_tile(Qs, q + (row0 + q0) * D, nq, D, DP);
      load_tile(Os, dout + (row0 + q0) * D, nq, D, DP);
      if (tid < kBQ) {
        lse_s[tid] = tid < nq ? lse[row0 + q0 + tid] : 0.f;
        dl_s[tid] = tid < nq ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      products(Qs, Os, Ks, Vs, D, DP, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qp = q0 + r + q_offset;
        const float L = lse_s[r], dl = dl_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = tx + 16 * j;
          const bool ok = r < nq && kk < nk &&
                          live(qp, k0 + kk, causal, window);
          const float p = ok ? expf(s[i][j] * scale - L) : 0.f;
          Ps[r * kPS + kk] = p;
          Ss[r * kPS + kk] = p * (dp[i][j] - dl) * scale;
        }
      }
      __syncthreads();

      // dv += p^T dout, dk += ds^T q over the tile's rows
      for (int r = 0; r < nq; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * kPS + ty + 16 * i];
          sv[i] = Ss[r * kPS + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            const float o = Os[r * DP + d], qq = Qs[r * DP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              av[i][c] = fmaf(pv[i], o, av[i][c]);
              ak[i][c] = fmaf(sv[i], qq, ak[i][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nk) {
      const long long off = ((long long)hk * Sk + k0 + r) * D;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          dk[off + d] = from_f<T>(ak[i][c]);
          dv[off + d] = from_f<T>(av[i][c]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int G, int Sq, int Sk, int D, float scale, int causal,
                    int window, int q_offset) {
  extern __shared__ float smem[];
  const int DP = D | 1;
  float* Qs = smem;
  float* Os = Qs + kBQ * DP;
  float* Ks = Os + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ss = Vs;                                   // after dp is formed
  const int vt = kBK * DP > kBQ * kPS ? kBK * DP : kBQ * kPS;
  float* lse_s = Vs + vt;
  float* dl_s = lse_s + kBQ;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long row0 = (long long)h * Sq + q0;
  const T* kh = k + (long long)(h / G) * Sk * D;
  const T* vh = v + (long long)(h / G) * Sk * D;
  load_tile(Qs, q + row0 * D, nq, D, DP);
  load_tile(Os, dout + row0 * D, nq, D, DP);
  if (tid < kBQ) {
    lse_s[tid] = tid < nq ? lse[row0 + tid] : 0.f;
    dl_s[tid] = tid < nq ? delta[row0 + tid] : 0.f;
  }
  float aq[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) aq[i][c] = 0.f;

  // the live key range of the block's rows, in whole tiles (flash_fwd's)
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  const int t0 = kbeg / kBK;
  const int t1 = kend > kbeg ? (kend + kBK - 1) / kBK : t0;

  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    const int nk = min(kBK, Sk - k0);
    __syncthreads();                 // the last tile's ds and k read
    load_tile(Ks, kh + (long long)k0 * D, nk, D, DP);
    load_tile(Vs, vh + (long long)k0 * D, nk, D, DP);
    __syncthreads();

    float s[4][4], dp[4][4];
    products(Qs, Os, Ks, Vs, D, DP, tx, ty, s, dp);
    __syncthreads();                 // v is read; ds overwrites it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r + q_offset;
      const float L = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const bool ok = r < nq && kk < nk &&
                        live(qp, k0 + kk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - L) : 0.f;
        Ss[r * kPS + kk] = p * (dp[i][j] - dl) * scale;
      }
    }
    __syncthreads();

    // dq += ds k over the tile's keys
    for (int kk = 0; kk < nk; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float kv = Ks[kk * DP + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) aq[i][c] = fmaf(sv[i], kv, aq[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      T* row = dq + (row0 + r) * D;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) row[d] = from_f<T>(aq[i][c]);
      }
    }
  }
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int BHkv, int G, int Sq, int Sk, int D, float scale,
               int causal, int window, int q_offset, cudaStream_t stream) {
  const int bytes = 4 * dkv_smem_floats(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BHkv, (unsigned)((Sk + kBK - 1) / kBK));
  flash_bwd_dkv_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, G, Sq, Sk, D,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BHq, int G,
              int Sq, int Sk, int D, float scale, int causal, int window,
              int q_offset, cudaStream_t stream) {
  const int bytes = 4 * dq_smem_floats(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BHq, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_bwd_dq_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, G, Sq, Sk, D, scale,
      causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q and dout (BHkv * G, Sq, D), k, v, dk, dv
// (BHkv, Sk, D), lse and delta (BHkv * G, Sq) float32; all contiguous,
// 1 <= D <= 128, Sk >= 1.  Writes every element of dk and dv.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int BHkv,
                             int G, int Sq, int Sk, int D, float scale,
                             int causal, int window, int q_offset, int dtype,
                             void* stream) {
  if (BHkv <= 0 || Sk <= 0) return (int)cudaGetLastError();
  if (D < 1 || D > kDMax || G < 1 || Sq < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BHkv, G, Sq,
                             Sk, D, scale, causal, window, q_offset, s);
  return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BHkv,
                                   G, Sq, Sk, D, scale, causal, window,
                                   q_offset, s);
}

// The same layout; writes every element of dq (BHq, Sq, D).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BHq, int G,
                            int Sq, int Sk, int D, float scale, int causal,
                            int window, int q_offset, int dtype,
                            void* stream) {
  if (BHq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (D < 1 || D > kDMax || G < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, BHq, G, Sq, Sk, D,
                            scale, causal, window, q_offset, s);
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BHq, G, Sq,
                                  Sk, D, scale, causal, window, q_offset, s);
}
