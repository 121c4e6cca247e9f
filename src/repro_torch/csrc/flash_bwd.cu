// FlashAttention-2 backward for Hopper (sm_90a): two kernels, dK/dV and dQ.
// Both run bf16 inputs on the tensor cores (mma.sync) and float32 inputs on
// the CUDA cores.
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
// layer, against ~0.1 GB of inputs and outputs: 0.26 and 0.20 ms at the
// bf16 tensor-core rate.  The designs:
//   * dK/dV, both dtypes: grid (B*Hkv, ceil(Sk/64)).  A block keeps its
//     64-key k and v tiles in shared memory and their dk and dv in
//     registers, loops over the G q heads of its kv head and, for each, over
//     only the q tiles that hold a row the mask lets see one of its keys
//     (q_tiles in kernel.py mirrors these bounds), and writes dk and dv
//     once.  No atomics: a result does not depend on the order in which
//     blocks run, and a second run gives the same bits.  Under a causal mask
//     the first key tiles see the most rows, and they are scheduled first.
//   * dK/dV, bf16 (flash_bwd_dkv_tc_kernel): 4 warps, 16 keys a warp, in
//     the key-row orientation of the FlashAttention-2 backward.  Per q tile
//     of 64 rows, S^T = K Q^T and dP^T = V dout^T on the tensor cores (k and
//     v as A fragments, q and dout as B fragments), p and ds from them in
//     registers (exp2, scale*log2(e) folded in, lse and delta of the tile's
//     rows from shared memory), then dV += P^T dout and dK += dS^T Q with
//     P^T and dS^T, rounded to bf16, as A fragments straight from the S^T
//     and dP^T accumulators (flash_mma.cuh): only those two operands are
//     rounded.  q, dout, lse and delta stream through two stages of
//     cp.async, so the next q tile arrives while this one is multiplied;
//     ~103 KB of shared memory and at most 255 registers a thread (no
//     spills, ptxas -v) let two blocks (8 warps) share an SM.  The mask is
//     tested only on the tiles that need it (tile_class: diagonal tiles,
//     the window's edge, ragged tails); a warp skips the q tiles that see
//     none of its keys.
//   * dK/dV, float32 (flash_bwd_dkv_kernel): each thread computes a 4 x 4
//     register tile of the 64 x 64 s and dp (rows ty + 16i, keys tx + 16j)
//     and accumulates 4 rows x ceil(D/16) columns; p and ds go through
//     shared memory; tiles are f32 in shared memory with the rows padded to
//     an odd stride, so that the 16 key lanes of a warp hit 16 banks.
//   * dQ, both dtypes: grid (B*Hq, ceil(Sq/64)): a block keeps its q and
//     dout tiles and the rows' lse and delta on chip and loops over the kv
//     tiles that kv_tiles gives (flash_fwd's bounds).  Blocks take q tiles
//     from the last down, so the heaviest rows of a causal mask are
//     scheduled first.
//   * dQ, bf16 (flash_bwd_dq_tc_kernel): 4 warps, 16 q rows a warp, in the
//     forward's orientation.  Per 64-key tile, S = Q K^T and dP = dout V^T
//     on the tensor cores (q and dout as A fragments, k and v as B
//     fragments), p and ds from them in registers (exp2, scale*log2(e)
//     folded in, each lane's two rows' lse and delta held in registers for
//     the whole loop), then dQ += dS K with dS, rounded to bf16, as the A
//     fragment straight from the dP accumulators and k read by
//     ldmatrix.trans as the B operand (the forward's P V): only ds is
//     rounded.  k and v stream through two stages of cp.async.  16 rows a
//     warp rather than the forward's 32: a 128-row block would hold q and
//     dout tiles beside the two k/v stages, 139 KB, one block (4 warps) an
//     SM; 64 rows take ~103 KB, two blocks (8 warps) an SM, and the S, dP
//     and dQ accumulators of a 64-key step (32 + 32 + 60 floats at D 120)
//     stay inside 255 registers (no spills, ptxas -v).  dq stays f32 in
//     registers and is written once: no atomics, the same bits every run.
//   * dQ, float32 (flash_bwd_dq_kernel, CUDA cores, as dK/dV float32): ds
//     goes to shared memory over the v tile once dp is formed.
//   * ragged tails: rows past Sq and keys past Sk are masked (their p is 0)
//     and not written, so any Sq, Sk >= 1 work (Pallas needs multiples of
//     the block).  A row with no live key has p = 0 everywhere and
//     contributes nothing; its dq is 0.
// D may be at most 128 (kDMax).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;            // q rows a tile
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr int kDC = kDMax / 16;    // accumulator columns a thread
constexpr int kPS = kBK + 1;       // p / ds tile row stride

__device__ __forceinline__ bool live(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// rows [0, n) of a contiguous (rows, D) slab into a 64-row f32 tile of row
// stride DP; rows past n are zero
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int n, int D, int DP) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    dst[r * DP + c] = r < n ? src[e] : 0.f;
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

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int G, int Sq, int Sk, int D,
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
          dk[off + d] = ak[i][c];
          dv[off + d] = av[i][c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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
  const float* kh = k + (long long)(h / G) * Sk * D;
  const float* vh = v + (long long)(h / G) * Sk * D;
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
      float* row = dq + (row0 + r) * D;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) row[d] = aq[i][c];
      }
    }
  }
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int BHkv, int G, int Sq, int Sk, int D, float scale,
               int causal, int window, int q_offset, cudaStream_t stream) {
  const int bytes = 4 * dkv_smem_floats(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BHkv, (unsigned)((Sk + kBK - 1) / kBK));
  flash_bwd_dkv_kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, G, Sq,
      Sk, D, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BHq, int G,
              int Sq, int Sk, int D, float scale, int causal, int window,
              int q_offset, cudaStream_t stream) {
  const int bytes = 4 * dq_smem_floats(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BHq, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_bwd_dq_kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, G, Sq, Sk, D, scale,
      causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 dK/dV: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace fm = flash_mma;

constexpr int kTcBK = 64;                     // keys a block, 16 a warp
constexpr int kTcBQ = 64;                     // q rows a tile
constexpr int kTcThreads = 32 * kTcBK / 16;   // 128
constexpr int kTcQN = kTcBQ / 8;              // n8 tiles of q rows

// shared memory of a block in bytes, for a row stride of ST bf16: the k and
// v tiles, two stages of (q tile, dout tile), two stages of (lse, delta)
constexpr int dkv_tc_smem_bytes(int ST) {
  return 2 * (2 * kTcBK + 4 * kTcBQ) * ST + 4 * 4 * kTcBQ;
}

template <int NT>                             // n8 tiles of the head dim
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkv_tc_kernel(const fm::bf16* __restrict__ q,
                        const fm::bf16* __restrict__ k,
                        const fm::bf16* __restrict__ v,
                        const fm::bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        fm::bf16* __restrict__ dk, fm::bf16* __restrict__ dv,
                        int G, int Sq, int Sk, int D, float scale,
                        float scale_log2, int causal, int window,
                        int q_offset, int vec) {
  constexpr int KS = (NT + 1) / 2;            // k16 steps over the head dim
  constexpr int DP = 16 * KS;
  constexpr int ST = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* Ks = reinterpret_cast<fm::bf16*>(smem_raw);
  fm::bf16* Vs = Ks + kTcBK * ST;
  fm::bf16* QO = Vs + kTcBK * ST;   // stage s: q at 2 s kTcBQ rows, dout after
  float* LD = reinterpret_cast<float*>(QO + 4 * kTcBQ * ST);  // lse, delta

  const int hk = blockIdx.x;
  const int k0 = blockIdx.y * kTcBK;
  const int nk = min(kTcBK, Sk - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = k0 + 16 * warp;              // the warp's first key
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  fm::zero_cols<kTcThreads>(Ks, 2 * kTcBK + 4 * kTcBQ, D, DP, ST);
  fm::load_tile<kTcThreads>(Ks, k + ((long long)hk * Sk + k0) * D, nk, kTcBK,
                            D, ST, vec);
  fm::load_tile<kTcThreads>(Vs, v + ((long long)hk * Sk + k0) * D, nk, kTcBK,
                            D, ST, vec);
  // the rows that see a key of the tile, in whole q tiles (q_tiles)
  const int rbeg = causal ? max(0, k0 - q_offset) : 0;
  const int rend = window > 0 ? min(Sq, k0 + nk - 1 + window - q_offset) : Sq;
  const int t0 = rbeg / kTcBQ;
  const int nt = rend > rbeg ? (rend + kTcBQ - 1) / kTcBQ - t0 : 0;
  const int n = G * nt;                       // (q head, q tile) steps
  auto load_q = [&](int i, int s) {
    const int gq = i / nt, q0 = (t0 + i - gq * nt) * kTcBQ;
    const int rows = min(kTcBQ, Sq - q0);
    const long long row0 = (long long)(hk * G + gq) * Sq + q0;
    fm::bf16* Qs = QO + 2 * s * kTcBQ * ST;
    fm::load_tile<kTcThreads>(Qs, q + row0 * D, rows, kTcBQ, D, ST, vec);
    fm::load_tile<kTcThreads>(Qs + kTcBQ * ST, dout + row0 * D, rows, kTcBQ,
                              D, ST, vec);
    float* L = LD + 2 * s * kTcBQ;
    for (int r = threadIdx.x; r < 2 * kTcBQ; r += kTcThreads) {
      const int rr = r & (kTcBQ - 1);
      const bool ok = rr < rows;
      fm::cp_async4(L + r, (r < kTcBQ ? lse : delta) + row0 + (ok ? rr : 0),
                    ok);
    }
  };
  if (n > 0) load_q(0, 0);
  fm::cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  const uint32_t k_a = fm::smem_u32(Ks + 16 * warp * ST + fm::a_off(lane, ST));
  const uint32_t v_a = fm::smem_u32(Vs + 16 * warp * ST + fm::a_off(lane, ST));
  const uint32_t qo_b = fm::smem_u32(QO + fm::b_off(lane, ST));
  const uint32_t qo_t = fm::smem_u32(QO + fm::a_off(lane, ST));

  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    if (i + 1 < n) load_q(i + 1, s ^ 1);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();            // step i's tiles are in
    __syncthreads();
    const int gq = i / nt, q0 = (t0 + i - gq * nt) * kTcBQ;
    const int cls = fm::tile_class(q0, kTcBQ, Sq, kw, 16, Sk, causal, window,
                                   q_offset);
    if (cls != fm::kSkip) {
      const uint32_t qs = 2u * 2 * s * kTcBQ * ST;   // the q tile, bytes
      const uint32_t os = qs + 2u * kTcBQ * ST;       // the dout tile
      float st[kTcQN][4], dpt[kTcQN][4];
#pragma unroll
      for (int j = 0; j < kTcQN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        fm::ldsm_x4(ak, k_a + 32u * kk);
        fm::ldsm_x4(av, v_a + 32u * kk);
#pragma unroll
        for (int j = 0; j < kTcQN / 2; ++j) {
          const uint32_t off = 2u * (16 * j * ST + 16 * kk);
          uint32_t b[4];
          fm::ldsm_x4(b, qo_b + qs + off);
          fm::mma_bf16(st[2 * j], ak, b[0], b[1]);
          fm::mma_bf16(st[2 * j + 1], ak, b[2], b[3]);
          fm::ldsm_x4(b, qo_b + os + off);
          fm::mma_bf16(dpt[2 * j], av, b[0], b[1]);
          fm::mma_bf16(dpt[2 * j + 1], av, b[2], b[3]);
        }
      }
      // element (j, e): key kw + g + 8 (e / 2), q row q0 + 8 j + c2 + e % 2
      const float* L = LD + 2 * s * kTcBQ;
#pragma unroll
      for (int j = 0; j < kTcQN; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(L + 8 * j + c2);
        const float2 dj =
            *reinterpret_cast<const float2*>(L + kTcBQ + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = cls == fm::kFull;
          if (!ok) {
            const int kp = kw + g + 8 * (e >> 1);
            const int qr = q0 + 8 * j + c2 + (e & 1);
            ok = kp < Sk && qr < Sq &&
                 fm::live(qr + q_offset, kp, causal, window);
          }
          const float lq = (e & 1) ? lj.y : lj.x;
          const float dl = (e & 1) ? dj.y : dj.x;
          const float p =
              ok ? exp2f(st[j][e] * scale_log2 - lq * fm::kLog2e) : 0.f;
          dpt[j][e] = p * (dpt[j][e] - dl) * scale;
          st[j][e] = p;
        }
      }
      // dV += P^T dout, dK += dS^T Q over the tile's 64 rows
#pragma unroll
      for (int j = 0; j < kTcQN / 2; ++j) {
        uint32_t ap[4], ad[4];
        fm::c_to_a(ap, st[2 * j], st[2 * j + 1]);
        fm::c_to_a(ad, dpt[2 * j], dpt[2 * j + 1]);
        const uint32_t oj = qo_t + os + 2u * 16 * j * ST;
        const uint32_t qj = qo_t + qs + 2u * 16 * j * ST;
#pragma unroll
        for (int c = 0; c < NT / 2; ++c) {
          uint32_t b[4];
          fm::ldsm_x4_t(b, oj + 32u * c);
          fm::mma_bf16(dva[2 * c], ap, b[0], b[1]);
          fm::mma_bf16(dva[2 * c + 1], ap, b[2], b[3]);
          fm::ldsm_x4_t(b, qj + 32u * c);
          fm::mma_bf16(dka[2 * c], ad, b[0], b[1]);
          fm::mma_bf16(dka[2 * c + 1], ad, b[2], b[3]);
        }
        if (NT & 1) {
          uint32_t b[2];
          fm::ldsm_x2_t(b, oj + 16u * (NT - 1));
          fm::mma_bf16(dva[NT - 1], ap, b[0], b[1]);
          fm::ldsm_x2_t(b, qj + 16u * (NT - 1));
          fm::mma_bf16(dka[NT - 1], ad, b[0], b[1]);
        }
      }
    }
    __syncthreads();                   // before step i + 2 overwrites stage s
  }
  fm::cp_async_wait<0>();            // none in flight at exit

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw + g + 8 * hr;
    if (key < k0 + nk) {
      const long long off = ((long long)hk * Sk + key) * D;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const int d = 8 * c + c2;
        const float k0v = dka[c][2 * hr], k1v = dka[c][2 * hr + 1];
        const float v0v = dva[c][2 * hr], v1v = dva[c][2 * hr + 1];
        if (d + 1 < D && !(D & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
              __floats2bfloat162_rn(k0v, k1v);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
              __floats2bfloat162_rn(v0v, v1v);
        } else {
          if (d < D) {
            dk[off + d] = __float2bfloat16_rn(k0v);
            dv[off + d] = __float2bfloat16_rn(v0v);
          }
          if (d + 1 < D) {
            dk[off + d + 1] = __float2bfloat16_rn(k1v);
            dv[off + d + 1] = __float2bfloat16_rn(v1v);
          }
        }
      }
    }
  }
}

__host__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

template <int NT>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int BHkv, int G, int Sq, int Sk, int D,
                  float scale, int causal, int window, int q_offset,
                  cudaStream_t stream) {
  const int bytes = dkv_tc_smem_bytes(16 * ((NT + 1) / 2) + 8);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  dim3 grid((unsigned)BHkv, (unsigned)((Sk + kTcBK - 1) / kTcBK));
  flash_bwd_dkv_tc_kernel<NT><<<grid, kTcThreads, bytes, stream>>>(
      (const fm::bf16*)q, (const fm::bf16*)k, (const fm::bf16*)v,
      (const fm::bf16*)dout, (const float*)lse, (const float*)delta,
      (fm::bf16*)dk, (fm::bf16*)dv, G, Sq, Sk, D, scale, scale * fm::kLog2e,
      causal, window, q_offset, vec);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, NT>{}) for the smallest instantiated n8
// tile count NT (2, 4, 8, 15, 16) that covers D
template <typename F>
int with_nt(int D, F f) {
  const int nt = (D + 7) / 8;
  if (nt <= 2) return f(std::integral_constant<int, 2>{});
  if (nt <= 4) return f(std::integral_constant<int, 4>{});
  if (nt <= 8) return f(std::integral_constant<int, 8>{});
  if (nt <= 15) return f(std::integral_constant<int, 15>{});
  return f(std::integral_constant<int, 16>{});
}

// ---------------------------------------------------------------------------
// bf16 dQ: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kDqWarps = 4;
constexpr int kDqBQ = 16 * kDqWarps;          // q rows a block, 16 a warp
constexpr int kDqBK = 64;                     // keys a tile
constexpr int kDqThreads = 32 * kDqWarps;     // 128
constexpr int kDqKN = kDqBK / 8;              // n8 tiles of keys

// shared memory of a block in bytes, for a row stride of ST bf16: the q and
// dout tiles and two stages of (k tile, v tile)
constexpr int dq_tc_smem_bytes(int ST) {
  return 2 * (2 * kDqBQ + 4 * kDqBK) * ST;
}

// One warp's step over a 64-key k/v tile: S = Q K^T and dP = dout V^T for
// its 16 rows, p = exp2(S scale log2(e) - lse log2(e)) and dS = p (dP -
// delta) scale in registers, dQ += dS K with dS rounded to bf16 as the A
// operand.  kMask: test the mask on each pair (tile_class kMasked), else
// every pair is live (kFull).  Lane (g, c2) holds rows row0 + 8 h (index
// h = 0, 1) and the keys kc + 8 j + {0, 1} of each n8 tile j; ll[h] and
// dl[h] are its rows' lse log2(e) and delta.  q_a, o_a: the lane's ldmatrix
// addresses in the warp's q and dout rows; k_b, v_b: in the stage's k and v
// tiles as B fragments (Q K^T, dout V^T); k_t: in the k tile as the
// transposed B fragments of dS K.
template <int NT, bool kMask>
__device__ __forceinline__ void dq_tile(float (&dq)[NT][4], uint32_t q_a,
                                        uint32_t o_a, uint32_t k_b,
                                        uint32_t v_b, uint32_t k_t,
                                        const float (&ll)[2],
                                        const float (&dl)[2], float scale,
                                        float scale_log2, int row0, int kc,
                                        int Sq, int Sk, int causal,
                                        int window, int q_offset) {
  constexpr int KS = (NT + 1) / 2;
  constexpr int ST = 16 * KS + 8;
  float s[kDqKN][4], dp[kDqKN][4];
#pragma unroll
  for (int j = 0; j < kDqKN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t aq[4], ao[4];
    fm::ldsm_x4(aq, q_a + 32u * kk);
    fm::ldsm_x4(ao, o_a + 32u * kk);
#pragma unroll
    for (int j = 0; j < kDqKN / 2; ++j) {
      const uint32_t off = 2u * (16 * j * ST + 16 * kk);
      uint32_t b[4];
      fm::ldsm_x4(b, k_b + off);
      fm::mma_bf16(s[2 * j], aq, b[0], b[1]);
      fm::mma_bf16(s[2 * j + 1], aq, b[2], b[3]);
      fm::ldsm_x4(b, v_b + off);
      fm::mma_bf16(dp[2 * j], ao, b[0], b[1]);
      fm::mma_bf16(dp[2 * j + 1], ao, b[2], b[3]);
    }
  }
  // element (j, e): row row0 + 8 (e / 2), key kc + 8 j + e % 2; a masked
  // pair's p is 0 (its exponent may be anything, lse of a row with no live
  // key is NEG_INF)
#pragma unroll
  for (int j = 0; j < kDqKN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      bool ok = true;
      if (kMask) {
        const int row = row0 + 8 * h, kp = kc + 8 * j + (e & 1);
        ok = row < Sq && kp < Sk &&
             fm::live(row + q_offset, kp, causal, window);
      }
      const float p = ok ? fm::ex2(s[j][e] * scale_log2 - ll[h]) : 0.f;
      dp[j][e] = p * (dp[j][e] - dl[h]) * scale;
    }
  // dQ += dS K over the tile's 64 keys, dS rounded to bf16 as the A operand
#pragma unroll
  for (int j = 0; j < kDqKN / 2; ++j) {
    uint32_t a[4];
    fm::c_to_a(a, dp[2 * j], dp[2 * j + 1]);
    const uint32_t kj = k_t + 2u * 16 * j * ST;
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t b[4];
      fm::ldsm_x4_t(b, kj + 2u * 16 * n);
      fm::mma_bf16(dq[2 * n], a, b[0], b[1]);
      fm::mma_bf16(dq[2 * n + 1], a, b[2], b[3]);
    }
    if (NT & 1) {
      uint32_t b[2];
      fm::ldsm_x2_t(b, kj + 2u * 8 * (NT - 1));
      fm::mma_bf16(dq[NT - 1], a, b[0], b[1]);
    }
  }
}

template <int NT>                             // n8 tiles of the head dim
__global__ void __launch_bounds__(kDqThreads, 2)
flash_bwd_dq_tc_kernel(const fm::bf16* __restrict__ q,
                       const fm::bf16* __restrict__ k,
                       const fm::bf16* __restrict__ v,
                       const fm::bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       fm::bf16* __restrict__ dq, int G, int Sq, int Sk,
                       int D, float scale, float scale_log2, int causal,
                       int window, int q_offset, int vec) {
  constexpr int KS = (NT + 1) / 2;            // k16 steps over the head dim
  constexpr int DP = 16 * KS;
  constexpr int ST = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* Qs = reinterpret_cast<fm::bf16*>(smem_raw);
  fm::bf16* Os = Qs + kDqBQ * ST;
  fm::bf16* KV = Os + kDqBQ * ST;   // stage s: k at 2 s kDqBK rows, v after

  const int h = blockIdx.x;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kDqBQ;
  const int nq = min(kDqBQ, Sq - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = q0 + 16 * warp;              // the warp's first row
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const long long row0 = (long long)h * Sq;
  const fm::bf16* kh = k + (long long)(h / G) * Sk * D;
  const fm::bf16* vh = v + (long long)(h / G) * Sk * D;

  fm::zero_cols<kDqThreads>(Qs, 2 * kDqBQ + 4 * kDqBK, D, DP, ST);
  fm::load_tile<kDqThreads>(Qs, q + (row0 + q0) * D, nq, kDqBQ, D, ST, vec);
  fm::load_tile<kDqThreads>(Os, dout + (row0 + q0) * D, nq, kDqBQ, D, ST,
                            vec);
  // the live key range of the block's rows, in whole tiles (kv_tiles)
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  const int t0 = kbeg / kDqBK;
  const int t1 = kend > kbeg ? (kend + kDqBK - 1) / kDqBK : t0;
  auto load_kv = [&](int t, int s) {
    const int k0 = t * kDqBK, n = min(kDqBK, Sk - k0);
    fm::bf16* Ks = KV + 2 * s * kDqBK * ST;
    fm::load_tile<kDqThreads>(Ks, kh + (long long)k0 * D, n, kDqBK, D, ST,
                              vec);
    fm::load_tile<kDqThreads>(Ks + kDqBK * ST, vh + (long long)k0 * D, n,
                              kDqBK, D, ST, vec);
  };
  if (t0 < t1) load_kv(t0, 0);
  fm::cp_async_commit();

  // the lane's rows r0 + g and r0 + g + 8: lse log2(e) and delta
  float ll[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    ll[hr] = row < Sq ? lse[row0 + row] * fm::kLog2e : 0.f;
    dl[hr] = row < Sq ? delta[row0 + row] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const uint32_t q_a = fm::smem_u32(Qs + 16 * warp * ST + fm::a_off(lane, ST));
  const uint32_t o_a = fm::smem_u32(Os + 16 * warp * ST + fm::a_off(lane, ST));
  const uint32_t k_b = fm::smem_u32(KV + fm::b_off(lane, ST));
  const uint32_t v_b = fm::smem_u32(KV + kDqBK * ST + fm::b_off(lane, ST));
  const uint32_t k_t = fm::smem_u32(KV + fm::a_off(lane, ST));

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) load_kv(t + 1, s ^ 1);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();            // tile t (and q, dout) are in
    __syncthreads();
    const int k0 = t * kDqBK;
    const uint32_t stage = 2u * 2 * s * kDqBK * ST;   // bytes
    const int cls = fm::tile_class(r0, 16, Sq, k0, kDqBK, Sk, causal, window,
                                   q_offset);
    if (cls == fm::kFull)
      dq_tile<NT, false>(acc, q_a, o_a, k_b + stage, v_b + stage,
                         k_t + stage, ll, dl, scale, scale_log2, r0 + g,
                         k0 + c2, Sq, Sk, causal, window, q_offset);
    else if (cls == fm::kMasked)
      dq_tile<NT, true>(acc, q_a, o_a, k_b + stage, v_b + stage,
                        k_t + stage, ll, dl, scale, scale_log2, r0 + g,
                        k0 + c2, Sq, Sk, causal, window, q_offset);
    __syncthreads();                   // before tile t + 2 overwrites stage s
  }
  fm::cp_async_wait<0>();            // none in flight at exit

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row < Sq) {
      fm::bf16* drow = dq + (row0 + row) * D;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + c2;
        const float x0 = acc[n][2 * hr], x1 = acc[n][2 * hr + 1];
        if (c + 1 < D && !(D & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(drow + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < D) drow[c] = __float2bfloat16_rn(x0);
          if (c + 1 < D) drow[c + 1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

template <int NT>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int BHq, int G, int Sq, int Sk, int D, float scale,
                 int causal, int window, int q_offset, cudaStream_t stream) {
  const int bytes = dq_tc_smem_bytes(16 * ((NT + 1) / 2) + 8);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  dim3 grid((unsigned)BHq, (unsigned)((Sq + kDqBQ - 1) / kDqBQ));
  flash_bwd_dq_tc_kernel<NT><<<grid, kDqThreads, bytes, stream>>>(
      (const fm::bf16*)q, (const fm::bf16*)k, (const fm::bf16*)v,
      (const fm::bf16*)dout, (const float*)lse, (const float*)delta,
      (fm::bf16*)dq, G, Sq, Sk, D, scale, scale * fm::kLog2e, causal,
      window, q_offset, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the tensor-core
// kernels).  q and dout (BHkv * G, Sq, D), k, v, dk, dv
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
    return launch_dkv(q, k, v, dout, lse, delta, dk, dv, BHkv, G, Sq,
                             Sk, D, scale, causal, window, q_offset, s);
  return with_nt(D, [&](auto nt) {
    return launch_dkv_tc<decltype(nt)::value>(q, k, v, dout, lse, delta, dk,
                                              dv, BHkv, G, Sq, Sk, D, scale,
                                              causal, window, q_offset, s);
  });
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
    return launch_dq(q, k, v, dout, lse, delta, dq, BHq, G, Sq, Sk, D,
                            scale, causal, window, q_offset, s);
  return with_nt(D, [&](auto nt) {
    return launch_dq_tc<decltype(nt)::value>(q, k, v, dout, lse, delta, dq,
                                             BHq, G, Sq, Sk, D, scale, causal,
                                             window, q_offset, s);
  });
}
