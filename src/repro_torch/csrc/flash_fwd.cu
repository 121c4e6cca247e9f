// FlashAttention-2 forward for Hopper (sm_90a): bf16 inputs on the tensor
// cores (mma.sync), float32 inputs on the CUDA cores.
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
// flops, against 0.5 GB to read q, k, v and write out: 1.95 ms at the bf16
// tensor-core rate.  The route is chosen by dtype alone, in the entry point:
//
// bf16 (the model's path): flash_fwd_tc_kernel, mma.sync.m16n8k16 with f32
// accumulators (flash_mma.cuh has the fragment layout).  mma.sync rather
// than wgmma: it needs no TMA descriptors (the plain-C build stays), P goes
// from the S accumulators into the P V product without leaving registers,
// and it already beats SDPA's causal kernel at 4,096 positions; wgmma is
// left to a later kernel.
//   * grid (B*Hq, ceil(Sq/128)), 4 warps a block, 32 q rows a warp (two
//     m16 tiles that share every k and v fragment: half the shared-memory
//     reads a product of 16-row warps); the q blocks are launched from the
//     last down, the heaviest rows of a causal mask first;
//   * q, k and v stay bf16 in shared memory, D padded with zeros to a
//     multiple of 16 (120 -> 128) in rows of 16 more bytes (ldmatrix free
//     of bank conflicts); the 64-key k and v tiles stream through two
//     stages of cp.async (a thread a 16-byte column chunk, no division), so
//     the next tile arrives while this one is multiplied; a D that is not a
//     multiple of 8, or an unaligned tensor, is loaded element by element
//     into the same tiles;
//   * S = Q K^T and O += P V on the tensor cores; the online softmax runs
//     in registers (exp2 with scale*log2(e) folded in, one MUFU ex2 a
//     score; row max and sum over the four lanes of a row by shuffles; l
//     summed from the f32 p; O rescaled only when a row's max moved), and
//     only P is rounded to bf16, as the product's operand;
//   * the kv loop keeps the f32 kernel's bounds (kv_tiles in kernel.py);
//     each warp tests the mask only on the tiles that need it (tile_class:
//     diagonal tiles, the window's lower edge, ragged tails), skips the
//     tiles where its rows see no key and multiplies the rest unmasked; a
//     masked pair gets p = 0 explicitly;
//   * registers: 120 f32 accumulators of O at D 120 (ceil(D/8) n8 tiles,
//     fixed by the template: 2, 4, 8, 15, 16) and 64 of S for a 64-key
//     step, inside the 255 a thread that two 128-thread blocks an SM leave
//     with no spills (ptxas -v); masked tiles, and every tile at D > 120,
//     go in two 32-key steps.
//
// float32 (the model's f32 checks): flash_fwd_kernel, float32 FMAs on the
// CUDA cores:
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
//     thread accumulates 4 rows x ceil(D/16) columns of P V in registers.
// Both: rows past Sq are not written and keys past Sk are masked, so any
// Sq and Sk work (Pallas needs multiples of the block); D may be at most 128
// (kDMax).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

constexpr int kBQ = 64;            // q rows a block
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;
constexpr int kDMax = 128;
constexpr int kDC = kDMax / 16;    // accumulator columns a thread
constexpr int kPS = kBK + 1;       // score tile row stride
constexpr float kNegInf = -1e30f;  // NEG_INF of the reference

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

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
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
  const float* qh = q + ((long long)h * Sq + q0) * D;
  const float* kh = k + (long long)(h / G) * Sk * D;
  const float* vh = v + (long long)(h / G) * Sk * D;

  for (int r = warp; r < kBQ; r += kThreads / 32)
    for (int c = lane; c < D; c += 32)
      Qs[r * DP + c] = r < nq ? qh[(long long)r * D + c] : 0.f;
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
        Ks[r * DP + c] = ok ? kh[off + c] : 0.f;
        Vs[r * D + c] = ok ? vh[off + c] : 0.f;
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
      float* orow = out + ((long long)h * Sq + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) orow[d] = acc[i][c] / l;
      }
    }
  }
  if (tid < nq)
    lse[(long long)h * Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BHq, int G, int Sq, int Sk, int D, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const int bytes = 4 * smem_floats(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)BHq, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, G, Sq, Sk, D, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace fm = flash_mma;

constexpr int kTcMT = 2;                      // m16 tiles (32 q rows) a warp
constexpr int kTcWarps = 4;
constexpr int kTcBQ = 16 * kTcMT * kTcWarps;  // 128 q rows a block
constexpr int kTcBK = 64;                     // keys a tile
constexpr int kTcThreads = 32 * kTcWarps;

// shared memory of a block in bytes, for a row stride of ST bf16: the q
// tile and two stages of (k tile, v tile)
constexpr int tc_smem_bytes(int ST) { return 2 * (kTcBQ + 4 * kTcBK) * ST; }

// One warp's step over KH keys of a k/v tile: S = Q K^T for its 32 rows
// (two m16 tiles, which share every k and v fragment), the online softmax
// update in registers, O += P V.  kMask: test the mask on each pair
// (tile_class kMasked), else every pair is live (kFull).  Lane (g, c2)
// holds rows row0 + 16 i + 8 h of m-tile i, h = 0, 1 (index [i][h]), and
// the keys kc + 8 j + {0, 1} of each n8 tile j; m is the running max in
// log2 units, l this lane's share of the denominator.  q_a, k_b, v_a: the
// lane's ldmatrix addresses in the warp's q rows and at the step's first
// key of the k and v tiles.
template <int NT, bool kMask, int KH>
__device__ __forceinline__ void fwd_tile(float (&o)[kTcMT][NT][4],
                                         float (&m)[kTcMT][2],
                                         float (&l)[kTcMT][2], uint32_t q_a,
                                         uint32_t k_b, uint32_t v_a,
                                         float scale_log2, int row0, int kc,
                                         int Sq, int Sk, int causal,
                                         int window, int q_offset) {
  constexpr int KS = (NT + 1) / 2;
  constexpr int ST = 16 * KS + 8;
  constexpr int KN = KH / 8;                  // n8 tiles of keys
  float sc[kTcMT][KN][4];
#pragma unroll
  for (int i = 0; i < kTcMT; ++i)
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[kTcMT][4];
#pragma unroll
    for (int i = 0; i < kTcMT; ++i)
      fm::ldsm_x4(a[i], q_a + 2u * (16 * i * ST + 16 * kk));
#pragma unroll
    for (int j = 0; j < KN / 2; ++j) {
      uint32_t b[4];
      fm::ldsm_x4(b, k_b + 2u * (16 * j * ST + 16 * kk));
#pragma unroll
      for (int i = 0; i < kTcMT; ++i) {
        fm::mma_bf16(sc[i][2 * j], a[i], b[0], b[1]);
        fm::mma_bf16(sc[i][2 * j + 1], a[i], b[2], b[3]);
      }
    }
  }
  // element (i, j, e): row row0 + 16 i + 8 (e / 2), key kc + 8 j + e % 2;
  // a masked pair's score becomes -inf, a value no live score takes here
  // (m starts at NEG_INF, finite), and its p is set to 0 below
  float al[kTcMT][2];
  bool same = true;
#pragma unroll
  for (int i = 0; i < kTcMT; ++i) {
    float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[i][j][e] * scale_log2;
        if (kMask) {
          const int row = row0 + 16 * i + 8 * (e >> 1);
          const int kp = kc + 8 * j + (e & 1);
          if (!(row < Sq && kp < Sk &&
                fm::live(row + q_offset, kp, causal, window)))
            x = -INFINITY;
        }
        sc[i][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fm::quad_max(mx[h]);
      al[i][h] = fm::ex2(m[i][h] - mx[h]);
      same = same && al[i][h] == 1.f;
      m[i][h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[i][j][e];
        const float p =
            kMask && x == -INFINITY ? 0.f : fm::ex2(x - mx[e >> 1]);
        sc[i][j][e] = p;
        rs[e >> 1] += p;
      }
    l[i][0] = l[i][0] * al[i][0] + rs[0];
    l[i][1] = l[i][1] * al[i][1] + rs[1];
  }
  // alpha is exactly 1 where a row's max stayed: skip the product then
  if (!__all_sync(0xffffffffu, same)) {
#pragma unroll
    for (int i = 0; i < kTcMT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[i][n][0] *= al[i][0];
        o[i][n][1] *= al[i][0];
        o[i][n][2] *= al[i][1];
        o[i][n][3] *= al[i][1];
      }
  }
  // O += P V, P rounded to bf16 as the A operand
#pragma unroll
  for (int j = 0; j < KN / 2; ++j) {
    uint32_t a[kTcMT][4];
#pragma unroll
    for (int i = 0; i < kTcMT; ++i)
      fm::c_to_a(a[i], sc[i][2 * j], sc[i][2 * j + 1]);
    const uint32_t vj = v_a + 2u * 16 * j * ST;
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t b[4];
      fm::ldsm_x4_t(b, vj + 2u * 16 * n);
#pragma unroll
      for (int i = 0; i < kTcMT; ++i) {
        fm::mma_bf16(o[i][2 * n], a[i], b[0], b[1]);
        fm::mma_bf16(o[i][2 * n + 1], a[i], b[2], b[3]);
      }
    }
    if (NT & 1) {
      uint32_t b[2];
      fm::ldsm_x2_t(b, vj + 2u * 8 * (NT - 1));
#pragma unroll
      for (int i = 0; i < kTcMT; ++i)
        fm::mma_bf16(o[i][NT - 1], a[i], b[0], b[1]);
    }
  }
}

template <int NT>                             // n8 tiles of the head dim
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const fm::bf16* __restrict__ q,
                    const fm::bf16* __restrict__ k,
                    const fm::bf16* __restrict__ v, fm::bf16* __restrict__ out,
                    float* __restrict__ lse, int G, int Sq, int Sk, int D,
                    float scale_log2, int causal, int window, int q_offset,
                    int vec) {
  constexpr int KS = (NT + 1) / 2;            // k16 steps over the head dim
  constexpr int DP = 16 * KS;
  constexpr int ST = DP + 8;
  constexpr int WR = 16 * kTcMT;              // q rows a warp
  // keys a step on a kFull tile: the whole tile, or half where O's
  // accumulators (D > 120) leave too few registers for 64 keys of scores
  constexpr int KF = NT <= 15 ? kTcBK : kTcBK / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* Qs = reinterpret_cast<fm::bf16*>(smem_raw);
  fm::bf16* KV = Qs + kTcBQ * ST;   // stage s: k at 2 s kTcBK rows, v after

  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int nq = min(kTcBQ, Sq - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = q0 + WR * warp;              // the warp's first row

  fm::zero_cols<kTcThreads>(Qs, kTcBQ + 4 * kTcBK, D, DP, ST);
  fm::load_tile<kTcThreads>(Qs, q + ((long long)blockIdx.x * Sq + q0) * D,
                            nq, kTcBQ, D, ST, vec);
  // the live key range of the block's rows, in whole tiles (kv_tiles)
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  const int t0 = kbeg / kTcBK;
  const int t1 = kend > kbeg ? (kend + kTcBK - 1) / kTcBK : t0;
  auto load_kv = [&](int t, int s) {
    const int k0 = t * kTcBK;
    const long long off = ((long long)(blockIdx.x / G) * Sk + k0) * D;
    fm::bf16* Ks = KV + 2 * s * kTcBK * ST;
    fm::load_tile<kTcThreads>(Ks, k + off, min(kTcBK, Sk - k0), kTcBK, D, ST,
                              vec);
    fm::load_tile<kTcThreads>(Ks + kTcBK * ST, v + off, min(kTcBK, Sk - k0),
                              kTcBK, D, ST, vec);
  };
  if (t0 < t1) load_kv(t0, 0);
  fm::cp_async_commit();

  float o[kTcMT][NT][4];
#pragma unroll
  for (int i = 0; i < kTcMT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  float m[kTcMT][2], l[kTcMT][2];
#pragma unroll
  for (int i = 0; i < kTcMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[i][h] = fm::kNegInf;
      l[i][h] = 0.f;
    }
  const int row0 = r0 + (lane >> 2), c2 = 2 * (lane & 3);
  const uint32_t q_a = fm::smem_u32(Qs + WR * warp * ST + fm::a_off(lane, ST));
  const uint32_t k_b = fm::smem_u32(KV + fm::b_off(lane, ST));
  const uint32_t v_a = fm::smem_u32(KV + kTcBK * ST + fm::a_off(lane, ST));

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) load_kv(t + 1, s ^ 1);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();            // tile t is in
    __syncthreads();
    const int k0 = t * kTcBK;
    const uint32_t stage = 2u * 2 * s * kTcBK * ST;   // bytes
    const int cls = fm::tile_class(r0, WR, Sq, k0, kTcBK, Sk, causal, window,
                                   q_offset);
    if (cls == fm::kFull && KF == kTcBK) {
      fwd_tile<NT, false, kTcBK>(o, m, l, q_a, k_b + stage, v_a + stage,
                                 scale_log2, row0, k0 + c2, Sq, Sk, causal,
                                 window, q_offset);
    } else if (cls == fm::kFull) {
#pragma unroll 1
      for (int hk = 0; hk < kTcBK; hk += kTcBK / 2)
        fwd_tile<NT, false, kTcBK / 2>(
            o, m, l, q_a, k_b + stage + 2u * hk * ST,
            v_a + stage + 2u * hk * ST, scale_log2, row0, k0 + hk + c2, Sq,
            Sk, causal, window, q_offset);
    } else if (cls == fm::kMasked) {
      // two half steps: the mask's arithmetic beside half the scores
#pragma unroll 1
      for (int hk = 0; hk < kTcBK; hk += kTcBK / 2)
        fwd_tile<NT, true, kTcBK / 2>(
            o, m, l, q_a, k_b + stage + 2u * hk * ST,
            v_a + stage + 2u * hk * ST, scale_log2, row0, k0 + hk + c2, Sq,
            Sk, causal, window, q_offset);
    }
    __syncthreads();                   // before tile t + 2 overwrites stage s
  }
  fm::cp_async_wait<0>();            // none in flight at exit

#pragma unroll
  for (int i = 0; i < kTcMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = fm::quad_sum(l[i][h]);
      const int row = row0 + 16 * i + 8 * h;
      if (row < Sq) {
        const float lc = fmaxf(lt, 1e-30f);
        fm::bf16* orow = out + ((long long)blockIdx.x * Sq + row) * D;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = 8 * n + c2;
          const float x0 = o[i][n][2 * h] / lc, x1 = o[i][n][2 * h + 1] / lc;
          if (c + 1 < D && !(D & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            if (c < D) orow[c] = __float2bfloat16_rn(x0);
            if (c + 1 < D) orow[c + 1] = __float2bfloat16_rn(x1);
          }
        }
        // a row with no live key keeps m = NEG_INF in natural units too
        if ((lane & 3) == 0)
          lse[(long long)blockIdx.x * Sq + row] =
              (lt > 0.f ? m[i][h] * fm::kLn2 : fm::kNegInf) + logf(lc);
      }
    }
}

__host__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

template <int NT>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int BHq, int G, int Sq, int Sk, int D, float scale,
              int causal, int window, int q_offset, cudaStream_t stream) {
  const int bytes = tc_smem_bytes(16 * ((NT + 1) / 2) + 8);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((unsigned)BHq, (unsigned)((Sq + kTcBQ - 1) / kTcBQ));
  flash_fwd_tc_kernel<NT><<<grid, kTcThreads, bytes, stream>>>(
      (const fm::bf16*)q, (const fm::bf16*)k, (const fm::bf16*)v,
      (fm::bf16*)out, (float*)lse, G, Sq, Sk, D, scale * fm::kLog2e, causal,
      window, q_offset, vec);
  return (int)cudaGetLastError();
}

// the smallest instantiated n8 tile count that covers D
int launch_tc_any(const void* q, const void* k, const void* v, void* out,
                  void* lse, int BHq, int G, int Sq, int Sk, int D,
                  float scale, int causal, int window, int q_offset,
                  cudaStream_t s) {
  const int nt = (D + 7) / 8;
  if (nt <= 2)
    return launch_tc<2>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                        window, q_offset, s);
  if (nt <= 4)
    return launch_tc<4>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                        window, q_offset, s);
  if (nt <= 8)
    return launch_tc<8>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                        window, q_offset, s);
  if (nt <= 15)
    return launch_tc<15>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale,
                         causal, window, q_offset, s);
  return launch_tc<16>(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                       window, q_offset, s);
}

}  // namespace

// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the tensor-core
// kernel).  q (BHq, Sq, D), k and v (BHq / G, Sk, D), out like q, lse (BHq,
// Sq) float32; all contiguous, 1 <= D <= 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int BHq, int G, int Sq, int Sk,
                         int D, float scale, int causal, int window,
                         int q_offset, int dtype, void* stream) {
  if (BHq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (D < 1 || D > kDMax || G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                         window, q_offset, s);
  return launch_tc_any(q, k, v, out, lse, BHq, G, Sq, Sk, D, scale, causal,
                       window, q_offset, s);
}
