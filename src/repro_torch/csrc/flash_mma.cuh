// The pieces that the tensor-core flash kernels (flash_fwd.cu, and the dK/dV
// kernel of flash_bwd.cu) share: bf16 tiles in shared memory filled with
// cp.async, the mask's tile classes, and the mma.sync.m16n8k16 / ldmatrix
// fragments of the FlashAttention-2 register layout.
//
// Fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"), for lane l of a
// warp, g = l / 4 and c = 2 * (l % 4):
//   A (16 x 16, row major): a0 = (g, c..c+1), a1 = (g+8, c..c+1),
//                           a2 = (g, c+8..c+9), a3 = (g+8, c+8..c+9);
//   B (16 x 8, k x n):      b0 = (k c..c+1, n g), b1 = (k c+8..c+9, n g);
//   C (16 x 8, f32):        c0, c1 = (g, c..c+1), c2, c3 = (g+8, c..c+1).
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of the next product over those 16 columns: a score
// tile S = Q K^T becomes the operand of P V without leaving registers.
//
// Tiles are row major in shared memory with a row stride of DP + 8 bf16
// (DP = the head dim padded to a multiple of 16), an odd number of 16-byte
// chunks: the eight row addresses of each ldmatrix matrix then fall in
// eight different 16-byte bank groups, free of conflicts.  Columns
// [D, DP) hold zeros (zero_cols) so that the contraction over DP sums only
// the D real columns.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;   // NEG_INF of the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The mask over a rectangle of query rows [q0, q0 + rows) and keys
// [k0, k0 + cols): no live pair (the tile is skipped), every pair live and
// every row and key inside [0, Sq) x [0, Sk) (no mask test), or some of each.
// kernels/flash_attention/kernel.py::tile_class mirrors it.
enum { kSkip = 0, kMasked = 1, kFull = 2 };

__device__ __forceinline__ bool live(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

__device__ __forceinline__ int tile_class(int q0, int rows, int Sq, int k0,
                                          int cols, int Sk, int causal,
                                          int window, int q_offset) {
  const int nq = min(rows, Sq - q0), nk = min(cols, Sk - k0);
  if (nq <= 0 || nk <= 0) return kSkip;
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int k1 = k0 + nk - 1;
  // live keys of the rows form (qlo - window, qhi] (causal) or
  // (qlo - window, inf) (not causal), window or not
  if ((causal && k0 > qhi) || (window > 0 && k1 <= qlo - window))
    return kSkip;
  if (nq == rows && nk == cols && (!causal || k1 <= qlo) &&
      (window <= 0 || k0 > qhi - window))
    return kFull;
  return kMasked;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, or zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a contiguous (., D) bf16 slab into the first D columns of
// a `rows`-row tile of row stride ST; rows [n, rows) become zeros.  With vec
// (D a multiple of 8 and src 16-byte aligned) as 16-byte cp.async copies in
// the caller's current group: thread t copies chunk t % 16 of rows t / 16,
// t / 16 + kThreads / 16, ... (no division: a row has at most 16 chunks);
// otherwise element by element, synchronously.
template <int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src, int n,
                                          int rows, int D, int ST, bool vec) {
  if (vec) {
    const int c = (threadIdx.x & 15) << 3;
    if (c < D) {
#pragma unroll 4
      for (int r = threadIdx.x >> 4; r < rows; r += kThreads / 16) {
        const bool ok = r < n;
        cp_async16(dst + r * ST + c, ok ? src + (long long)r * D + c : src,
                   ok);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      dst[r * ST + c] =
          r < n ? src[(long long)r * D + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// zeros in columns [D, DP) of `rows` rows of stride ST
template <int kThreads>
__device__ __forceinline__ void zero_cols(bf16* dst, int rows, int D, int DP,
                                          int ST) {
  const int w = DP - D;
  for (int e = threadIdx.x; e < rows * w; e += kThreads) {
    const int r = e / w;
    dst[r * ST + D + (e - r * w)] = __float2bfloat16_rn(0.f);
  }
}

// Per-lane element offsets (in bf16) of the ldmatrix row addresses, from a
// 16 x 16 block's top-left corner in a tile of stride ST:
//   a_off: an A fragment of the block (rows = m, columns = k), and also, with
//          ldsm_x4_t, the B fragments of two n8 tiles when the block's rows
//          are k and its columns n (V in P V);
//   b_off: the B fragments of two n8 tiles when the block's rows are n and
//          its columns k (K in Q K^T).
// Registers {0, 1} then hold the first n8 tile's (b0, b1), {2, 3} the
// second's.
__device__ __forceinline__ int a_off(int lane, int ST) {
  return (lane & 15) * ST + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_off(int lane, int ST) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ST + (((lane >> 3) & 1) << 3);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// one n8 tile's (b0, b1) with a_off addresses (lanes 0-15 are read)
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a b: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU instruction; results below 2^-126 flush to 0 (a p that
// small moves no f32 sum whose largest term is 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment over columns [16 j, 16 j + 16) of a 16-row C tile held as
// n8 tiles x[2 j], x[2 j + 1].
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float x0[4],
                                       const float x1[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// the sum (or max) of a value over the four lanes that hold one row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

}  // namespace flash_mma
