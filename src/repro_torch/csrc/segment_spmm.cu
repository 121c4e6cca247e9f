// ELL fused gather-GEMM (GNN message passing) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_spmm/kernel.py::segment_spmm (the
// Pallas TPU kernel behind kernels/segment_spmm/ops.py).  For each row r of
// ids (R, K): acc = sum over k = 0..K-1 of x[ids[r, k]], in float32 in that
// order, ids < 0 (padding) adding nothing; then acc * norm[r] if norm is
// given; then acc @ W in float32 if W (D, Dout) is given; written in x's
// dtype (float32 or bfloat16, W in the same).
//
// What bounds it: bytes.  The gather reads K rows of D for each output row,
// and the W product is 2*D*Dout flops a row, with Dout ~16-128 in the
// models: about 0.1-1 flop a gathered byte, far below the card's ratio.  So
// the design keeps the aggregated rows out of device memory, as the TPU
// kernel keeps them in VMEM: one block takes a tile of TR rows; its threads
// run over the tile's (row, column) pairs, neighbouring threads on
// neighbouring columns of one gathered row (coalesced for any D, no vector
// loads, so D need not be a multiple of anything), and each sums its
// column over the row's K neighbours.  Without W the sums go straight out.
// With W they stay in shared memory (TR rows of D floats, TR chosen so that
// they fit in 32 KB) and the tile is multiplied by W in the block: W streams
// through shared memory in 32 x 128 tiles, each thread keeping up to 16
// (row, output column) sums in registers, f32 FMAs over d in order.  The TPU
// grid's sequential K axis becomes the loop over k inside a thread.  Offsets
// are 64-bit (id * D, r * K, r * Dout).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

constexpr int THREADS = 256;
constexpr int TR_MAX = 32;              // rows a tile
constexpr int TD = 32, TJ = 128;        // the W tile in shared memory
constexpr int OPT = TR_MAX * TJ / THREADS;   // output sums a thread
constexpr int ACC_FLOATS = 8192;        // 32 KB of aggregated rows

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_spmm_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                    const T* __restrict__ w, const float* __restrict__ norm,
                    T* __restrict__ out, long long N, int D, long long R,
                    int K, int Dout, int TR) {
  extern __shared__ float sacc[];        // (TR, D) when W is given
  __shared__ float sw[TD * TJ];
  const long long r0 = (long long)blockIdx.x * TR;
  const int nr = (int)(R - r0 < TR ? R - r0 : TR);
  for (int i = threadIdx.x; i < nr * D; i += THREADS) {
    const int rr = i / D, col = i - rr * D;
    const long long r = r0 + rr;
    const int* nb = ids + r * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int id = nb[k];
      if (id >= 0 && id < N) acc += to_f(x[(long long)id * D + col]);
    }
    if (norm != nullptr) acc *= norm[r];
    if (w != nullptr) sacc[rr * D + col] = acc;
    else out[r * D + col] = from_f<T>(acc);
  }
  if (w == nullptr) return;
  for (int j0 = 0; j0 < Dout; j0 += TJ) {
    const int nj = Dout - j0 < TJ ? Dout - j0 : TJ;
    float o[OPT];
#pragma unroll
    for (int q = 0; q < OPT; ++q) o[q] = 0.f;
    for (int d0 = 0; d0 < D; d0 += TD) {
      const int nd = D - d0 < TD ? D - d0 : TD;
      __syncthreads();                   // sacc written, sw free
      for (int i = threadIdx.x; i < nd * nj; i += THREADS) {
        const int dd = i / nj, j = i - dd * nj;
        sw[dd * TJ + j] = to_f(w[(long long)(d0 + dd) * Dout + j0 + j]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < OPT; ++q) {
        const int idx = threadIdx.x + q * THREADS;
        if (idx < nr * nj) {
          const int rr = idx / nj, j = idx - rr * nj;
          const float* a = sacc + rr * D + d0;
          float s = o[q];
          for (int dd = 0; dd < nd; ++dd) s = fmaf(a[dd], sw[dd * TJ + j], s);
          o[q] = s;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int idx = threadIdx.x + q * THREADS;
      if (idx < nr * nj) {
        const int rr = idx / nj, j = idx - rr * nj;
        out[(r0 + rr) * Dout + j0 + j] = from_f<T>(o[q]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const int* ids, const void* w, const float* norm,
           void* out, long long N, int D, long long R, int K, int Dout,
           cudaStream_t s) {
  int tr = ACC_FLOATS / D;
  tr = tr < 1 ? 1 : (tr > TR_MAX ? TR_MAX : tr);
  const long long blocks = (R + tr - 1) / tr;
  const size_t smem = w != nullptr ? (size_t)tr * D * sizeof(float) : 0;
  segment_spmm_kernel<T><<<(unsigned)blocks, THREADS, smem, s>>>(
      (const T*)x, ids, (const T*)w, norm, (T*)out, N, D, R, K, Dout, tr);
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  w and norm may be null.  D <= 8192.
extern "C" int segment_spmm(const void* x, const void* ids, const void* w,
                            const void* norm, void* out, long long N, int D,
                            long long R, int K, int Dout, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R > 0 && D > 0 && D <= ACC_FLOATS && Dout > 0) {
    if (dtype == 0)
      launch<float>(x, (const int*)ids, w, (const float*)norm, out, N, D, R,
                    K, Dout, s);
    else
      launch<__nv_bfloat16>(x, (const int*)ids, w, (const float*)norm, out,
                            N, D, R, K, Dout, s);
  }
  return (int)cudaGetLastError();
}
