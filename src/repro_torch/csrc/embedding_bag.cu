// Embedding-bag for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py::embedding_bag (the
// Pallas TPU kernel behind kernels/embedding_bag/ops.py).  For each bag b of
// ids (B, L): out[b] = sum over l = 0..L-1 of table[ids[b, l]], in float32
// in that order, ids < 0 (padding) adding nothing; in mean mode the f32 sum
// divided in f32 by max(count, 1), count the bag's non-padding ids.  The
// result is written in the table's dtype (float32 or bfloat16).
//
// What bounds it: bytes.  Each non-padding id reads one table row (D
// elements) and each bag writes one row; an add an element is far below
// the card's ratio of operations to bytes.  So the design is about the
// gathers: one warp a bag, lanes over the row's columns (a row of 32 f32 is
// one 128-byte transaction), a loop over 32-column chunks for D > 32.  The
// bag's ids are read once a chunk of 32 slots, one id a lane, and handed to
// the other lanes by shuffles, so the row loads of a bag's slots do not wait
// on one another's id loads.  The TPU kernel streams one row a grid step
// through a scalar-prefetched block index and a VMEM accumulator; here the
// accumulator is a register.  Row offsets are 64-bit: a table of 10^8 rows
// of 32 holds 3.2e9 elements, past what an int32 index reaches.
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

constexpr int WARPS = 8;       // bags a block

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     T* __restrict__ out, long long V, int D, long long B,
                     int L, int mean) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int* bag = ids + b * L;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int col = c0 + lane;
    const bool live = col < D;
    float acc = 0.f;
    int count = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = L - l0 < 32 ? L - l0 : 32;
      const int mine = lane < n ? bag[l0 + lane] : -1;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(0xffffffffu, mine, j);
        if (id >= 0 && id < V) {
          ++count;
          if (live) acc += to_f(table[(long long)id * D + col]);
        }
      }
    }
    if (mean) acc = acc / (float)(count > 1 ? count : 1);
    if (live) out[b * D + col] = from_f<T>(acc);
  }
}

template <typename T>
void launch(const void* table, const int* ids, void* out, long long V, int D,
            long long B, int L, int mean, cudaStream_t s) {
  const long long blocks = (B + WARPS - 1) / WARPS;
  embedding_bag_kernel<T><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
      (const T*)table, ids, (T*)out, V, D, B, L, mean);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  mean: 0 sum, 1 mean.
extern "C" int embedding_bag(const void* table, const void* ids, void* out,
                             long long V, int D, long long B, int L, int mean,
                             int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && D > 0) {
    if (dtype == 0)
      launch<float>(table, (const int*)ids, out, V, D, B, L, mean, s);
    else
      launch<__nv_bfloat16>(table, (const int*)ids, out, V, D, B, L, mean, s);
  }
  return (int)cudaGetLastError();
}
