// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm_fwd (the Pallas TPU
// kernel behind kernels/rmsnorm/ops.py::rmsnorm, which the transformer calls
// twice a layer and once before the head).  For each row of x (n, d):
// y = x * rsqrt(mean(x^2) + eps) * scale, the sum of squares and the products
// in float32, the result written in x's dtype (float32 or bfloat16).
//
// What bounds it: bytes.  It reads each row and writes it once (2*n*d
// elements) and does ~4 flops an element, far below the card's ratio of
// operations to bytes.  So the design is about the loads: one block a row,
// 16-byte vector loads (8 bf16 or 4 f32) when d and the pointers allow it,
// scalar loads otherwise (any d works); each thread sums its squares, warps
// reduce by shuffles and the block through 32 floats of shared memory; the
// second pass re-reads the row (7.5 KB at d = 3840, from L1/L2) and writes
// the scaled values.  The TPU kernel holds 256 rows in VMEM at a time; here a
// row is one block and the grid covers n.
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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block a row; VEC elements a load (VEC divides d, the pointers are
// aligned to VEC elements: the wrapper checks both).
template <typename T, int VEC>
__global__ void rmsnorm_fwd_kernel(const T* __restrict__ x,
                                   const T* __restrict__ scale,
                                   T* __restrict__ out, int d, float eps) {
  using V = Vec<T, VEC>;
  const long long row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  const V* sr = reinterpret_cast<const V*>(scale);
  V* orow = reinterpret_cast<V*>(out + row * d);
  const int nv = d / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const V a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(a.v[j]);
      ss += f * f;
    }
  }
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] / (float)d + eps);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const V a = xr[i];
    const V s = sr[i];
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f<T>((to_f(a.v[j]) * r) * to_f(s.v[j]));
    orow[i] = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* scale, void* out, long long n, int d,
            float eps, cudaStream_t stream) {
  const int nv = d / VEC;
  int threads = ((nv + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_fwd_kernel<T, VEC><<<(unsigned)n, threads, 0, stream>>>(
      (const T*)x, (const T*)scale, (T*)out, d, eps);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  vec: 1, or 16 bytes' worth of elements.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           long long n, int d, float eps, int dtype, int vec,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && d > 0) {
    if (dtype == 0) {
      if (vec == 4) launch<float, 4>(x, scale, out, n, d, eps, s);
      else launch<float, 1>(x, scale, out, n, d, eps, s);
    } else {
      if (vec == 8) launch<__nv_bfloat16, 8>(x, scale, out, n, d, eps, s);
      else launch<__nv_bfloat16, 1>(x, scale, out, n, d, eps, s);
    }
  }
  return (int)cudaGetLastError();
}
