// Row-wise sort and per-hop dedup/compaction for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dedup_compact/kernel.py::sort_rows and
// ::dedup_compact_rows (the Pallas TPU kernels behind backend.sort_rows, used
// by the planner's star merge, and backend.dedup_compact_rows, used by every
// fused hop wave).  sort_rows sorts each row of an (R, W) int32 matrix
// ascending.  dedup_compact_rows returns, per row, the first `cap` unique
// values other than PAD (INT32_MAX) in ascending order with PAD after them,
// and the row's unique count before the cap (count > cap is the fast-fail).
//
// What bounds it: operations and synchronisation, not bytes.  A row is read
// once and written once, but a bitonic network over a virtual width W2 (the
// next power of two) takes log2(W2)*(log2(W2)+1)/2 compare-exchange steps,
// each behind a block barrier.  Design: one block per row, the row resident
// in shared memory for the whole network.  At the a1-kg caps a wave in which
// some units expand `out` and others `in` is 36,866 columns wide; padding that
// to 65,536 int32 would need 256 KB, more than the 227 KB a block may hold.
// So the padding is virtual: the network uses only ascending comparators
// (the first step of every merge compares i with its mirror i ^ (k-1)), and
// with every slot at or past W holding the largest value, a comparator whose
// upper slot is >= W never moves anything.  Those slots are neither stored
// nor touched, and the row needs 4*W bytes.  Instead of the TPU kernel's
// second sort, the dedup marks the first of each run of equal values and
// compacts with one block-wide prefix sum.  Rows wider than the shared memory
// a block can hold are refused by the wrapper.
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 0x7fffffff;

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// Ascending bitonic network over the virtual width w2 (a power of two >= w);
// slots >= w are virtual PAD and never stored.
__device__ void bitonic_sort_shared(int* s, int w, int w2) {
  const int half = w2 >> 1;
  const int n_cmp = half < w ? half : w;   // comparator c has its lower slot >= c
  for (int k = 2; k <= w2; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      const int lj = ilog2(j);
      const bool mirror = j == (k >> 1);
      for (int c = threadIdx.x; c < n_cmp; c += blockDim.x) {
        const int i = ((c >> lj) << (lj + 1)) | (c & (j - 1));
        const int p = mirror ? (i ^ (k - 1)) : (i + j);
        if (p < w) {
          const int a = s[i], b = s[p];
          if (a > b) { s[i] = b; s[p] = a; }
        }
      }
      __syncthreads();
    }
  }
}

// Exclusive prefix sum of one int per thread over the block (blockDim.x a
// multiple of 32, at most 1024); *total receives the block sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[n_warps - 1];
  return (wid ? warp_sums[wid - 1] : 0) + x - v;
}

__device__ void load_row(int* s, const int* __restrict__ xr, int w) {
  for (int i = threadIdx.x; i < w; i += blockDim.x) s[i] = xr[i];
  __syncthreads();
}

__global__ void sort_rows_kernel(const int* __restrict__ x,
                                 int* __restrict__ out, int w, int w2) {
  extern __shared__ int s[];
  const long long r = blockIdx.x;
  load_row(s, x + r * w, w);
  bitonic_sort_shared(s, w, w2);
  int* o = out + r * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) o[i] = s[i];
}

__global__ void dedup_compact_rows_kernel(const int* __restrict__ x,
                                          int* __restrict__ out,
                                          int* __restrict__ counts, int w,
                                          int w2, int cap) {
  extern __shared__ int s[];
  const long long r = blockIdx.x;
  load_row(s, x + r * w, w);
  bitonic_sort_shared(s, w, w2);
  // each thread owns one contiguous chunk of the sorted row; a slot is the
  // first of its run if it differs from its left neighbour (-1 before slot 0)
  const int chunk = (w + blockDim.x - 1) / blockDim.x;
  const int b0 = min(w, (int)threadIdx.x * chunk), b1 = min(w, b0 + chunk);
  int n_first = 0;
  for (int i = b0; i < b1; ++i) {
    const int v = s[i];
    n_first += (v != kPad) & (v != (i ? s[i - 1] : -1));
  }
  int total;
  int rank = block_exclusive_scan(n_first, &total);
  int* o = out + r * cap;
  for (int i = b0; i < b1 && rank < cap; ++i) {
    const int v = s[i];
    if ((v != kPad) & (v != (i ? s[i - 1] : -1))) o[rank++] = v;
  }
  for (int i = min(total, cap) + threadIdx.x; i < cap; i += blockDim.x)
    o[i] = kPad;
  if (threadIdx.x == 0) counts[r] = total;
}

int threads_for(int w2) {
  const int t = w2 >> 1;
  return t >= 1024 ? 1024 : (t < 32 ? 32 : t);
}

cudaError_t shared_limit(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" int sort_rows(const void* x, void* out, int n_rows, int w, int w2,
                         void* stream) {
  const int bytes = w * (int)sizeof(int);
  cudaError_t err = shared_limit((const void*)sort_rows_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0)
    sort_rows_kernel<<<n_rows, threads_for(w2), bytes, (cudaStream_t)stream>>>(
        (const int*)x, (int*)out, w, w2);
  return (int)cudaGetLastError();
}

extern "C" int dedup_compact_rows(const void* x, void* out, void* counts,
                                  int n_rows, int w, int w2, int cap,
                                  void* stream) {
  const int bytes = w * (int)sizeof(int);
  cudaError_t err = shared_limit((const void*)dedup_compact_rows_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0)
    dedup_compact_rows_kernel<<<n_rows, threads_for(w2), bytes,
                                (cudaStream_t)stream>>>(
        (const int*)x, (int*)out, (int*)counts, w, w2, cap);
  return (int)cudaGetLastError();
}
