// Windowed sorted-index probe for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sorted_lookup/kernel.py::searchsorted_left_ranged
// (the Pallas TPU kernel behind backend.searchsorted_blocked, which serves
// core/index.py::lookup).  For each query q it returns the left insertion
// point of queries[q] inside its own window keys[lo[q]:hi[q]], i.e.
// count(keys[lo:hi] < q) for a window that is sorted ascending (the primary
// index is shard-major: one sorted run of cap_idx keys per shard, empty slots
// hold INT32_MAX and sort last).
//
// What bounds it: the TPU kernel streams and compares the whole key array for
// every query block (O(Q*N) work; at one A1 machine's share the window is
// 16 M keys, so that scan is hopeless).  Here one thread runs a lower-bound
// binary search inside [lo, hi): O(Q*log N) dependent loads.  The work a batch
// needs is a few KB of sectors, so the kernel is bound by the latency of its
// ~24 dependent global loads, not by bytes or operations; the design keeps it
// to one launch per probe wave and no shared memory or synchronisation.
#include <cuda_runtime.h>

namespace {

__global__ void searchsorted_left_ranged_kernel(
    const int* __restrict__ keys, long long n_keys,
    const int* __restrict__ queries, const int* __restrict__ lo,
    const int* __restrict__ hi, int* __restrict__ out, int n_queries) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  // the window clipped to the array, as the compare-and-count reference sees it
  long long a = lo[q] < 0 ? 0 : lo[q];
  long long b = hi[q] > n_keys ? n_keys : hi[q];
  long long base = a;
  if (b < a) b = a;
  const int v = queries[q];
  while (a < b) {
    long long mid = a + ((b - a) >> 1);
    if (__ldg(keys + mid) < v) a = mid + 1; else b = mid;
  }
  out[q] = (int)(a - base);
}

}  // namespace

extern "C" int searchsorted_left_ranged(const void* keys, long long n_keys,
                                        const void* queries, const void* lo,
                                        const void* hi, void* out,
                                        int n_queries, void* stream) {
  if (n_queries > 0) {
    const int threads = 128;
    const int blocks = (n_queries + threads - 1) / threads;
    searchsorted_left_ranged_kernel<<<blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
        (const int*)keys, n_keys, (const int*)queries, (const int*)lo,
        (const int*)hi, (int*)out, n_queries);
  }
  return (int)cudaGetLastError();
}
