// Sorted-index probes for Hopper (sm_90a): the windowed probe and the flat one.
//
// searchsorted_left_ranged replaces
// src/repro/kernels/sorted_lookup/kernel.py::searchsorted_left_ranged
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
//
// searchsorted_left replaces
// src/repro/kernels/sorted_lookup/kernel.py::searchsorted_left (the Pallas
// kernel behind backend.searchsorted, which serves the SPMD index probe
// core/query/executor_spmd.py::_lookup_local).  For each query q it returns
// count(keys < q) over one flat array sorted ascending (a shard's whole index
// block, cap_idx keys, INT32_MAX in empty slots).  The TPU kernel streams and
// counts all N keys for every query block; here one warp searches for one
// query, 32-ary: each round its 32 lanes read 32 keys spread evenly over the
// range the answer lies in, and a ballot of key < q gives how many of them
// the query passes, which narrows the range 33-fold.  At N = 16 M that is 4
// rounds of 32 independent loads and a last round over at most 32 adjacent
// keys (5 dependent loads), where a binary search makes ~24; and Q = 128
// queries spread over 32 blocks of 4 warps, where one thread a query filled
// a single block on one SM.  The answer is the same: count(keys < q) on
// sorted keys.
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

constexpr int kWarps = 4;                     // queries a block

// One warp a query.  The answer, count(keys < v) = the first index whose key
// is >= v, lies in [a, b].  While b - a > 32, lane i probes index
// p(i) = a + (i + 1) (b - a) / 33 (strictly increasing, inside [a, b)); the
// c = popcount(ballot(key < v)) lanes below the first key >= v leave the
// answer in [p(c - 1) + 1, p(c)], with p(-1) + 1 = a and p(32) = b.  Then
// lane i reads a + i for i < b - a, and the answer is a + popcount.
__global__ void __launch_bounds__(32 * kWarps)
searchsorted_left_kernel(const int* __restrict__ keys, long long n_keys,
                         const int* __restrict__ queries,
                         int* __restrict__ out, int n_queries) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n_queries) return;                 // the whole warp
  const int lane = threadIdx.x & 31;
  const int v = queries[q];
  long long a = 0, b = n_keys;
  while (b - a > 32) {
    const long long w = b - a;
    const bool lt = __ldg(keys + a + (lane + 1) * w / 33) < v;
    const int c = __popc(__ballot_sync(0xffffffffu, lt));
    const long long lo = c == 0 ? a : a + c * w / 33 + 1;
    b = c == 32 ? b : a + (c + 1) * w / 33;
    a = lo;
  }
  const bool lt = lane < b - a && __ldg(keys + a + lane) < v;
  const int c = __popc(__ballot_sync(0xffffffffu, lt));
  if (lane == 0) out[q] = (int)(a + c);
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

extern "C" int searchsorted_left(const void* keys, long long n_keys,
                                 const void* queries, void* out,
                                 int n_queries, void* stream) {
  if (n_queries > 0) {
    const int blocks = (n_queries + kWarps - 1) / kWarps;
    searchsorted_left_kernel<<<blocks, 32 * kWarps, 0,
                               (cudaStream_t)stream>>>(
        (const int*)keys, n_keys, (const int*)queries, (int*)out, n_queries);
  }
  return (int)cudaGetLastError();
}
