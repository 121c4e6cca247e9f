// Sorted-index probes for Hopper (sm_90a): the windowed probe and the flat one.
//
// searchsorted_left_ranged replaces
// src/repro/kernels/sorted_lookup/kernel.py::searchsorted_left_ranged
// (the Pallas TPU kernel behind backend.searchsorted_blocked, which serves
// core/index.py::lookup, and backend.searchsorted_ranged, the shared
// frontier's delta probe).  For each query q it returns the left insertion
// point of queries[q] inside its own window keys[lo[q]:hi[q]] (hi[q] =
// lo[q] + width when no hi is given), i.e. count(keys[lo:hi] < q) for a
// window that is sorted ascending (the primary index is shard-major: one
// sorted run of cap_idx keys per shard, empty slots hold INT32_MAX and sort
// last).
//
// searchsorted_left replaces
// src/repro/kernels/sorted_lookup/kernel.py::searchsorted_left (the Pallas
// kernel behind backend.searchsorted, which serves the SPMD index probe
// core/query/executor_spmd.py::_lookup_local).  For each query q it returns
// count(keys < q) over one flat array sorted ascending (a shard's whole index
// block, cap_idx keys, INT32_MAX in empty slots).
//
// What bounds them: the TPU kernels stream and count all N keys for every
// query block (O(Q*N) work; at one A1 machine's share the index is 16 M keys,
// so that scan is hopeless).  Here both probes run the same search,
// warp_lower_bound: one warp a query, 32-ary.  Each round its 32 lanes read
// 32 keys spread evenly over the range the answer lies in, and a ballot of
// key < q gives how many of them the query passes, which narrows the range
// 33-fold.  At N = 16 M that is 4 rounds of 32 independent loads and a last
// round over at most 32 adjacent keys (5 dependent loads), where a binary
// search makes ~24; the work a batch needs is a few KB of sectors, so the
// kernels are bound by the latency of those rounds, not by bytes or
// operations.  Q = 128 queries spread over 32 blocks of 4 warps, where one
// thread a query filled a single block on one SM.  The answer is the same:
// count(keys < q) on sorted keys.  A window of 32 keys or fewer (the delta
// probe's) is one round.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                     // queries a block

// The first index in [a, b] whose key is >= v (b when there is none), over
// keys sorted on [a, b), found by the calling warp (every lane with the same
// a, b and v).  While b - a > 32, lane i probes index
// p(i) = a + (i + 1) (b - a) / 33 (strictly increasing, inside [a, b)); the
// c = popcount(ballot(key < v)) lanes below the first key >= v leave the
// answer in [p(c - 1) + 1, p(c)], with p(-1) + 1 = a and p(32) = b.  Then
// lane i reads a + i for i < b - a (never at or past b), and the answer is
// a + popcount.
__device__ __forceinline__ long long warp_lower_bound(
    const int* __restrict__ keys, long long a, long long b, int v, int lane) {
  while (b - a > 32) {
    const long long w = b - a;
    const bool lt = __ldg(keys + a + (lane + 1) * w / 33) < v;
    const int c = __popc(__ballot_sync(0xffffffffu, lt));
    const long long lo = c == 0 ? a : a + c * w / 33 + 1;
    b = c == 32 ? b : a + (c + 1) * w / 33;
    a = lo;
  }
  const bool lt = lane < b - a && __ldg(keys + a + lane) < v;
  return a + __popc(__ballot_sync(0xffffffffu, lt));
}

// One warp a query, inside the query's window clipped to the array as the
// compare-and-count reference sees it: [a, b) with a = max(lo, 0) and
// b = max(min(hi, n), a).
__global__ void __launch_bounds__(32 * kWarps)
searchsorted_left_ranged_kernel(const int* __restrict__ keys, long long n_keys,
                                const int* __restrict__ queries,
                                const int* __restrict__ lo,
                                const int* __restrict__ hi, long long width,
                                int* __restrict__ out, int n_queries) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n_queries) return;                 // the whole warp
  const long long l = lo[q];
  const long long a = l < 0 ? 0 : l;
  long long b = hi ? (long long)hi[q] : l + width;
  if (b > n_keys) b = n_keys;
  if (b < a) b = a;
  const long long r = warp_lower_bound(keys, a, b, queries[q],
                                       threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) out[q] = (int)(r - a);
}

__global__ void __launch_bounds__(32 * kWarps)
searchsorted_left_kernel(const int* __restrict__ keys, long long n_keys,
                         const int* __restrict__ queries,
                         int* __restrict__ out, int n_queries) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n_queries) return;                 // the whole warp
  const long long r = warp_lower_bound(keys, 0, n_keys, queries[q],
                                       threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) out[q] = (int)r;
}

int launch_ranged(const void* keys, long long n_keys, const void* queries,
                  const void* lo, const void* hi, long long width, void* out,
                  int n_queries, void* stream) {
  if (n_queries > 0) {
    const int blocks = (n_queries + kWarps - 1) / kWarps;
    searchsorted_left_ranged_kernel<<<blocks, 32 * kWarps, 0,
                                      (cudaStream_t)stream>>>(
        (const int*)keys, n_keys, (const int*)queries, (const int*)lo,
        (const int*)hi, width, (int*)out, n_queries);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The windows [lo[q], hi[q]).
extern "C" int searchsorted_left_ranged(const void* keys, long long n_keys,
                                        const void* queries, const void* lo,
                                        const void* hi, void* out,
                                        int n_queries, void* stream) {
  return launch_ranged(keys, n_keys, queries, lo, hi, 0, out, n_queries,
                       stream);
}

// The windows [lo[q], lo[q] + width): the index probe's blocks, with no hi
// array to build.
extern "C" int searchsorted_left_width(const void* keys, long long n_keys,
                                       const void* queries, const void* lo,
                                       long long width, void* out,
                                       int n_queries, void* stream) {
  return launch_ranged(keys, n_keys, queries, lo, nullptr, width, out,
                       n_queries, stream);
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
