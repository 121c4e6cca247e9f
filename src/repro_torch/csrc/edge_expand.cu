// Ragged CSR span gather into 128-lane tiles for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/edge_expand/kernel.py::expand (the Pallas TPU
// kernel behind backend.expand_tiles, used by core/edges.py::_tiled_csr_expand
// and the fused planner's _expand_rows).  Given the tile plan of
// kernels/edge_expand/ref.py::plan, lane j of output tile t holds edge
// tw[t]*128 + j of frontier item item[t] (item == F marks a padding tile),
// gathered from up to four int32 pools; masked lanes hold -1.  The layout is
// bit for bit that of the reference, because the callers scatter it into the
// dense frontier buffers at positions they compute themselves.
//
// What bounds it: bytes.  Every output lane is written once (cap_tiles*128*4
// bytes per pool, most of it -1 in the padding tiles the worst-case plan
// reserves) and every valid lane reads one pool word per pool.  The TPU
// kernel fetched two aligned tiles per step and rotated them; here each
// 128-thread block takes a tile, reads its plan entry and span once, and its
// threads read pool[start + lane] for neighbouring lanes: one coalesced,
// unaligned 512-byte row per pool, with no shared memory.  A grid-stride loop
// bounds the grid; padding tiles only write -1 and read no pool.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

__global__ void expand_kernel(const int* __restrict__ starts,
                              const int* __restrict__ degs,
                              const int* __restrict__ item_of_tile,
                              const int* __restrict__ tw_of_tile,
                              const int* __restrict__ p0, const int* __restrict__ p1,
                              const int* __restrict__ p2, const int* __restrict__ p3,
                              int* __restrict__ o0, int* __restrict__ o1,
                              int* __restrict__ o2, int* __restrict__ o3,
                              int n_pools, int n_items, long long pool_len,
                              long long cap_tiles) {
  const int lane = threadIdx.x;
  for (long long t = blockIdx.x; t < cap_tiles; t += gridDim.x) {
    const int item = item_of_tile[t];
    bool valid = false;
    long long e = 0;
    if (item >= 0 && item < n_items) {
      const long long tw = tw_of_tile[t];
      const long long rem = (long long)degs[item] - tw * kTile;
      e = (long long)starts[item] + tw * kTile + lane;
      valid = lane < rem && e >= 0 && e < pool_len;
    }
    const long long off = t * kTile + lane;
    o0[off] = valid ? __ldg(p0 + e) : -1;
    if (n_pools > 1) o1[off] = valid ? __ldg(p1 + e) : -1;
    if (n_pools > 2) o2[off] = valid ? __ldg(p2 + e) : -1;
    if (n_pools > 3) o3[off] = valid ? __ldg(p3 + e) : -1;
  }
}

}  // namespace

extern "C" int edge_expand(const void* starts, const void* degs,
                           const void* item_of_tile, const void* tw_of_tile,
                           const void* p0, const void* p1, const void* p2,
                           const void* p3, void* o0, void* o1, void* o2,
                           void* o3, int n_pools, int n_items,
                           long long pool_len, long long cap_tiles,
                           void* stream) {
  if (cap_tiles > 0) {
    const long long max_blocks = 132LL * 16;
    const int blocks = (int)(cap_tiles < max_blocks ? cap_tiles : max_blocks);
    expand_kernel<<<blocks, kTile, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)degs, (const int*)item_of_tile,
        (const int*)tw_of_tile, (const int*)p0, (const int*)p1,
        (const int*)p2, (const int*)p3, (int*)o0, (int*)o1, (int*)o2,
        (int*)o3, n_pools, n_items, pool_len, cap_tiles);
  }
  return (int)cudaGetLastError();
}
