// Row-wise sort and per-hop dedup/compaction for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dedup_compact/kernel.py::sort_rows and
// ::dedup_compact_rows (the Pallas TPU kernels behind backend.sort_rows, used
// by the planner's star merge, and backend.dedup_compact_rows, used by every
// fused hop wave).  sort_rows sorts each row of an (R, W) int32 matrix
// ascending.  dedup_compact_rows returns, per row, the first `cap` unique
// values other than PAD (INT32_MAX) in ascending order with PAD after them,
// and the row's unique count before the cap (count > cap is the fast-fail).
// A value counts when it differs from its left neighbour in sorted order,
// slot 0 being compared with -1 (as the TPU kernel does): a row whose
// smallest value is -1 does not count it.
//
// Both are one routine, radix_sort_row: a least-significant-digit radix
// sort of the row's valid keys, one block a row, then a last step of their
// own.  What bounds them: the row is read once and W (sort) or cap + 1
// (dedup) words written, a bytes bound of ~1.3 us for the star merge's
// 64 x 8,192 sort and ~6 us for the hop wave's 128 x 36,866 dedup; what
// costs time is the passes over the row, each a chain of barriers and
// shared-memory traffic.  The bitonic networks this replaced crossed shared
// memory log2(W2) (log2(W2) + 1) / 2 times a row (91 at 8,192 columns, 136
// at 36,866); the radix sort does it a handful of times:
//   1. one read of the row gives the valid keys' count, min and max (block
//      reductions); PAD is not sorted but counted: it sorts last and all
//      its copies are equal bits, so the sort writes W - n PAD words after
//      the n sorted valid keys, and the dedup drops them.  The valid keys
//      are also gathered into shared memory, as far as half of it (one
//      atomic a warp a load round; their order does not matter in a
//      keys-only sort, equal keys being equal bits).
//   2. the digit passes sort (key - min) as unsigned 32-bit values, 8 bits a
//      pass, only as many passes as max - min needs: none for a row with at
//      most one distinct key, three for the a1-kg gids (below 2^24), four
//      when the valid keys span more than 2^24.  A pass is one stable
//      counting scatter with three block barriers (see radix_pass):
//      warp-contiguous segments, per-warp 16-bit digit counts (16 KB for 32
//      warps), a scan of the 256 bucket totals, and a write of 32 keys at a
//      time ranked by eight ballots.  The passes ping-pong between two
//      buffers and end in the first, A.  Both lie in shared memory when 2n
//      keys fit (n <= 26,816 with 1,024 threads), the gathered keys being
//      the first pass's input; else B, then A too, is a row in global
//      memory the caller gives (B: a scratch row the wrapper allocates with
//      the outputs; A: another for the dedup, the output row itself for the
//      sort), L2-resident at the main path's sizes, and the first pass
//      reads the row itself, which keeps the passes that scatter into
//      global memory to floor(passes / 2).
//   3. sort_radix_kernel writes A[0, n) and then PAD into [n, W) (a row of
//      one distinct key: n copies of it).  dedup_radix_kernel marks the
//      first of each run of equal keys (-1 before slot 0), each warp counts
//      its segment's, one scan over the warps, and each warp writes its
//      firsts below cap; PAD fills the rest.
// One launch a call and one block a row: no grid-wide wait, no allocation.
// Rows up to 2,048 columns take a block of 256 threads, wider ones 1,024.
//
// The per-warp digit counts are 16-bit (two a word, 16 KB a block) up to
// kNarrowMaxW columns.  The dedup takes wider rows too (a hedged retry at
// 4x the a1-kg caps expands ~147,000 candidates a row): the same routine,
// instantiated with 32-bit counts (32 KB a block, so fewer keys stay in
// shared memory), both key buffers then being global rows of its scratch.
#include <cuda_runtime.h>

namespace {

constexpr int kPad = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDedupThreads = 1024;      // a block's threads (one block a row)
constexpr int kDedupThreadsSmall = 256;  // ... for rows up to kDedupSmallW
constexpr int kDedupSmallW = 2048;
constexpr int kRadix = 256;              // 8-bit digits
constexpr int kItems = 8;                // keys a lane has in flight at once
constexpr int kSmemMax = 232448;         // shared memory a block may use
constexpr int kRed = 128;                // words of reduction and scan scratch
constexpr int kNarrowMaxW = 57856;       // widest row of 16-bit digit counts
constexpr int kWideMaxW = 1073741824;    // widest dedup row (positions in int)

// A per-warp digit count: 16 bits up to kNarrowMaxW columns, else 32.
using Narrow = unsigned short;
using Wide = unsigned;

// Shared memory a block of `threads` needs besides its keys: the per-warp
// digit counts (count_bytes each), the 256 bucket starts and the scratch
// words.
__host__ __device__ constexpr int fixed_bytes(int threads, int count_bytes) {
  return threads / 32 * kRadix * count_bytes + kRadix * 4 + kRed * 4;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of `among` whose 8-bit digit equals this lane's, by one ballot
// a bit: eight ballots, where __match_any_sync's cost grows with the
// distinct digits in the warp (about 30 of 32 for random keys).
__device__ __forceinline__ unsigned match_digit(unsigned dg, unsigned among) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned m = __ballot_sync(kFull, (dg >> b) & 1u);
    among &= (dg >> b) & 1u ? m : ~m;
  }
  return among;
}

// One stable counting pass of the LSD radix sort: the keys of src[0, n_src)
// in order of digit ((key - mn) >> shift) & 255 into dst (kDropPad: src is
// the input row and its PAD slots are skipped).  Warp w owns the contiguous
// segment [w seg, (w + 1) seg) of src: it counts its keys' digits (shared
// atomics on its own counts), the bucket starts and each warp's start
// inside each bucket follow from the counts, and the warp then writes its
// keys in order, 32 at a time, each group ranked by match_digit.  Warps,
// and keys inside a warp, go in index order, so the pass is stable.  Three
// block barriers a pass.  C is the count type (Narrow: two counts a word).
template <bool kDropPad, typename C>
__device__ void radix_pass(const int* src, int n_src, int* dst, unsigned mn,
                           int shift, C* hist, unsigned* start, int* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned lt = lanemask_lt();
  C* wh = hist + warp * kRadix;
  unsigned* wh32 = (unsigned*)wh;
  constexpr int kWords = kRadix * (int)sizeof(C) / 4;
  for (int i = lane; i < kWords; i += 32) wh32[i] = 0u;
  __syncwarp();
  const int seg = (n_src + (int)blockDim.x - 1) / (int)blockDim.x * 32;
  const int lo = min(n_src, warp * seg), hi = min(n_src, lo + seg);
  for (int base = lo; base < hi; base += 32 * kItems) {
    int v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {   // every load in flight at once
      const int i = base + j * 32 + lane;
      v[j] = i < hi ? (kDropPad ? __ldg(src + i) : src[i]) : kPad;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {   // Narrow: two counts a word
      const unsigned dg = (((unsigned)v[j] - mn) >> shift) & 255u;
      if (base + j * 32 + lane < hi && (!kDropPad || v[j] != kPad)) {
        if (sizeof(C) == 2)
          atomicAdd(wh32 + (dg >> 1), 1u << ((dg & 1u) << 4));
        else
          atomicAdd(wh32 + dg, 1u);
      }
    }
  }
  __syncthreads();
  // bucket b (thread b): each warp's start inside the bucket (below n, so
  // C holds it), then the buckets' starts by a scan of their totals
  unsigned tot = 0;
  if (tid < kRadix) {
    unsigned c[kDedupThreads / 32];     // every count's load in flight
#pragma unroll
    for (int k = 0; k < kDedupThreads / 32; ++k)
      c[k] = k < warps ? hist[k * kRadix + tid] : 0u;
#pragma unroll
    for (int k = 0; k < kDedupThreads / 32; ++k) {
      if (k < warps) hist[k * kRadix + tid] = (C)tot;
      tot += c[k];
    }
  }
  unsigned inc = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31 && warp < kRadix / 32) red[warp] = (int)inc;
  __syncthreads();
  if (tid < kRadix) {
    unsigned before = 0;
    for (int k = 0; k < warp; ++k) before += (unsigned)red[k];
    start[tid] = before + inc - tot;
  }
  __syncthreads();
  for (int base = lo; base < hi; base += 32 * kItems) {
    int v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j * 32 + lane;
      v[j] = i < hi ? (kDropPad ? __ldg(src + i) : src[i]) : kPad;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool valid = base + j * 32 + lane < hi && (!kDropPad || v[j] != kPad);
      const unsigned dg = (((unsigned)v[j] - mn) >> shift) & 255u;
      const unsigned peers = match_digit(dg, __ballot_sync(kFull, valid));
      const unsigned before = valid ? (unsigned)wh[dg] : 0u;
      __syncwarp();
      if (valid && (peers & lt) == 0)
        wh[dg] = (C)(before + __popc(peers));
      __syncwarp();
      if (valid) dst[start[dg] + before + __popc(peers & lt)] = v[j];
    }
  }
  __syncthreads();
}

// A block's shared memory: fixed_bytes(blockDim.x, sizeof(C)), then
// key_cap words for keys.
template <typename C>
struct Smem {
  C* hist;                // per-warp digit counts
  unsigned* start;        // the 256 bucket starts
  int* red;               // kRed words of reduction and scan scratch
  int* keys;              // key_cap words
};

template <typename C>
__device__ __forceinline__ Smem<C> carve(unsigned char* dsm) {
  Smem<C> s;
  s.hist = (C*)dsm;
  s.start = (unsigned*)(dsm + (blockDim.x >> 5) * kRadix * sizeof(C));
  s.red = (int*)(s.start + kRadix);
  s.keys = s.red + kRed;
  return s;
}

// A row's valid keys after radix_sort_row: a[0, n) ascending when passes >
// 0; with passes == 0 the n valid keys are all mn (a is not set).
struct SortedRow {
  const int* a;
  int n, mn, passes;
};

// Steps 1 and 2 of the header on row xr (w columns): the valid keys' count,
// min and max, and the digit passes into buffer A.  A and B lie in shared
// memory when they fit, else in the global rows a_glob and b_glob (w words
// each; a_glob is used only when n > key_cap, b_glob only when 2n >
// key_cap).  Ends behind a block barrier.
template <typename C>
__device__ SortedRow radix_sort_row(const int* __restrict__ xr, int w,
                                    const Smem<C>& s, int key_cap,
                                    int* a_glob, int* b_glob) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  int* red = s.red;
  int* keys = s.keys;

  // 1. one read of the row: the valid keys' count, min and max; the valid
  //    keys are also gathered into shared memory (in any order: equal keys
  //    are equal bits) as far as half of it, and when all of them fit the
  //    passes start from there
  const int room = key_cap / 2;
  if (tid == 0) red[100] = 0;
  __syncthreads();
  int n = 0, mn = kPad, mx = -kPad - 1;
  const unsigned lt = lanemask_lt();
  for (int base = 0; base < w; base += (int)blockDim.x * kItems) {
    int v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + j * (int)blockDim.x + tid;
      v[j] = i < w ? __ldg(xr + i) : kPad;
    }
    unsigned b[kItems];
    int got = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool valid = v[j] != kPad;
      if (valid) {
        mn = min(mn, v[j]);
        mx = max(mx, v[j]);
      }
      b[j] = __ballot_sync(kFull, valid);
      got += __popc(b[j]);
    }
    n += lane == 0 ? got : 0;
    int at = 0;                       // one atomic a warp a load round
    if (lane == 0 && got) at = atomicAdd(&red[100], got);
    at = __shfl_sync(kFull, at, 0);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = at + __popc(b[j] & lt);
      if (v[j] != kPad && i < room) keys[i] = v[j];
      at += __popc(b[j]);
    }
  }
  n = __reduce_add_sync(kFull, n);
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if (lane == 0) {
    red[warp] = n;
    red[32 + warp] = mn;
    red[64 + warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    n = __reduce_add_sync(kFull, lane < warps ? red[lane] : 0);
    mn = __reduce_min_sync(kFull, lane < warps ? red[32 + lane] : kPad);
    mx = __reduce_max_sync(kFull, lane < warps ? red[64 + lane] : -kPad - 1);
    if (lane == 0) {
      red[96] = n;
      red[97] = mn;
      red[98] = mx;
    }
  }
  __syncthreads();
  SortedRow row;
  row.a = nullptr;
  row.n = n = red[96];
  row.mn = mn = red[97];
  mx = red[98];
  // digit passes: as many as the bits of max - min need (none for a row
  // with at most one distinct valid key)
  const unsigned range = (unsigned)mx - (unsigned)mn;
  const int passes = n == 0 || range == 0 ? 0 : (39 - __clz(range)) >> 3;
  row.passes = passes;
  if (passes == 0) return row;

  // 2. the passes, least significant digit first, ping-ponging between A
  //    and B so that the last one writes A.  A and B lie in shared memory
  //    when they fit (both for most rows), else in the global rows (L2).
  const bool gather = n <= room;
  int *A, *B;
  if (gather) {            // the gathered keys, keys[0, n), are pass 0's source
    A = (passes & 1) ? keys + n : keys;
    B = (passes & 1) ? keys : keys + n;
  } else {
    A = n <= key_cap ? keys : a_glob;
    B = 2 * n <= key_cap ? keys + n : b_glob;
  }
  const int* src = gather ? ((passes & 1) ? B : A) : xr;
  for (int p = 0; p < passes; ++p) {
    int* dst = ((passes - 1 - p) & 1) ? B : A;
    if (p == 0 && !gather)
      radix_pass<true>(src, w, dst, (unsigned)mn, 0, s.hist, s.start, red);
    else
      radix_pass<false>(src, n, dst, (unsigned)mn, 8 * p, s.hist, s.start,
                        red);
    src = dst;
  }
  row.a = A;
  return row;
}

// Sort every row: scratch holds [R][w] words for B when two key buffers of
// w keys do not fit in shared memory; A's global row is the output row.
__global__ void __launch_bounds__(kDedupThreads)
sort_radix_kernel(const int* __restrict__ x, int* __restrict__ out,
                  int* __restrict__ scratch, int w, int key_cap) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  int* o = out + r * w;
  const SortedRow row = radix_sort_row(x + r * w, w, carve<Narrow>(dsm),
                                       key_cap, o,
                                       scratch + r * w);
  // 3. the sorted valid keys (unless A is the output row), then PAD
  if (row.passes == 0) {
    for (int i = tid; i < w; i += blockDim.x) o[i] = i < row.n ? row.mn : kPad;
    return;
  }
  if (row.a != o)
    for (int i = tid; i < row.n; i += blockDim.x) o[i] = row.a[i];
  for (int i = row.n + tid; i < w; i += blockDim.x) o[i] = kPad;
}

// Dedup/compact every row: scratch holds [R][w] words for B, then (when w >
// key_cap) another [R][w] for A, for key buffers that do not fit in shared
// memory.  C: the digit counts' type (Wide past kNarrowMaxW columns).
template <typename C>
__global__ void __launch_bounds__(kDedupThreads)
dedup_radix_kernel(const int* __restrict__ x, int* __restrict__ out,
                   int* __restrict__ counts, int* __restrict__ scratch, int R,
                   int w, int cap, int key_cap) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const long long r = blockIdx.x;
  const Smem<C> s = carve<C>(dsm);
  int* red = s.red;
  int* o = out + r * cap;
  const SortedRow row = radix_sort_row(x + r * w, w, s, key_cap,
                                       scratch + ((long long)R + r) * w,
                                       scratch + r * w);
  const int n = row.n;
  if (row.passes == 0) {
    const int total = n > 0 && row.mn != -1 ? 1 : 0;
    for (int i = tid; i < cap; i += blockDim.x) o[i] = i < total ? row.mn : kPad;
    if (tid == 0) counts[r] = total;
    return;
  }
  const int* A = row.a;

  // 3. the first of each run of equal keys (-1 before slot 0), compacted:
  //    each warp counts the firsts of its segment, one scan over the warps,
  //    then each warp writes its firsts below cap
  const unsigned lt = lanemask_lt();
  const int seg = (n + (int)blockDim.x - 1) / (int)blockDim.x * 32;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  int mine = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int v = i < hi ? A[i] : kPad;
    int pv = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) pv = i ? A[i - 1] : -1;
    mine += __popc(__ballot_sync(kFull, i < hi && v != pv));
  }
  if (lane == 0) red[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < warps ? red[lane] : 0;
    int inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    red[32 + lane] = inc - c;
    if (lane == 31) red[64] = inc;
  }
  __syncthreads();
  int rank = red[32 + warp];
  const int total = red[64];
  for (int base = lo; base < hi && rank < cap; base += 32) {
    const int i = base + lane;
    const int v = i < hi ? A[i] : kPad;
    int pv = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) pv = i ? A[i - 1] : -1;
    const bool f = i < hi && v != pv;
    const unsigned b = __ballot_sync(kFull, f);
    const int at = rank + __popc(b & lt);
    if (f && at < cap) o[at] = v;
    rank += __popc(b);
  }
  for (int i = min(total, cap) + tid; i < cap; i += blockDim.x) o[i] = kPad;
  if (tid == 0) counts[r] = total;
}

// A launch's shape for rows of w columns: threads, the counts' width (wide
// past kNarrowMaxW), dynamic shared memory (fixed_bytes + room for two
// buffers of w keys, at most kSmemMax) and the keys that room holds.
struct Launch {
  int threads, bytes, key_cap;
  bool wide;
};

Launch launch_for(int w) {
  Launch l;
  l.threads = w <= kDedupSmallW ? kDedupThreadsSmall : kDedupThreads;
  l.wide = w > kNarrowMaxW;
  const int fixed = fixed_bytes(l.threads, l.wide ? 4 : 2);
  const long long want = fixed + 8LL * w;
  l.bytes = (int)(want < kSmemMax ? want : kSmemMax);
  l.key_cap = (l.bytes - fixed) / 4;
  return l;
}

cudaError_t shared_limit(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename C>
cudaError_t launch_dedup(const Launch& l, const void* x, void* out,
                         void* counts, void* scratch, int n_rows, int w,
                         int cap, void* stream) {
  cudaError_t err = shared_limit((const void*)dedup_radix_kernel<C>, l.bytes);
  if (err != cudaSuccess) return err;
  if (n_rows > 0)
    dedup_radix_kernel<C><<<n_rows, l.threads, l.bytes, (cudaStream_t)stream>>>(
        (const int*)x, (int*)out, (int*)counts, (int*)scratch, n_rows, w, cap,
        l.key_cap);
  return cudaGetLastError();
}

}  // namespace

// Sort every row of x (n_rows x w, w <= kNarrowMaxW) into out.  scratch
// holds scratch_words words: 0 when two key buffers of w keys fit in shared
// memory, else n_rows * w; less, or a wider row, returns
// cudaErrorInvalidValue.
extern "C" int sort_rows(const void* x, void* out, void* scratch,
                         long long scratch_words, int n_rows, int w,
                         void* stream) {
  const Launch l = launch_for(w);
  const long long need = 2LL * w <= l.key_cap ? 0 : (long long)n_rows * w;
  if (l.wide || need > scratch_words) return (int)cudaErrorInvalidValue;
  cudaError_t err = shared_limit((const void*)sort_radix_kernel, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0)
    sort_radix_kernel<<<n_rows, l.threads, l.bytes, (cudaStream_t)stream>>>(
        (const int*)x, (int*)out, (int*)scratch, w, l.key_cap);
  return (int)cudaGetLastError();
}

// Dedup/compact every row of x (n_rows x w, w <= kWideMaxW) into out
// (n_rows x cap) and counts (n_rows).  scratch holds scratch_words words: 0
// when two key buffers of w keys fit in shared memory, else n_rows * w (w <=
// key_cap) or 2 * n_rows * w; less, or a wider row, returns
// cudaErrorInvalidValue.
extern "C" int dedup_compact_rows(const void* x, void* out, void* counts,
                                  void* scratch, long long scratch_words,
                                  int n_rows, int w, int cap, void* stream) {
  const Launch l = launch_for(w);
  const long long need = 2LL * w <= l.key_cap
      ? 0 : (long long)n_rows * w * (w <= l.key_cap ? 1 : 2);
  if (w > kWideMaxW || need > scratch_words)
    return (int)cudaErrorInvalidValue;
  return (int)(l.wide ? launch_dedup<Wide>(l, x, out, counts, scratch, n_rows,
                                           w, cap, stream)
                      : launch_dedup<Narrow>(l, x, out, counts, scratch,
                                             n_rows, w, cap, stream));
}
