// Lexicographic sort of flat (k1, k2) int32 pairs for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dedup_compact/kernel.py::sort_pairs (the Pallas
// TPU kernel behind backend.sort_pairs, which the shared-frontier planner
// calls once per hop in _dedup_pairs and once per star merge in _merge_flat).
// It sorts W pairs ascending by (k1, k2) as signed int32, which is
// jax.lax.sort((k1, k2), num_keys=2).  A pair is the whole record, so every
// correct sort gives the same bits.
//
// What bounds it: the TPU kernel sorts the whole width in one VMEM block.  At
// the a1-kg caps the shared pool's candidates are ~130 K-450 K pairs a hop,
// 3.5 MB of keys that stay in the 50 MB L2, so the bytes bound (16 a pair
// read and written) is ~2 us; what costs time is the passes: each is a chain
// of dependent steps (a tile id, loads, ranking, look-back, write-out) of
// several microseconds however few keys it moves.  So the design does as
// few passes as the keys need.  Each pair is packed into one 64-bit key,
//   (u64)(k1 ^ 0x80000000) << 32 | (u32)(k2 ^ 0x80000000),
// whose unsigned order is the signed lexicographic order, and the keys are
// sorted by a least-significant-digit radix sort of 8-bit digits (eight
// digit positions), skipping every digit that is constant over the input:
//
//   * radix_hist_kernel counts all eight digits of every key at once (one
//     read of the input; 1,024 threads a block, and a warp whose lanes share
//     a digit adds them with one shared-memory atomic).  Each block writes
//     its own counts (no zeroed memory needed), and the kernel zeroes the
//     scratch the passes need: the digits' totals, the tile counters and the
//     look-back words (no memset launch).
//   * radix_pass_kernel is launched once for each digit position, always:
//     the host never waits on the device.  In pass 0 tile g adds histogram
//     block g's counts to the totals (atomics), every tile waits until all
//     have, and the digits with a bucket holding every key are the constant
//     ones; the mask of the others goes to the later passes.  That wait is
//     safe only while every contributor can be resident at once: tile ids
//     come in the order blocks start, so the contributors are the first
//     n_hist blocks, and n_hist is capped at the pass blocks the card holds
//     together (resident_pass_blocks; the histogram grid-strides past it).
//     On the main path k1 is a segment in [0, R] and k2 a gid or PAD, so five
//     of the eight digits vary (gid bits 0-23, PAD against gid, the
//     segment).  A pass whose digit is constant returns at once; real pass r
//     reads buffer (r - 1) & 1 (the first reads and packs the inputs) and
//     writes buffer r & 1, and the last real pass writes the unpacked
//     outputs.  With mask 0 (all keys equal) pass 0 copies the input.  The
//     passes are launched with programmatic dependent launch, so a pass's
//     launch and its first steps (tile id, mask, its digit's totals) overlap
//     the pass before.
//   * A pass is one stable counting scatter.  A tile of 256 threads x 8 keys
//     (in registers, warp-striped so that index order is (warp, item, lane))
//     ranks its keys by digit warp by warp: __match_any_sync groups the lanes
//     of one digit and their leader adds the group to the warp's counts, so
//     a bucket that every lane hits (the ghost pairs (R, PAD)) costs one
//     shared-memory update, not 32.  The tile's counts are published with
//     decoupled look-back (tile ids from an atomic counter, so every earlier
//     tile is running; flag and count in one 32-bit word, a bucket's count
//     below W <= 2^30; 16 earlier tiles' words read at once), the keys are
//     placed in digit order in shared memory, and each run of one digit is
//     written out contiguously.
//
// Widths up to kSmallMax take one launch instead: one block sorts them in
// shared memory with an ascending-only bitonic network over a virtual
// power-of-two width (slots at or past W hold the largest key and are never
// stored).  On an H100 that launch took less time a call than the radix
// sort's nine up to 4,096 pairs; at 5,120 the two tied a call and the radix
// sort took less device time.  Every kernel stays under the 48 KB of shared
// memory a launch gets without cudaFuncSetAttribute.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallMax = 4096;          // widths the one-block sort takes (32 KB)
constexpr int kSmallThreads = 1024;

constexpr int kDigits = 8;               // 8-bit digits of a 64-bit key
constexpr int kRadix = 256;
constexpr int kThreads = 256;            // a pass tile's threads (one a bucket)
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                // keys a thread holds in a pass
constexpr int kTile = kThreads * kItems;  // 2,048 keys a tile
constexpr int kHistThreads = 1024;       // a histogram block's threads
constexpr int kHistItems = 4;            // keys a histogram thread counts
constexpr int kHistKeys = kHistThreads * kHistItems;
constexpr int kHistMaxBlocks = 1024;     // the wrapper sizes the scratch for it
constexpr int kMaxDevices = 64;
constexpr int kLook = 16;                // look-back words read at once
constexpr int kHeader = 32;              // done, mask, tile counters[8]
constexpr unsigned kFlagA = 1u << 30;    // the tile's own count
constexpr unsigned kFlagP = 1u << 31;    // the count of every tile up to it
constexpr unsigned kValue = kFlagA - 1;

__device__ __forceinline__ u64 pack(int a, int b) {
  return ((u64)((unsigned)a ^ 0x80000000u) << 32) |
         (u64)((unsigned)b ^ 0x80000000u);
}

__device__ __forceinline__ int hi_of(u64 v) {
  return (int)((unsigned)(v >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int lo_of(u64 v) {
  return (int)((unsigned)(v & 0xffffffffu) ^ 0x80000000u);
}

// ---------------------------------------------------------------------------
// One launch for small widths: a bitonic network in one block
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// Comparator c of step (k, j) over a power-of-two width: its lower slot i and
// upper slot p > i (the mirror for the first step of a merge, else i + j).
__device__ __forceinline__ void slots(int c, int k, int j, bool mirror, int* i,
                                      int* p) {
  const int lj = ilog2(j);
  *i = ((c >> lj) << (lj + 1)) | (c & (j - 1));
  *p = mirror ? (*i ^ (k - 1)) : (*i + j);
}

// The whole network over the w keys (virtual width w2) in shared memory.
__global__ void small_sort_kernel(const int* __restrict__ k1,
                                  const int* __restrict__ k2,
                                  int* __restrict__ o1, int* __restrict__ o2,
                                  int w, int w2) {
  extern __shared__ u64 s[];
  for (int i = threadIdx.x; i < w; i += blockDim.x) s[i] = pack(k1[i], k2[i]);
  __syncthreads();
  const int n_cmp = w2 / 2 < w ? w2 / 2 : w;  // comparator c has lower slot >= c
  for (int k = 2; k <= w2; k <<= 1)
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int c = threadIdx.x; c < n_cmp; c += blockDim.x) {
        int i, p;
        slots(c, k, j, j == (k >> 1), &i, &p);
        if (p < w) {
          const u64 a = s[i], b = s[p];
          if (a > b) { s[i] = b; s[p] = a; }
        }
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    o1[i] = hi_of(s[i]);
    o2[i] = lo_of(s[i]);
  }
}

// ---------------------------------------------------------------------------
// The radix sort
// ---------------------------------------------------------------------------

// Where each part of the wrapper's one scratch allocation lies.
struct Layout {
  u64* buf[2];          // ping-pong key buffers, w keys each
  unsigned* part;       // [n_hist][8][256] each histogram block's counts
  unsigned* done;       // pass-0 tiles that added their block's counts
  unsigned* mask;       // digits that vary (bit d)
  unsigned* ctr;        // [8] tile counter of each pass
  unsigned* totals;     // [8][256] each digit's bucket counts
  unsigned* look;       // [8][n_tiles][256] look-back words of each pass
  unsigned* zero;       // from done to the end: zeroed by the histogram
  long long zero_words;
  int n_tiles, n_hist;
};

Layout make_layout(void* scratch, int w, int max_hist, long long* bytes) {
  Layout L;
  char* p = (char*)scratch;
  L.buf[0] = (u64*)p;
  p += 8LL * w;
  L.buf[1] = (u64*)p;
  p += 8LL * w;
  L.n_tiles = (w + kTile - 1) / kTile;
  L.n_hist = (w + kHistKeys - 1) / kHistKeys;   // <= n_tiles
  if (L.n_hist > max_hist) L.n_hist = max_hist;
  L.part = (unsigned*)p;
  p += 4LL * L.n_hist * kDigits * kRadix;
  L.zero = L.done = (unsigned*)p;
  L.mask = L.done + 1;
  L.ctr = L.done + 8;
  L.totals = L.done + kHeader;
  L.look = L.totals + kDigits * kRadix;
  L.zero_words = kHeader + kDigits * kRadix +
                 (long long)kDigits * L.n_tiles * kRadix;
  p += 4LL * L.zero_words;
  *bytes = p - (char*)scratch;
  return L;
}

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *(const volatile unsigned*)p;
}

__device__ __forceinline__ void st_volatile(unsigned* p, unsigned v) {
  *(volatile unsigned*)p = v;
}

// Exclusive prefix sum of one value a thread over a kThreads block.
__device__ unsigned block_excl_scan(unsigned x, unsigned* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned before = 0;
  for (int k = 0; k < warp; ++k) before += s_warp[k];
  __syncthreads();                       // s_warp free for the next scan
  return before + inc - x;
}

// Counts of all eight digits of every key, kHistKeys a block (grid-stride
// past n_hist blocks): block g's go to part[g].  Also zeroes the
// passes' scratch (no memset launch).
__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const int* __restrict__ k1, const int* __restrict__ k2,
                  Layout L, int w) {
  __shared__ unsigned h[kDigits * kRadix];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (long long i = (long long)blockIdx.x * kHistThreads + tid;
       i < L.zero_words; i += (long long)gridDim.x * kHistThreads)
    L.zero[i] = 0;
  for (int i = tid; i < kDigits * kRadix; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int wbase = warp * 32 * kHistItems;
  for (long long base = (long long)blockIdx.x * kHistKeys; base < w;
       base += (long long)gridDim.x * kHistKeys) {
    const int n = (int)min((long long)kHistKeys, (long long)w - base);
    u64 key[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {  // every load in flight at once
      const int i = wbase + j * 32 + lane;
      if (i < n) key[j] = pack(k1[base + i], k2[base + i]);
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const bool valid = wbase + j * 32 + lane < n;
      const unsigned vm = __ballot_sync(kFull, valid);
      if (vm == 0) continue;             // the whole warp past the end
#pragma unroll
      for (int d = 0; d < kDigits; ++d) {
        const unsigned dg = valid ? (unsigned)(key[j] >> (8 * d)) & 255u : 0u;
        const unsigned d0 = __shfl_sync(kFull, dg, 0);  // lane 0 is valid
        if (__all_sync(kFull, !valid || dg == d0)) {
          if (lane == 0) atomicAdd(&h[d * kRadix + d0], (unsigned)__popc(vm));
        } else if (valid) {
          atomicAdd(&h[d * kRadix + dg], 1u);
        }
      }
    }
  }
  __syncthreads();
  unsigned* part = L.part + (long long)blockIdx.x * kDigits * kRadix;
  for (int i = tid; i < kDigits * kRadix; i += kHistThreads) part[i] = h[i];
}

// Programmatic dependent launch: a pass's blocks may start before the pass
// before it ends; each waits for it (and its memory) before touching
// anything that pass or an earlier kernel of the sort wrote, then lets the
// next pass's launch begin.
__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const int* __restrict__ k1, const int* __restrict__ k2,
                  int* __restrict__ o1, int* __restrict__ o2, Layout L, int w,
                  int pass) {
  __shared__ u64 s_keys[kTile];
  __shared__ unsigned s_whist[kWarps * kRadix];  // per-warp digit counts
  __shared__ unsigned s_excl[kRadix];   // tile-local start of each bucket
  __shared__ unsigned s_glob[kRadix];   // global position - local index
  __shared__ unsigned s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ unsigned s_const;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = tid;
  // pass p >= 2 may read what pass 0 and the histogram left before the
  // pass just before it ends; passes 0 and 1 wait first
  if (pass < 2) wait_previous_grid();
  if (tid == 0) {
    s_tile = (int)atomicAdd(&L.ctr[pass], 1u);
    s_const = 0;
  }
  unsigned mask = 0, total = 0;
  if (pass > 0) {                        // the mask pass 0 left
    mask = *L.mask;
    total = L.totals[pass * kRadix + b];
  }
  if (pass >= 2) wait_previous_grid();
  launch_next_grid();
  if (pass > 0 && !((mask >> pass) & 1u)) return;
  __syncthreads();
  const int tile = s_tile;
  if (pass == 0) {
    // tile g < n_hist adds histogram block g's counts to the totals; every
    // tile waits for all of them, then finds the digits that vary
    if (tile < L.n_hist) {
      const unsigned* p = L.part + (long long)tile * kDigits * kRadix + b;
      unsigned v[kDigits];
#pragma unroll
      for (int d = 0; d < kDigits; ++d) v[d] = p[d * kRadix];
#pragma unroll
      for (int d = 0; d < kDigits; ++d)
        if (v[d]) atomicAdd(&L.totals[d * kRadix + b], v[d]);
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicAdd(L.done, 1u);
    }
    if (tid == 0) {
      while (ld_volatile(L.done) < (unsigned)L.n_hist) {
      }
      __threadfence();
    }
    __syncthreads();
    unsigned cm = 0;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      const unsigned t = __ldcg(&L.totals[d * kRadix + b]);
      if (d == 0) total = t;
      if (t == (unsigned)w) cm |= 1u << d;
    }
    cm = __reduce_or_sync(kFull, cm);
    if (lane == 0 && cm) atomicOr(&s_const, cm);
    __syncthreads();
    mask = ~s_const & 0xffu;
    if (tile == 0 && tid == 0) *L.mask = mask;
  }
  if (tile >= L.n_tiles) return;
  const long long base = (long long)tile * kTile;
  const int n = (int)min((long long)kTile, (long long)w - base);
  if (mask == 0) {                       // every key equal: already sorted
    for (int i = tid; i < n; i += kThreads) {
      o1[base + i] = k1[base + i];
      o2[base + i] = k2[base + i];
    }
    return;
  }
  if (!((mask >> pass) & 1u)) return;
  const int r = __popc(mask & ((1u << pass) - 1u));  // real passes before
  const bool first = r == 0, last = (mask >> (pass + 1)) == 0;
  const u64* src = (r & 1) ? L.buf[0] : L.buf[1];
  u64* dst = (r & 1) ? L.buf[1] : L.buf[0];
  const int shift = 8 * pass;

  // keys in registers, warp-striped: item j of lane l is key wbase + 32 j + l
  const int wbase = warp * 32 * kItems;
  u64 key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = wbase + j * 32 + lane;
    if (i < n) key[j] = first ? pack(k1[base + i], k2[base + i]) : src[base + i];
  }
  for (int i = tid; i < kWarps * kRadix; i += kThreads) s_whist[i] = 0;
  const unsigned gofs = block_excl_scan(total, s_warp);  // bucket b's start

  // stable rank of each key among its warp's keys of its digit
  unsigned* wh = s_whist + warp * kRadix;
  const unsigned below = (1u << lane) - 1u;
  unsigned rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = wbase + j * 32 + lane < n;
    const unsigned dg = valid ? (unsigned)(key[j] >> shift) & 255u : 256u;
    const unsigned peers = __match_any_sync(kFull, dg);
    const unsigned before = valid ? wh[dg] : 0u;
    __syncwarp();
    if (valid && (peers & below) == 0) wh[dg] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & below);
  }
  __syncthreads();

  // bucket b: each warp's start inside the bucket, the tile's count
  unsigned cnt = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const unsigned c = s_whist[k * kRadix + b];
    s_whist[k * kRadix + b] = cnt;
    cnt += c;
  }
  unsigned* look = L.look + (long long)pass * L.n_tiles * kRadix;
  st_volatile(&look[(long long)tile * kRadix + b],
              (tile == 0 ? kFlagP : kFlagA) | cnt);
  const unsigned ex = block_excl_scan(cnt, s_warp);
  s_excl[b] = ex;
  // decoupled look-back: add the counts of the tiles before until one that
  // has published its inclusive prefix (tile 0 always has)
  unsigned prefix = 0;
  if (tile > 0) {
    int t = tile - 1;
    bool done = false;
    while (!done) {
      unsigned v[kLook];
#pragma unroll
      for (int k = 0; k < kLook; ++k)
        v[k] = t - k >= 0 ? ld_volatile(&look[(long long)(t - k) * kRadix + b])
                          : kFlagP;
#pragma unroll
      for (int k = 0; k < kLook; ++k) {
        if (v[k] == 0) break;            // not published yet: read again
        prefix += v[k] & kValue;
        --t;
        if (v[k] & kFlagP) {
          done = true;
          break;
        }
      }
    }
    st_volatile(&look[(long long)tile * kRadix + b], kFlagP | (prefix + cnt));
  }
  s_glob[b] = gofs + prefix - ex;
  __syncthreads();

  // the tile in digit order in shared memory, then each digit's run out
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (wbase + j * 32 + lane < n) {
      const unsigned dg = (unsigned)(key[j] >> shift) & 255u;
      s_keys[s_excl[dg] + s_whist[warp * kRadix + dg] + rank[j]] = key[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const u64 k = s_keys[i];
    const unsigned pos = s_glob[(unsigned)(k >> shift) & 255u] + (unsigned)i;
    if (last) {
      o1[pos] = hi_of(k);
      o2[pos] = lo_of(k);
    } else {
      dst[pos] = k;
    }
  }
}

// The most radix_pass_kernel blocks the current device holds at once, found
// once for each device (pass 0 needs its first n_hist tiles resident
// together), at most kHistMaxBlocks.
cudaError_t max_hist_blocks(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      radix_pass_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm < kHistMaxBlocks ? sms * per_sm : kHistMaxBlocks;
  if (dev < kMaxDevices) cached[dev] = *out;
  return cudaSuccess;
}

}  // namespace

// Sort w pairs.  Widths up to kSmallMax take the one-block sort; the others
// the radix sort in `scratch` (scratch_bytes long, room for kHistMaxBlocks
// histogram blocks; too short returns cudaErrorInvalidValue).
extern "C" int sort_pairs(const void* k1, const void* k2, void* o1, void* o2,
                          void* scratch, long long scratch_bytes, int w,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int *a = (const int*)k1, *b = (const int*)k2;
  int *oa = (int*)o1, *ob = (int*)o2;
  if (w <= 0) return (int)cudaGetLastError();
  if (w <= kSmallMax) {
    int w2 = 1;
    while (w2 < w) w2 <<= 1;
    const int threads = w2 / 2 < 32 ? 32
                        : (w2 / 2 > kSmallThreads ? kSmallThreads : w2 / 2);
    small_sort_kernel<<<1, threads, w * (int)sizeof(u64), st>>>(a, b, oa, ob,
                                                               w, w2);
    return (int)cudaGetLastError();
  }
  int max_hist = 0;
  cudaError_t err = max_hist_blocks(&max_hist);
  if (err != cudaSuccess) return (int)err;
  long long need;
  const Layout L = make_layout(scratch, w, max_hist, &need);
  if (need > scratch_bytes) return (int)cudaErrorInvalidValue;
  radix_hist_kernel<<<L.n_hist, kHistThreads, 0, st>>>(a, b, L, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.n_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  for (int pass = 0; pass < kDigits; ++pass) {
    err = cudaLaunchKernelEx(&cfg, radix_pass_kernel, a, b, oa, ob, L, w,
                             pass);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
