// Batched k-NN distance and top-k over the vector index for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/knn_topk/kernel.py::knn_topk (the Pallas TPU
// kernel behind backend.knn_topk, the Nearest probe wave of both planners).
// For each query row r it scores every index entry e with the surrogate
// distance ||e||^2 - 2<v_r, e> (+0.0), keeps entries with gid >= 0, the row's
// vertex type and create <= ts_r < delete, and returns the k smallest by
// (dist, gid) ascending, with (+inf, INT32_MAX) in empty slots.
//
// Summation order: ee = sum_d e_d*e_d and ip = sum_d v_d*e_d, d = 0..D-1,
// each multiply and each add rounded on its own (__fmul_rn / __fadd_rn, never
// contracted to an FMA), then dist = (ee - 2*ip) + 0.0.  The plain PyTorch
// version uses the same order, so the two agree bit for bit.  Rows and
// entries are zero-padded to D4 = D rounded up to 4: a padded term adds +0.0,
// which leaves ee (never -0.0) and, after the final + 0.0, dist unchanged.
//
// What bounds it: at one machine's share the index holds 4 M entries of
// D = 32.  64 query rows need 2*R*N*D = 17.2 G multiplies and adds, 0.256 ms
// at the float32 rate; unfused, every one is its own instruction, so the
// floor on an H100 (FMUL and FADD each issue 128 lanes an SM a clock) is
// ~0.53 ms.  One row needs 0.27 G of them but must read the index (0.6 GB
// with its four int columns): ~0.18 ms of device memory.  The cut depends
// on R (wr, the warps a block spreads over rows):
//   * A warp owns RW rows and, per tile, 32*ET entries (lane + 32 h, h < ET),
//     and accumulates the RW x ET distances in registers.  Entry rows lie in
//     shared memory with an odd number of 16-byte columns (DS floats), so
//     one 16-byte load gives four dims of one entry without bank conflicts,
//     and a query row's four dims are one broadcast 16-byte load: at RW = 8,
//     ET = 4 that is 12 loads for 256 multiplies and adds.  Each warp also
//     sums its entries' ee in the same d loop (an eighth more arithmetic, no
//     barrier).
//   * A block (8 warps) spreads wr warps over rows and 8/wr over entries:
//     R > 32 takes 64 rows x 128 entries (ET = 4), R <= 8 takes 8 rows x 256
//     entries (ET = 1): at one row the warps stream the index, at many they
//     reuse each tile 64 times.
//   * Entry tiles (rows and the four int columns) come through a two-stage
//     cp.async ring, 16-byte copies when D % 4 == 0: the next tile loads
//     while this one is computed, one block barrier a tile.
//   * The grid is one wave of blocks (two an SM where they fit), each over
//     one contiguous chunk of the index, so the lists to merge are few.
//   * A distance is checked against its row's k-th best only after (ee - 2
//     ip) passes it, so most pairs cost a subtraction and a compare.
//   * Top-k, k <= 32 (the main path's k = 8): a row's k best (dist, gid) are
//     held across its warp's lanes, lane i the i-th, sorted; its k-th best
//     is the threshold, one shuffle away.  A candidate is inserted with a
//     ballot (its place), a shuffle up and a shuffle of the new threshold.
//     Each warp writes one list a row a chunk, and knn_merge_warp_kernel
//     merges a row's lists the same way, 32 warps, then one.
//   * Top-k, k > 32: a row's list of kp = pow2ceil(k) lives in shared memory
//     (one row a warp, RW = ET = 1) with room for a tile's candidates; after
//     each tile the block sorts the rows that got candidates with a two-key
//     bitonic network, and knn_merge_kernel merges the per-chunk lists in
//     passes of `group`.
// Its times on an H100 against these bounds: PERF.md section 6
// (chip_smoke.py's kernel report).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;              // the entry tiles' cp.async ring
constexpr int kWarpK = 32;              // k a warp-held list takes
constexpr int kMergeThreads = 1024;
constexpr int kI32Max = 0x7fffffff;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool less(float da, int ga, float db, int gb) {
  return da < db || (da == db && ga < gb);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

struct KnnArgs {
  const float* vecs;
  const float* emb;
  const int* meta[4];     // gid, vtype, create, delete
  const int* q_vt;
  const int* q_ts;
  float* ld;              // per-chunk lists: [R][n_lists][kp]
  int* lg;
  long long N, chunk;
  int R, D, D4, DS;       // dims, padded dims, entry row stride in smem
  int k, kp, wr, m;       // list length and stride, warps over rows, slots
  int n_lists;            //   a shared-memory list holds; lists a row
  int vec16;              // 16-byte copies of the entry rows
};

// Insert (d, g) into the warp's sorted list (lane i holds the i-th best,
// lanes past k the evicted or empty slots, still sorted) if it beats the
// threshold (thd, thg), the k-th best; then refresh the threshold.
// Warp-uniform arguments; every lane calls it.
__device__ __forceinline__ void insert(float& ld, int& lg, float& thd,
                                       int& thg, float d, int g, int k) {
  if (!less(d, g, thd, thg)) return;
  const int lane = threadIdx.x & 31;
  const int pos = __popc(__ballot_sync(kFull, less(ld, lg, d, g)));
  const float ud = __shfl_up_sync(kFull, ld, 1);
  const int ug = __shfl_up_sync(kFull, lg, 1);
  if (lane > pos) {
    ld = ud;
    lg = ug;
  } else if (lane == pos) {
    ld = d;
    lg = g;
  }
  thd = __shfl_sync(kFull, ld, k - 1);
  thg = __shfl_sync(kFull, lg, k - 1);
}

// The lanes in mk offer (d, g) to the warp's list (threshold thd, thg), one
// insert each, in lane order.
__device__ __forceinline__ void offer(float& ld, int& lg, float& thd,
                                      int& thg, unsigned mk, float d, int g,
                                      int k) {
  while (mk) {
    const int src = __ffs(mk) - 1;
    mk &= mk - 1;
    insert(ld, lg, thd, thg, __shfl_sync(kFull, d, src),
           __shfl_sync(kFull, g, src), k);
  }
}

// Ascending-only two-key network over the n stored slots of (d, g) (virtual
// width pow2ceil(n), slots past n are (+inf, INT32_MAX) and never touched),
// run by the whole block.
__device__ void sort2(float* d, int* g, int n) {
  int w2 = 1;
  while (w2 < n) w2 <<= 1;
  const int half = w2 >> 1, n_cmp = half < n ? half : n;
  for (int k = 2; k <= w2; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      const int lj = 31 - __clz(j);
      const bool mirror = j == (k >> 1);
      for (int c = threadIdx.x; c < n_cmp; c += blockDim.x) {
        const int i = ((c >> lj) << (lj + 1)) | (c & (j - 1));
        const int p = mirror ? (i ^ (k - 1)) : (i + j);
        if (p < n && less(d[p], g[p], d[i], g[i])) {
          const float td = d[i];
          const int tg = g[i];
          d[i] = d[p]; g[i] = g[p];
          d[p] = td; g[p] = tg;
        }
      }
      __syncthreads();
    }
  }
}

// Copy entries [t0, t0 + nt) into a ring stage: te rows of DS floats, then
// the four int columns (te each).  One commit group.
__device__ void load_tile(const KnnArgs& a, float* stage, long long t0, int nt,
                          int te, int lg_te) {
  const int tid = threadIdx.x;
  const int per = a.vec16 ? a.D >> 2 : a.D;   // copies an entry row
  const int step = a.vec16 ? 4 : 1;
  const int total = nt * per;
  const int pd = per > 0 ? per : 1;          // D = 0: nothing to copy
  int e = tid / pd, q = tid - e * pd;        // copy c = tid + kThreads j
  const int de = kThreads / pd, dq = kThreads - de * pd;
  for (int c = tid; c < total; c += kThreads) {
    float* dst = stage + e * a.DS + q * step;
    const float* src = a.emb + (t0 + e) * a.D + q * step;
    if (a.vec16) cp_async16(dst, src);
    else cp_async4(dst, src);
    e += de;
    q += dq;
    if (q >= per) {
      q -= per;
      ++e;
    }
  }
  int* m_s = (int*)(stage + te * a.DS);
  for (int c = tid; c < 4 * te; c += kThreads) {
    const int col = c >> lg_te, j = c & (te - 1);
    if (j < nt) cp_async4(m_s + c, a.meta[col] + t0 + j);
  }
  cp_async_commit();
}

// acc[i][h] += v_i . e_h and ee[h] += e_h . e_h over the padded dims, in d
// order; rows i >= nr are skipped when kGuard.
template <int RW, int ET, bool kGuard>
__device__ __forceinline__ void tile_dot(const float* eb, const float* vb,
                                         const KnnArgs& a, int nr,
                                         float (&acc)[RW][ET],
                                         float (&ee)[ET]) {
  for (int q = 0; q < a.D4; q += 4) {
    float4 e4[ET];
#pragma unroll
    for (int h = 0; h < ET; ++h)
      e4[h] = *(const float4*)(eb + 32 * h * a.DS + q);
#pragma unroll
    for (int h = 0; h < ET; ++h) {
      ee[h] = __fadd_rn(ee[h], __fmul_rn(e4[h].x, e4[h].x));
      ee[h] = __fadd_rn(ee[h], __fmul_rn(e4[h].y, e4[h].y));
      ee[h] = __fadd_rn(ee[h], __fmul_rn(e4[h].z, e4[h].z));
      ee[h] = __fadd_rn(ee[h], __fmul_rn(e4[h].w, e4[h].w));
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (kGuard && i >= nr) break;
      const float4 v = *(const float4*)(vb + i * a.D4 + q);
#pragma unroll
      for (int h = 0; h < ET; ++h) {
        acc[i][h] = __fadd_rn(acc[i][h], __fmul_rn(v.x, e4[h].x));
        acc[i][h] = __fadd_rn(acc[i][h], __fmul_rn(v.y, e4[h].y));
        acc[i][h] = __fadd_rn(acc[i][h], __fmul_rn(v.z, e4[h].z));
        acc[i][h] = __fadd_rn(acc[i][h], __fmul_rn(v.w, e4[h].w));
      }
    }
  }
}

// Per (chunk, row tile): each row's best entries of the chunk.  Warp lists
// (kWarpList): one list of kp slots a (row, warp over entries), at list
// blockIdx.x * (8 / wr) + (warp / wr).  Shared lists: one a (row, chunk).
template <int RW, int ET, bool kWarpList>
__global__ void __launch_bounds__(kThreads, 2)
    knn_chunk_kernel(const KnnArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int we_n = kWarps / a.wr;              // warps over entries
  const int te = 32 * ET * we_n;               // entries a tile (a power of 2)
  const int lg_te = 31 - __clz(te);
  const int rows_blk = a.wr * RW;
  const int wr = warp % a.wr, we = warp / a.wr;
  const int r0 = blockIdx.y * rows_blk;
  const int rb = r0 + wr * RW;                 // the warp's first row
  const int nr = max(0, min(RW, a.R - rb));
  const long long lo = (long long)blockIdx.x * a.chunk;
  const long long hi = min(a.N, lo + a.chunk);
  const int n_tiles = (int)((hi - lo + te - 1) / te);
  const int stage_words = te * a.DS + 4 * te;
  float* v_s = smem;                           // rows_blk x D4 query rows
  float* ring = v_s + rows_blk * a.D4;         // kStages stages
  float* bd = ring + kStages * stage_words;    // shared lists: rows_blk x m
  int* bg = (int*)(bd + rows_blk * a.m);
  int* cnt_s = bg + rows_blk * a.m;            // rows_blk each: candidates
  float* thd_s = (float*)(cnt_s + rows_blk);   //   and the threshold (shared
  int* thg_s = (int*)(thd_s + rows_blk);       //   lists only), then each
  int* q_s = thg_s + rows_blk;                 //   row's (type, ts)
  if (kWarpList) q_s = (int*)bd;               // warp lists: no list slots

  // the ring: tiles 0 .. kStages - 2 in flight first, then one a tile (a
  // group is committed even when empty, so that the count stays exact)
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile(a, ring + t * stage_words, lo + (long long)t * te,
                (int)min((long long)te, hi - lo - (long long)t * te), te,
                lg_te);
    else
      cp_async_commit();
  }
  for (int x = tid; x < rows_blk * a.D4; x += kThreads) {
    const int r = x / a.D4, d = x - r * a.D4;
    v_s[x] = r0 + r < a.R && d < a.D ? a.vecs[(long long)(r0 + r) * a.D + d]
                                      : 0.0f;
  }
  for (int r = tid; r < rows_blk; r += kThreads) {
    q_s[2 * r] = r0 + r < a.R ? a.q_vt[r0 + r] : 0;
    q_s[2 * r + 1] = r0 + r < a.R ? a.q_ts[r0 + r] : 0;
  }
  if (a.D4 > a.D) {                  // pad columns: never written by a copy
    const int pad = a.D4 - a.D;
    for (int x = tid; x < kStages * te * pad; x += kThreads) {
      const int s = x / (te * pad), y = x - s * te * pad;
      ring[s * stage_words + (y / pad) * a.DS + a.D + y % pad] = 0.0f;
    }
  }
  if (!kWarpList) {
    for (int x = tid; x < rows_blk * a.kp; x += kThreads) {
      const int r = x / a.kp;
      bd[r * a.m + x - r * a.kp] = inf();
      bg[r * a.m + x - r * a.kp] = kI32Max;
    }
    for (int r = tid; r < rows_blk; r += kThreads) {
      cnt_s[r] = 0;
      thd_s[r] = inf();
      thg_s[r] = kI32Max;
    }
  }
  float ld[RW];                      // warp lists: lane i's i-th best a row
  int lg[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    ld[i] = inf();
    lg[i] = kI32Max;
  }
  const int j0 = we * 32 * ET + lane;          // the lane's first entry
  const float* vb = v_s + wr * RW * a.D4;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile t landed; tile t - 1 is done
    const long long t0 = lo + (long long)t * te;
    const int tn = t + kStages - 1;  // into the stage tile t - 1 used
    if (tn < n_tiles)
      load_tile(a, ring + (tn % kStages) * stage_words,
                lo + (long long)tn * te,
                (int)min((long long)te, hi - lo - (long long)tn * te), te,
                lg_te);
    else
      cp_async_commit();
    const float* e_s = ring + (t % kStages) * stage_words;
    const int* m_s = (const int*)(e_s + te * a.DS);
    const int nt = (int)min((long long)te, hi - t0);
    float acc[RW][ET], ee[ET];
#pragma unroll
    for (int h = 0; h < ET; ++h) {
      ee[h] = 0.0f;
#pragma unroll
      for (int i = 0; i < RW; ++i) acc[i][h] = 0.0f;
    }
    if (nr > 0) {
      const float* eb = e_s + j0 * a.DS;
      if (nr == RW) tile_dot<RW, ET, false>(eb, vb, a, nr, acc, ee);
      else tile_dot<RW, ET, true>(eb, vb, a, nr, acc, ee);
    }
    // dist = (ee - 2 ip) + 0.0, the + 0.0 (-0.0 to +0.0) once it passes the
    // threshold (-0.0 and +0.0 compare equal); candidates: bit i * ET + h
    unsigned bits = 0;
    int gj[ET] = {};
    if (kWarpList) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i >= nr) break;
        const float thd = __shfl_sync(kFull, ld[i], a.k - 1);
        const int thg = __shfl_sync(kFull, lg[i], a.k - 1);
        const int r = wr * RW + i;
#pragma unroll
        for (int h = 0; h < ET; ++h) {
          const float d0 = __fsub_rn(ee[h], __fmul_rn(2.0f, acc[i][h]));
          if (!(d0 <= thd)) continue;         // most entries, once warm
          const int j = j0 + 32 * h, qts = q_s[2 * r + 1];
          acc[i][h] = __fadd_rn(d0, 0.0f);
          gj[h] = m_s[j];
          if (j < nt && gj[h] >= 0 && m_s[te + j] == q_s[2 * r] &&
              m_s[2 * te + j] <= qts && qts < m_s[3 * te + j] &&
              less(acc[i][h], gj[h], thd, thg))
            bits |= 1u << (i * ET + h);
        }
      }
      if (__any_sync(kFull, bits != 0)) {
#pragma unroll
        for (int i = 0; i < RW; ++i) {
#pragma unroll
          for (int h = 0; h < ET; ++h) {
            const unsigned mk =
                __ballot_sync(kFull, (bits >> (i * ET + h)) & 1u);
            if (!mk) continue;
            float thd = __shfl_sync(kFull, ld[i], a.k - 1);
            int thg = __shfl_sync(kFull, lg[i], a.k - 1);
            offer(ld[i], lg[i], thd, thg, mk, acc[i][h], gj[h], a.k);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i >= nr) break;
        const int r = wr * RW + i, qts = q_s[2 * r + 1];
#pragma unroll
        for (int h = 0; h < ET; ++h) {
          const float d0 = __fsub_rn(ee[h], __fmul_rn(2.0f, acc[i][h]));
          if (!(d0 <= thd_s[r])) continue;          // most entries, once warm
          const int j = j0 + 32 * h;
          const float d = __fadd_rn(d0, 0.0f);
          const int g = m_s[j];
          if (j < nt && g >= 0 && m_s[te + j] == q_s[2 * r] &&
              m_s[2 * te + j] <= qts && qts < m_s[3 * te + j] &&
              less(d, g, thd_s[r], thg_s[r])) {
            const int at = atomicAdd(&cnt_s[r], 1);
            bd[r * a.m + a.kp + at] = d;
            bg[r * a.m + a.kp + at] = g;
          }
        }
      }
      __syncthreads();
      for (int r = 0; r < rows_blk; ++r) {   // the rows that got candidates
        const int c = cnt_s[r];
        if (c == 0) continue;
        sort2(bd + r * a.m, bg + r * a.m, a.kp + c);
        if (tid == 0) {
          thd_s[r] = bd[r * a.m + a.kp - 1];
          thg_s[r] = bg[r * a.m + a.kp - 1];
          cnt_s[r] = 0;
        }
        __syncthreads();
      }
    }
  }
  if (kWarpList) {
    const long long list = (long long)blockIdx.x * we_n + we;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i >= nr) break;
      const long long o = ((long long)(rb + i) * a.n_lists + list) * a.kp + lane;
      if (lane < a.kp) {
        a.ld[o] = lane < a.k ? ld[i] : inf();
        a.lg[o] = lane < a.k ? lg[i] : kI32Max;
      }
    }
  } else {
    for (int x = tid; x < rows_blk * a.kp; x += kThreads) {
      const int r = x / a.kp, i = x - r * a.kp;
      if (r0 + r >= a.R) continue;
      const long long o =
          ((long long)(r0 + r) * a.n_lists + blockIdx.x) * a.kp + i;
      a.ld[o] = bd[r * a.m + i];
      a.lg[o] = bg[r * a.m + i];
    }
  }
}

// One block a row: the k best of the row's n_lists lists of kp slots
// (kp <= 32).  Warp w inserts the entries of 32-entry windows w, w + 32, ...
// (four windows' loads in flight), then warp 0 inserts the other warps'
// lists into its own and writes the first k.
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_warp_kernel(const float* __restrict__ id, const int* __restrict__ ig,
                      float* __restrict__ od, int* __restrict__ og,
                      int n_lists, int k, int kp) {
  __shared__ float sd[kMergeThreads];
  __shared__ int sg[kMergeThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = kMergeThreads / 32;
  const long long r = blockIdx.x;
  const long long base = r * n_lists * kp;
  const long long total = (long long)n_lists * kp;
  float bd = inf(), thd = inf();
  int bg = kI32Max, thg = kI32Max;
  for (long long c0 = warp; c0 * 32 < total; c0 += 4 * warps) {
    float d[4];
    int g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = (c0 + u * warps) * 32 + lane;
      d[u] = i < total ? id[base + i] : inf();
      g[u] = i < total ? ig[base + i] : kI32Max;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      offer(bd, bg, thd, thg,
            __ballot_sync(kFull, less(d[u], g[u], thd, thg)), d[u], g[u], k);
  }
  sd[threadIdx.x] = bd;
  sg[threadIdx.x] = bg;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < warps; ++w) {
    const float d = sd[w * 32 + lane];
    const int g = sg[w * 32 + lane];
    offer(bd, bg, thd, thg,
          __ballot_sync(kFull, lane < k && less(d, g, thd, thg)), d, g, k);
  }
  if (lane < k) {
    od[r * k + lane] = bd;
    og[r * k + lane] = bg;
  }
}

// Per (group, row): the sorted union of `group` consecutive kp-lists of the
// row, first k_out written to od/og at [row][group][0..k_out).
__global__ void knn_merge_kernel(const float* __restrict__ id,
                                 const int* __restrict__ ig,
                                 float* __restrict__ od, int* __restrict__ og,
                                 int n_in, int kp, int group, int n_out,
                                 int k_out) {
  extern __shared__ float sm[];
  float* d = sm;
  int* g = (int*)(sm + group * kp);
  const int r = blockIdx.y, l0 = blockIdx.x * group;
  const int nl = max(0, min(group, n_in - l0));
  const int n = nl * kp;
  const long long base = ((long long)r * n_in + l0) * kp;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    d[x] = id[base + x];
    g[x] = ig[base + x];
  }
  __syncthreads();
  sort2(d, g, n);
  const long long ob = ((long long)r * n_out + blockIdx.x) * k_out;
  for (int x = threadIdx.x; x < k_out; x += blockDim.x) {
    od[ob + x] = x < n ? d[x] : inf();
    og[ob + x] = x < n ? g[x] : kI32Max;
  }
}

int pow2ceil(long long n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The chunk kernel's shared memory (the wrapper's plan mirrors it).
long long chunk_smem(int D4, int DS, int wr, int rw, int et, bool warp_list,
                     int m) {
  const long long te = 32LL * et * (kWarps / wr), rows = (long long)wr * rw;
  return 4 * rows * D4 + kStages * te * (4LL * DS + 16) +
         (warp_list ? 0 : rows * (8LL * m + 12)) + 8 * rows;
}

template <int RW, int ET, bool kWarpList>
cudaError_t launch_chunks(const KnnArgs& a, int n_chunks, int smem,
                          cudaStream_t st) {
  auto* fn = knn_chunk_kernel<RW, ET, kWarpList>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows_blk = a.wr * RW;
  dim3 grid(n_chunks, (a.R + rows_blk - 1) / rows_blk);
  fn<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out_d/out_g: (R, k).  k <= 32: ws0 holds the R x (n_chunks * 8 / wr) warp
// lists of kp slots (ws1 unused).  k > 32: ws0 holds R x n_chunks lists of
// kp, ws1 R x ceil(n_chunks / group) lists (floats in *_d, ints in *_g),
// merged in passes of `group` lists until one is left.  smem is the chunk
// kernel's shared memory as the wrapper's plan computes it; a different
// count here returns cudaErrorInvalidValue.
extern "C" int knn_topk(const void* vecs, const void* emb, const void* gid,
                        const void* vtype, const void* create,
                        const void* del, const void* q_vt, const void* q_ts,
                        void* out_d, void* out_g, void* ws_d0, void* ws_g0,
                        void* ws_d1, void* ws_g1, int R, long long N, int D,
                        int k, int kp, int wr, long long chunk, int n_chunks,
                        int group, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool warp_list = k <= kWarpK;
  if (wr < 1 || wr > kWarps || (kWarps % wr) != 0)
    return (int)cudaErrorInvalidValue;
  const int we_n = kWarps / wr;
  const int rw = warp_list ? 8 : 1;
  const int et = warp_list && we_n <= 4 ? 4 / we_n : 1;
  KnnArgs a;
  a.vecs = (const float*)vecs;
  a.emb = (const float*)emb;
  a.meta[0] = (const int*)gid;
  a.meta[1] = (const int*)vtype;
  a.meta[2] = (const int*)create;
  a.meta[3] = (const int*)del;
  a.q_vt = (const int*)q_vt;
  a.q_ts = (const int*)q_ts;
  a.ld = (float*)ws_d0;
  a.lg = (int*)ws_g0;
  a.N = N;
  a.chunk = chunk;
  a.R = R;
  a.D = D;
  a.D4 = (D + 3) & ~3;
  a.DS = 4 * ((a.D4 / 4) | 1);
  a.k = k;
  a.kp = kp;
  a.wr = wr;
  a.m = warp_list ? 0 : pow2ceil(kp + 32LL * et * we_n);
  a.n_lists = warp_list ? n_chunks * we_n : n_chunks;
  a.vec16 = D % 4 == 0 && ((unsigned long long)emb & 15) == 0;
  if (chunk_smem(a.D4, a.DS, wr, rw, et, warp_list, a.m) != smem)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaSuccess;
  if (n_chunks > 0) {
    if (!warp_list) err = launch_chunks<1, 1, false>(a, n_chunks, smem, st);
    else if (et == 4) err = launch_chunks<8, 4, true>(a, n_chunks, smem, st);
    else if (et == 2) err = launch_chunks<8, 2, true>(a, n_chunks, smem, st);
    else err = launch_chunks<8, 1, true>(a, n_chunks, smem, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (warp_list) {
    knn_merge_warp_kernel<<<R, kMergeThreads, 0, st>>>(
        (const float*)ws_d0, (const int*)ws_g0, (float*)out_d, (int*)out_g,
        a.n_lists, k, kp);
    return (int)cudaGetLastError();
  }
  const int smem_b = group * kp * 8;
  err = cudaFuncSetAttribute((const void*)knn_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return (int)err;
  float* src_d = (float*)ws_d0;
  int* src_g = (int*)ws_g0;
  float* dst_d = (float*)ws_d1;
  int* dst_g = (int*)ws_g1;
  int n_in = n_chunks;
  for (;;) {
    int n_out = (n_in + group - 1) / group;
    if (n_out < 1) n_out = 1;
    const bool last = n_out == 1;
    dim3 grid(n_out, R);
    knn_merge_kernel<<<grid, 1024, smem_b, st>>>(
        src_d, src_g, last ? (float*)out_d : dst_d,
        last ? (int*)out_g : dst_g, n_in, kp, group, n_out, last ? k : kp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (last) break;
    n_in = n_out;
    float* td = src_d; src_d = dst_d; dst_d = td;
    int* tg = src_g; src_g = dst_g; dst_g = tg;
  }
  return (int)cudaSuccess;
}
