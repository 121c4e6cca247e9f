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
// version uses the same order, so the two agree bit for bit.
//
// What bounds it: operations.  At one machine's share the index holds 4 M
// entries of D = 32; 64 query rows need 2*R*N*D = 17 G multiplies and adds,
// ~0.26 ms at the float32 rate (twice the instructions, since nothing is
// fused), against ~0.18 ms to read the index once.  The TPU kernel keeps the
// whole index in VMEM (N ~ 8 K); here the grid is (entry chunk x row tile):
// a block stages 64-entry tiles of its chunk in shared memory once for up to
// 64 rows and computes a register tile of 8 rows x 2 entries per thread.  Each
// row keeps a running top-KP (KP = pow2ceil(k)) in shared memory; an entry is
// pushed only if it beats the row's current KP-th best, and the row's warp
// then merges its few candidates with a two-key (dist, gid) bitonic network.
// A second launch merges the per-chunk lists of each row and writes the
// first k.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;               // entries per tile: two per lane
constexpr int kRowsPerWarp = 8;         // a block holds at most 64 rows
constexpr int kI32Max = 0x7fffffff;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool less(float da, int ga, float db, int gb) {
  return da < db || (da == db && ga < gb);
}

// Ascending-only two-key network over the n stored slots of (d, g) (virtual
// width pow2ceil(n), slots past n are (+inf, INT32_MAX) and never touched),
// run by one warp (kBlock false) or the whole block.
template <bool kBlock>
__device__ void sort2(float* d, int* g, int n) {
  int w2 = 1;
  while (w2 < n) w2 <<= 1;
  const int half = w2 >> 1, n_cmp = half < n ? half : n;
  const int t0 = kBlock ? threadIdx.x : (threadIdx.x & 31);
  const int nt = kBlock ? blockDim.x : 32;
  for (int k = 2; k <= w2; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      const int lj = 31 - __clz(j);
      const bool mirror = j == (k >> 1);
      for (int c = t0; c < n_cmp; c += nt) {
        const int i = ((c >> lj) << (lj + 1)) | (c & (j - 1));
        const int p = mirror ? (i ^ (k - 1)) : (i + j);
        if (p < n && less(d[p], g[p], d[i], g[i])) {
          const float td = d[i];
          const int tg = g[i];
          d[i] = d[p]; g[i] = g[p];
          d[p] = td; g[p] = tg;
        }
      }
      if (kBlock) __syncthreads(); else __syncwarp();
    }
  }
}

// Per (chunk, row tile): the chunk's top-kp of every row, sorted, written to
// cd/cg at [row][chunk][0..kp).  m = pow2ceil(kp + kTile) slots a row.
__global__ void knn_chunk_kernel(
    const float* __restrict__ vecs, const float* __restrict__ emb,
    const int* __restrict__ gid, const int* __restrict__ vtype,
    const int* __restrict__ create, const int* __restrict__ del,
    const int* __restrict__ q_vt, const int* __restrict__ q_ts,
    float* __restrict__ cd, int* __restrict__ cg, int R, long long N, int D,
    int kp, int m, int rt, long long chunk, int n_chunks) {
  extern __shared__ float smem[];
  const int es = D | 1;                  // odd row stride: no bank conflicts
  float* v_s = smem;                     // rt x D query rows
  float* e_s = v_s + rt * D;             // kTile x es entry tile
  float* ee_s = e_s + kTile * es;        // kTile
  int* g_s = (int*)(ee_s + kTile);       // kTile each: gid, vtype, create,
  int* vt_s = g_s + kTile;               //   delete of the tile's entries
  int* cr_s = vt_s + kTile;
  int* dl_s = cr_s + kTile;
  int* qvt_s = dl_s + kTile;             // rt each: row type, row ts,
  int* qts_s = qvt_s + rt;               //   candidate count, and the
  int* cnt_s = qts_s + rt;               //   row's kp-th best (threshold)
  float* thd_s = (float*)(cnt_s + rt);
  int* thg_s = (int*)(thd_s + rt);
  float* bd = (float*)(thg_s + rt);      // rt x m: best kp, then candidates
  int* bg = (int*)(bd + rt * m);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * rt;
  const int rows = min(rt, R - r0);
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(N, lo + chunk);
  for (int x = tid; x < rt * D; x += kThreads)
    v_s[x] = x / D < rows ? vecs[(long long)r0 * D + x] : 0.0f;
  for (int r = tid; r < rt; r += kThreads) {
    qvt_s[r] = r < rows ? q_vt[r0 + r] : 0;
    qts_s[r] = r < rows ? q_ts[r0 + r] : 0;
    cnt_s[r] = 0;
    thd_s[r] = inf();
    thg_s[r] = kI32Max;
  }
  for (int x = tid; x < rt * kp; x += kThreads) {
    bd[(x / kp) * m + x % kp] = inf();
    bg[(x / kp) * m + x % kp] = kI32Max;
  }
  __syncthreads();

  const int rpw = (rt + kWarps - 1) / kWarps;  // row of (warp, i): warp+8*i
  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    const int nt = (int)min((long long)kTile, hi - t0);
    for (int x = tid; x < nt * D; x += kThreads)
      e_s[(x / D) * es + x % D] = emb[t0 * D + x];
    if (tid < nt) {
      g_s[tid] = gid[t0 + tid];
      vt_s[tid] = vtype[t0 + tid];
      cr_s[tid] = create[t0 + tid];
      dl_s[tid] = del[t0 + tid];
    }
    __syncthreads();
    if (tid < nt) {
      float ee = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float e = e_s[tid * es + d];
        ee = __fadd_rn(ee, __fmul_rn(e, e));
      }
      ee_s[tid] = ee;
    }
    __syncthreads();

    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) acc[i][0] = acc[i][1] = 0.0f;
    const float* e0 = e_s + lane * es;
    const float* e1 = e_s + (lane + 32) * es;
    for (int d = 0; d < D; ++d) {
      const float x0 = e0[d], x1 = e1[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (i < rpw && r < rt) {
          const float v = v_s[r * D + d];
          acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(v, x0));
          acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(v, x1));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (i >= rpw || r >= rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        if (j >= nt) continue;
        const int g = g_s[j], ts = qts_s[r];
        if (g < 0 || vt_s[j] != qvt_s[r] || cr_s[j] > ts || ts >= dl_s[j])
          continue;
        const float dist = __fadd_rn(
            __fsub_rn(ee_s[j], __fmul_rn(2.0f, acc[i][h])), 0.0f);
        if (less(dist, g, thd_s[r], thg_s[r])) {
          const int at = atomicAdd(&cnt_s[r], 1);
          bd[r * m + kp + at] = dist;
          bg[r * m + kp + at] = g;
        }
      }
    }
    __syncthreads();
    // each warp merges the candidates of its own rows into their best kp
    for (int i = 0; i < rpw; ++i) {
      const int r = warp + kWarps * i;
      if (r >= rows) continue;
      const int c = cnt_s[r];
      if (c == 0) continue;
      sort2<false>(bd + r * m, bg + r * m, kp + c);
      if (lane == 0) {
        thd_s[r] = bd[r * m + kp - 1];
        thg_s[r] = bg[r * m + kp - 1];
        cnt_s[r] = 0;
      }
    }
    __syncthreads();
  }
  for (int x = tid; x < rows * kp; x += kThreads) {
    const int r = x / kp, i = x % kp;
    const long long o = ((long long)(r0 + r) * n_chunks + blockIdx.x) * kp + i;
    cd[o] = bd[r * m + i];
    cg[o] = bg[r * m + i];
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
  sort2<true>(d, g, n);
  const long long ob = ((long long)r * n_out + blockIdx.x) * k_out;
  for (int x = threadIdx.x; x < k_out; x += blockDim.x) {
    od[ob + x] = x < n ? d[x] : inf();
    og[ob + x] = x < n ? g[x] : kI32Max;
  }
}

int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// out_d/out_g: (R, k).  ws0: R*n_chunks*kp slots, ws1: R*ceil(n_chunks/group)
// *kp slots (floats in *_d, ints in *_g): the per-chunk lists, merged in
// passes of `group` lists until one is left.  smem_a is the chunk kernel's
// shared memory (the wrapper's plan computes it from D, kp and rt).
extern "C" int knn_topk(const void* vecs, const void* emb, const void* gid,
                        const void* vtype, const void* create,
                        const void* del, const void* q_vt, const void* q_ts,
                        void* out_d, void* out_g, void* ws_d0, void* ws_g0,
                        void* ws_d1, void* ws_g1, int R, long long N, int D,
                        int k, int kp, int rt, long long chunk, int n_chunks,
                        int group, int smem_a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem_b = group * kp * 8;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)knn_chunk_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)knn_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_b);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return (int)cudaGetLastError();
  float* src_d = (float*)ws_d0;
  int* src_g = (int*)ws_g0;
  float* dst_d = (float*)ws_d1;
  int* dst_g = (int*)ws_g1;
  if (n_chunks > 0) {
    const int m = pow2ceil(kp + kTile);
    dim3 grid(n_chunks, (R + rt - 1) / rt);
    knn_chunk_kernel<<<grid, kThreads, smem_a, st>>>(
        (const float*)vecs, (const float*)emb, (const int*)gid,
        (const int*)vtype, (const int*)create, (const int*)del,
        (const int*)q_vt, (const int*)q_ts, src_d, src_g, R, N, D, kp, m, rt,
        chunk, n_chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
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
