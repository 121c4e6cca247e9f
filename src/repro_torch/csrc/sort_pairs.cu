// Lexicographic sort of flat (k1, k2) int32 pairs for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/dedup_compact/kernel.py::sort_pairs (the Pallas
// TPU kernel behind backend.sort_pairs, which the shared-frontier planner
// calls once per hop in _dedup_pairs and once per star merge in _merge_flat).
// It sorts W pairs ascending by (k1, k2) as signed int32, which is
// jax.lax.sort((k1, k2), num_keys=2).  A pair is the whole record, so every
// correct sort gives the same bits and stability does not matter.
//
// What bounds it: the TPU kernel sorts the whole width in one VMEM block.  At
// the a1-kg caps the shared pool's candidates are 131,072-196,608 pairs a
// hop; a Hopper block holds at most ~28 K 8-byte keys in shared memory.
// Design: each pair is packed into one 64-bit key,
//   (u64)(k1 ^ 0x80000000) << 32 | (u32)(k2 ^ 0x80000000),
// whose unsigned order is the signed lexicographic order (and the ghost pair
// (INT32_MAX, INT32_MAX) packs to the largest key).  A bitonic network with
// ascending comparators only (each merge starts by comparing i with its
// mirror i ^ (k-1)) sorts a virtual power-of-two width whose slots at or past
// W hold the largest key: a comparator whose upper slot is >= W never moves
// anything, so those slots are never stored.  Chunks of kChunk keys are
// sorted in shared memory; each later merge runs its strides >= kChunk as one
// global compare-exchange launch per stride and finishes the strides below
// kChunk in shared memory, where the last merge also unpacks.  The passes over
// the 8-byte buffer stay in the 50 MB L2 at these widths; the network is bound
// by its launches and block barriers, not by device-memory bytes.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kChunk = 8192;            // keys a block sorts in shared memory
constexpr int kThreads = 1024;

__device__ __forceinline__ u64 pack(int a, int b) {
  return ((u64)((unsigned)a ^ 0x80000000u) << 32) |
         (u64)((unsigned)b ^ 0x80000000u);
}

__device__ __forceinline__ void unpack(u64 v, int* a, int* b) {
  *a = (int)((unsigned)(v >> 32) ^ 0x80000000u);
  *b = (int)((unsigned)(v & 0xffffffffu) ^ 0x80000000u);
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// Comparator c of step (k, j) over a power-of-two width: its lower slot i and
// upper slot p > i (the mirror for the first step of a merge, else i + j).
__device__ __forceinline__ void slots(int c, int k, int j, bool mirror, int* i,
                                      int* p) {
  const int lj = ilog2(j);
  *i = ((c >> lj) << (lj + 1)) | (c & (j - 1));
  *p = mirror ? (*i ^ (k - 1)) : (*i + j);
}

// One step over the n stored slots of s (virtual width w2); block barrier.
__device__ void step_shared(u64* s, int n, int w2, int k, int j, bool mirror) {
  const int half = w2 >> 1;
  const int n_cmp = half < n ? half : n;  // comparator c has lower slot >= c
  for (int c = threadIdx.x; c < n_cmp; c += blockDim.x) {
    int i, p;
    slots(c, k, j, mirror, &i, &p);
    if (p < n) {
      const u64 a = s[i], b = s[p];
      if (a > b) { s[i] = b; s[p] = a; }
    }
  }
  __syncthreads();
}

__device__ void store_chunk(const u64* s, int n, u64* buf, int* o1, int* o2,
                            long long base) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (o1) {
      int a, b;
      unpack(s[i], &a, &b);
      o1[base + i] = a;
      o2[base + i] = b;
    } else {
      buf[base + i] = s[i];
    }
  }
}

// Full network over each chunk of `width` keys (packed from the inputs).  With
// o1 set (a single chunk covers W) the result is unpacked to the outputs,
// else it goes to buf.
__global__ void chunk_sort_kernel(const int* __restrict__ k1,
                                  const int* __restrict__ k2, u64* buf,
                                  int* o1, int* o2, int w, int width) {
  extern __shared__ u64 s[];
  const long long base = (long long)blockIdx.x * width;
  const int n = (int)min((long long)width, (long long)w - base);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = pack(k1[base + i], k2[base + i]);
  __syncthreads();
  for (int k = 2; k <= width; k <<= 1)
    for (int j = k >> 1; j >= 1; j >>= 1)
      step_shared(s, n, width, k, j, j == (k >> 1));
  store_chunk(s, n, buf, o1, o2, base);
}

// One global step (k, j) with j >= kChunk: one thread per comparator.
__global__ void global_step_kernel(u64* buf, int w, int k, int j) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  int i, p;
  slots(c, k, j, j == (k >> 1), &i, &p);
  if (p < w) {
    const u64 a = buf[i], b = buf[p];
    if (a > b) { buf[i] = b; buf[p] = a; }
  }
}

// The strides kChunk/2 ... 1 of a merge whose k exceeds kChunk (never the
// mirror step), in shared memory; the last merge unpacks to the outputs.
__global__ void chunk_merge_kernel(u64* buf, int* o1, int* o2, int w) {
  extern __shared__ u64 s[];
  const long long base = (long long)blockIdx.x * kChunk;
  const int n = (int)min((long long)kChunk, (long long)w - base);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = buf[base + i];
  __syncthreads();
  for (int j = kChunk >> 1; j >= 1; j >>= 1)
    step_shared(s, n, kChunk, 2 * kChunk, j, false);
  store_chunk(s, n, buf, o1, o2, base);
}

int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// Sort w pairs; buf is scratch of w 8-byte keys (unused when w <= kChunk).
extern "C" int sort_pairs(const void* k1, const void* k2, void* o1, void* o2,
                          void* buf, int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int bytes = kChunk * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)chunk_sort_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute((const void*)chunk_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  if (w <= 0) return (int)cudaGetLastError();
  const int w2 = pow2ceil(w);
  const int *a = (const int*)k1, *b = (const int*)k2;
  int *oa = (int*)o1, *ob = (int*)o2;
  u64* kb = (u64*)buf;
  if (w2 <= kChunk) {
    const int threads = w2 / 2 < 32 ? 32 : (w2 / 2 > kThreads ? kThreads
                                                              : w2 / 2);
    chunk_sort_kernel<<<1, threads, w2 * (int)sizeof(u64), st>>>(a, b, kb, oa,
                                                                 ob, w, w2);
    return (int)cudaGetLastError();
  }
  const int n_chunks = (w + kChunk - 1) / kChunk;
  chunk_sort_kernel<<<n_chunks, kThreads, bytes, st>>>(a, b, kb, nullptr,
                                                       nullptr, w, kChunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_cmp = w2 / 2 < w ? w2 / 2 : w;
  for (int k = 2 * kChunk; k <= w2; k <<= 1) {
    for (int j = k >> 1; j >= kChunk; j >>= 1) {
      global_step_kernel<<<(n_cmp + 255) / 256, 256, 0, st>>>(kb, w, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    const bool last = k == w2;
    chunk_merge_kernel<<<n_chunks, kThreads, bytes, st>>>(
        kb, last ? oa : nullptr, last ? ob : nullptr, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
