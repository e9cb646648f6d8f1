// K2: the greedy-parse chain walk of the device LZ matcher.
//
// Replaces brotli_tpu/ops/chain_pallas.py::chain_select (its kernel
// _chain_kernel). From `start`, walk pos -> pos + skip[pos] while
// pos < n and set sel[pos] = 1 at every visited pos with skip[pos] > 1;
// every other entry is 0. skip is int32 (n,) with 1 <= skip <= CAP = 16
// (the matcher's parallel match-length cap); a value outside that range
// sets *err and is walked as 1, so the walk always ends.
//
// The TPU kernel streamed skip through SMEM in order and carried the
// position from one grid step to the next: one scalar walker. On the
// card a single thread chasing the chain through device memory would
// wait on millions of dependent loads. Since skip <= 16, a walk enters
// each chunk of L positions at one of 16 offsets (or at start's own
// offset), so the walk splits into three passes:
//   A. one block per chunk stages the chunk's skips in shared memory as
//      bytes; 16 lanes walk it from entry offsets 0..15 and record where
//      each leaves it (exit offset into the next chunk, < 16); the chunk
//      that holds `start` also walks from start's offset;
//   B. one thread chains the entries, entry[c+1] = exit[c][entry[c]],
//      from the start chunk over the exit table staged in shared
//      memory; chunks before it are not visited (-1);
//   C. one block per chunk stages the skips again, one thread walks from
//      the chunk's entry and marks a shared byte map, and all threads
//      store the chunk's int32 sel, zeros included, coalesced.
//
// Bound: bytes (n int32 read, n int32 written: 67 MB at n = 8 Mi,
// 0.020 ms at 3.35 TB/s) and, in this design, the dependent chains:
// L steps in A and in C, n / L steps in B, each one shared-memory load
// (~30 cycles): about 0.16 ms at n = 8 Mi and the top SM clock. Fusing
// B into C with a decoupled look-back, or composing the 16-entry exit
// maps as a parallel scan, would cut that; not done here.

#include <cuda_runtime.h>

namespace {

constexpr int L = 4096;        // positions per chunk
constexpr int CAP = 16;        // largest skip
constexpr int THREADS = 256;
constexpr int MAX_CHUNKS = 3072;  // exit table of pass B: 48 KB of shared

__device__ __forceinline__ bool stage(const int* __restrict__ skip,
                                      long long base, unsigned char* s) {
  bool bad = false;
  for (int k = threadIdx.x; k < L; k += THREADS) {
    int v = skip[base + k];
    if (v < 1 || v > CAP) {
      bad = true;
      v = 1;
    }
    s[k] = (unsigned char)v;
  }
  return bad;
}

__device__ __forceinline__ int walk_out(const unsigned char* s, int p) {
  while (p < L) p += s[p];
  return p - L;
}

__global__ void __launch_bounds__(THREADS)
chain_exits_kernel(const int* __restrict__ skip,
                   unsigned char* __restrict__ exits,
                   int* __restrict__ start_exit, int* __restrict__ err,
                   long long start) {
  __shared__ unsigned char s[L];
  const long long c = blockIdx.x;
  if (stage(skip, c * L, s)) atomicOr(err, 1);
  __syncthreads();
  if (threadIdx.x < CAP) {
    exits[c * CAP + threadIdx.x] =
        (unsigned char)walk_out(s, threadIdx.x);
  } else if (threadIdx.x == CAP && start / L == c) {
    *start_exit = walk_out(s, (int)(start - c * L));
  }
}

__global__ void chain_entries_kernel(const unsigned char* __restrict__ exits,
                                     const int* __restrict__ start_exit,
                                     int* __restrict__ entry, int nchunks,
                                     long long start) {
  extern __shared__ unsigned char ex[];
  for (int k = threadIdx.x; k < nchunks * CAP; k += blockDim.x)
    ex[k] = exits[k];
  __syncthreads();
  const long long sc = start / L;
  for (int c = threadIdx.x; c < nchunks && c <= sc; c += blockDim.x)
    entry[c] = c < sc ? -1 : (int)(start - sc * L);
  if (threadIdx.x != 0 || sc >= nchunks) return;
  int e = *start_exit;
  for (int c = (int)sc + 1; c < nchunks; ++c) {
    entry[c] = e;
    e = ex[c * CAP + e];
  }
}

__global__ void __launch_bounds__(THREADS)
chain_mark_kernel(const int* __restrict__ skip,
                  const int* __restrict__ entry, int* __restrict__ sel) {
  __shared__ unsigned char s[L];
  __shared__ unsigned char mark[L];
  const long long c = blockIdx.x;
  stage(skip, c * L, s);
  for (int k = threadIdx.x; k < L; k += THREADS) mark[k] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int p = entry[c];
    if (p >= 0) {
      while (p < L) {
        const int sk = s[p];
        if (sk > 1) mark[p] = 1;
        p += sk;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < L; k += THREADS) sel[c * L + k] = mark[k];
}

}  // namespace

// scratch: exits (n / L * 16 bytes), entry (n / L ints), start_exit and
// err (one int each; err must be zero on entry). Returns
// cudaGetLastError() after the three launches, -1 for bad arguments.
extern "C" int btt_chain_select(const int* skip, int* sel,
                                unsigned char* exits, int* entry,
                                int* start_exit, int* err, long long n,
                                long long start, cudaStream_t stream) {
  if (n <= 0 || n % L || n / L > MAX_CHUNKS || start < 0) return -1;
  const int nchunks = (int)(n / L);
  chain_exits_kernel<<<nchunks, THREADS, 0, stream>>>(skip, exits,
                                                      start_exit, err,
                                                      start);
  chain_entries_kernel<<<1, THREADS, nchunks * CAP, stream>>>(
      exits, start_exit, entry, nchunks, start);
  chain_mark_kernel<<<nchunks, THREADS, 0, stream>>>(skip, entry, sel);
  return (int)cudaGetLastError();
}
