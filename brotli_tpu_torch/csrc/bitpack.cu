// K6: the device serializer's bit packer.
//
// Replaces brotli_tpu/ops/bitpack.py::pack_kernel (with its packer
// _pack_bits_math). Each of n fields is an int32 (value, marker) pair
// from the plan: marker -1 is a tree symbol (a command symbol, or a
// distance symbol at value + 4096), -2 a literal byte, >= 0 that many
// raw extra bits of value. A field resolves to (code, nb) through the
// three code tables (tree and literal fields) or as (value, marker)
// itself; its bits go to bit offset bit0 + (the nb of the fields before
// it), all in uint32 as in the JAX code, and are added into the u32 words
// idx = off >> 5 and idx + 1 (clipped to cap_words - 1). Fields are
// bit-disjoint, so add is or; add is kept (atomicAdd) so that a payload
// that overflows cap_words gives the JAX code's words bit for bit.
//
// The TPU version was an XLA array program: gathers, a cumsum and two
// scatter-adds over the whole field array. Here, three launches:
//   1. tile sums: a CTA of 256 threads per tile of 4,096 fields stages
//      the 2,048-entry code table (8 KB) in shared memory, resolves its
//      fields (coalesced: field base + k * 256 + thread) and writes the
//      tile's sum of nb (64-bit);
//   2. one CTA of 1,024 threads scans the tile sums into each tile's
//      start bit (bit0 included) and writes the total, mod 2**32;
//   3. pack: each tile resolves its fields again, takes 16 block-wide
//      exclusive scans of nb (one per k, warp shuffles plus the warps'
//      sums in shared memory) on top of its start bit, and adds each
//      field's low and spill words with atomicAdd.
//
// Bound: bytes. The fields are read once (8 B each: 75.5 MB for the
// 9,437,224 fields of a 4 MiB metablock) and the words written once
// (8.4 MB): 0.025 ms at 3.35 TB/s. This design reads the fields twice
// and adds into the words with atomics, several fields to a word.
//
// The words are zeroed by cudaMemsetAsync in btt_bitpack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                  // fields per thread a tile
constexpr int TILE = THREADS * ITEMS;      // 4,096 fields per CTA
constexpr int SCAN_THREADS = 1024;
// code table layout: lit code, lit len, cmd code, cmd len, dist code,
// dist len
constexpr int LIT = 256, CMD = 704, DIST = 64;
constexpr int LIT_CODE = 0, LIT_LEN = LIT_CODE + LIT;
constexpr int CMD_CODE = LIT_LEN + LIT, CMD_LEN = CMD_CODE + CMD;
constexpr int DIST_CODE = CMD_LEN + CMD, DIST_LEN = DIST_CODE + DIST;
constexpr int NTAB = DIST_LEN + DIST;      // 2,048 entries
constexpr int DIST_SYM = 4096;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (code, nb) of one field, as pack_kernel's nested wheres
__device__ __forceinline__ void resolve(int val, int mk, const int* tab,
                                        uint32_t& code, uint32_t& nb) {
  if (mk == -2) {
    int v = clampi(val, 0, LIT - 1);
    code = (uint32_t)tab[LIT_CODE + v];
    nb = (uint32_t)tab[LIT_LEN + v];
  } else if (mk == -1 && val >= DIST_SYM) {
    int v = clampi(val - DIST_SYM, 0, DIST - 1);
    code = (uint32_t)tab[DIST_CODE + v];
    nb = (uint32_t)tab[DIST_LEN + v];
  } else if (mk == -1) {
    int v = clampi(val, 0, CMD - 1);
    code = (uint32_t)tab[CMD_CODE + v];
    nb = (uint32_t)tab[CMD_LEN + v];
  } else {
    code = (uint32_t)val;
    nb = mk > 0 ? (uint32_t)mk : 0u;
  }
}

__device__ __forceinline__ void load_table(const int* tab, int* s_tab) {
  for (int i = threadIdx.x; i < NTAB; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
}

// Block-wide exclusive scan of x over NT threads; *total gets the sum.
// Ends with a barrier, so s_warp may be reused by the next call.
template <int NT>
__device__ __forceinline__ unsigned long long block_exclusive_scan(
    unsigned long long x, unsigned long long* s_warp,
    unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned long long y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    unsigned long long s = s_warp[w];
    before += w < warp ? s : 0ull;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

__global__ void __launch_bounds__(THREADS)
tile_sums_kernel(const int* __restrict__ vals, const int* __restrict__ mk,
                 const int* __restrict__ tab, long long n,
                 unsigned long long* __restrict__ sums) {
  __shared__ int s_tab[NTAB];
  __shared__ unsigned long long s_warp[THREADS / 32];
  load_table(tab, s_tab);
  const long long base = (long long)blockIdx.x * TILE;
  unsigned long long acc = 0;
#pragma unroll 4
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    if (i < n) {
      uint32_t code, nb;
      resolve(vals[i], mk[i], s_tab, code, nb);
      acc += nb;
    }
  }
  unsigned long long total;
  block_exclusive_scan<THREADS>(acc, s_warp, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// tile sums -> each tile's start bit (bit0 included), in place; the
// total bit count mod 2**32 into *total
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles_kernel(unsigned long long* __restrict__ sums, int ntiles,
                  unsigned bit0, unsigned long long* __restrict__ total) {
  __shared__ unsigned long long s_warp[SCAN_THREADS / 32];
  unsigned long long run = bit0;
  for (int base = 0; base < ntiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const unsigned long long x = i < ntiles ? sums[i] : 0ull;
    unsigned long long all;
    const unsigned long long ex =
        block_exclusive_scan<SCAN_THREADS>(x, s_warp, &all);
    if (i < ntiles) sums[i] = run + ex;
    run += all;
  }
  if (threadIdx.x == 0) *total = run & 0xffffffffull;
}

__global__ void __launch_bounds__(THREADS)
pack_kernel(const int* __restrict__ vals, const int* __restrict__ mk,
            const int* __restrict__ tab, long long n,
            const unsigned long long* __restrict__ starts,
            unsigned* __restrict__ words, long long cap_words) {
  __shared__ int s_tab[NTAB];
  __shared__ unsigned long long s_warp[THREADS / 32];
  load_table(tab, s_tab);
  const long long base = (long long)blockIdx.x * TILE;
  unsigned long long run = starts[blockIdx.x];
  const long long last = cap_words - 1;
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    uint32_t code = 0, nb = 0;
    if (i < n) resolve(vals[i], mk[i], s_tab, code, nb);
    unsigned long long all;
    const unsigned long long ex =
        block_exclusive_scan<THREADS>(nb, s_warp, &all);
    if (nb > 0) {
      const uint32_t off = (uint32_t)(run + ex);  // uint32, as in JAX
      const uint32_t v = code & (nb >= 32 ? 0xffffffffu : (1u << nb) - 1u);
      const uint32_t sh = off & 31u;
      const long long idx = off >> 5;
      const unsigned long long t = (unsigned long long)v << sh;
      const uint32_t lo = (uint32_t)t, hi = (uint32_t)(t >> 32);
      if (lo) atomicAdd(&words[idx < last ? idx : last], lo);
      if (hi) atomicAdd(&words[idx + 1 < last ? idx + 1 : last], hi);
    }
    run += all;
  }
}

}  // namespace

// scratch: (ceil(n / 4096) + 1) 64-bit words: the tiles' start bits,
// then the total bit count.
extern "C" int btt_bitpack(const int* vals, const int* markers,
                           const int* tab, long long n, int bit0,
                           int* words, long long cap_words, void* scratch,
                           cudaStream_t stream) {
  if (n < 0 || n >= (1ll << 31) || cap_words <= 0 || bit0 < 0)
    return -1;
  const int ntiles = (int)((n + TILE - 1) / TILE);
  unsigned long long* sums = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(words, 0, cap_words * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (ntiles > 0) {
    tile_sums_kernel<<<ntiles, THREADS, 0, stream>>>(vals, markers, tab, n,
                                                     sums);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  scan_tiles_kernel<<<1, SCAN_THREADS, 0, stream>>>(sums, ntiles,
                                                    (unsigned)bit0,
                                                    sums + ntiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (ntiles > 0) {
    pack_kernel<<<ntiles, THREADS, 0, stream>>>(
        vals, markers, tab, n, sums, reinterpret_cast<unsigned*>(words),
        cap_words);
  }
  return (int)cudaGetLastError();
}
