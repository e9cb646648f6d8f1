// K6: the device serializer's bit packer.
//
// Replaces brotli_tpu/ops/bitpack.py::pack_kernel (with its packer
// _pack_bits_math). Each of n fields is an int32 (value, marker) pair
// from the plan: marker -1 is a tree symbol (a command symbol, or a
// distance symbol at value + 4096), -2 a literal byte, >= 0 that many
// raw extra bits of value. A field resolves to (code, nb) through the
// three code tables (tree and literal fields) or as (value, marker)
// itself; its bits (code masked to nb bits, all ones for nb >= 32) go
// to bit offset bit0 + (the nb of the fields before it), all in uint32
// as in the JAX code, and are added into the u32 words idx = off >> 5
// and idx + 1 (clipped to cap_words - 1). Fields are bit-disjoint, so
// add is or wherever nothing is clipped or wraps.
//
// The TPU version was an XLA array program: gathers, a cumsum and two
// scatter-adds over the whole field array. Here, one launch after a
// memset of the words: a CTA of 256 threads per tile of 4,096 fields,
// the tile index from a ticket, so every tile a look-back waits on is
// running or done.
//   1. stage the 2,048-entry code table (8 KB) in shared memory; each
//      thread reads its 16 consecutive fields once (four 16-byte loads
//      per array) and resolves them in registers;
//   2. one block scan of the threads' bit sums gives the tile's
//      aggregate, published at once, and each thread's start;
//   3. decoupled look-back (Merrill & Garland, 2016; as K2 does it) on
//      descriptors of one 64-bit word: status in bits 62-63, and the
//      bit count as (sum mod 2^32, bit 32 = "reached 2^32"), which is
//      all the packer needs and combines associatively. The tile then
//      publishes its inclusive prefix;
//   4. fast path: the tile's bits land in [S, S + A) with S its start
//      bit. Each field ORs its one or two words into a shared buffer
//      of 4,097 words (a span of 4,096 * 32 bits starting anywhere in
//      a word); interior words go out with plain coalesced stores, the
//      first and last (shared with the neighbours) with atomicAdd;
//   5. slow path, per tile, with the first version's per-field global
//      atomicAdd and clipping: a tile with a field of nb > 32, a span
//      that reaches cap_words - 1, or a start that is at or past 2^32
//      bits (its offsets wrap). A wrapping tile may add into any word
//      below, interior words of fast tiles included, so it first waits
//      until every earlier tile is DONE (its words written; each tile
//      republishes its inclusive prefix as DONE after its writes), and
//      every tile after it wraps too. The count of slow tiles goes to
//      scratch;
//   6. the last tile writes the total bit count mod 2^32.
// The words are zeroed by a cudaMemsetAsync before the launch: the
// boundary words take atomicAdds from two tiles and must start at 0,
// as must the words past the payload.
//
// Bound: bytes. The fields are read once (8 B each: 75.5 MB for the
// 9,437,224 fields of a 4 MiB metablock) and the words written once
// (8.4 MB): 0.025 ms at 3.35 TB/s. This design adds the memset (the
// words written twice) and 8 KB of table a tile (9.4 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                  // consecutive fields a thread
constexpr int TILE = THREADS * ITEMS;      // 4,096 fields per CTA
constexpr int NWB = TILE + 1;              // words a fast tile can span
// code table layout: lit code, lit len, cmd code, cmd len, dist code,
// dist len
constexpr int LIT = 256, CMD = 704, DIST = 64;
constexpr int LIT_CODE = 0, LIT_LEN = LIT_CODE + LIT;
constexpr int CMD_CODE = LIT_LEN + LIT, CMD_LEN = CMD_CODE + CMD;
constexpr int DIST_CODE = CMD_LEN + CMD, DIST_LEN = DIST_CODE + DIST;
constexpr int NTAB = DIST_LEN + DIST;      // 2,048 entries
constexpr int DIST_SYM = 4096;

constexpr unsigned long long AGGREGATE = 1ull << 62, INCLUSIVE = 2ull << 62,
                             DONE = 3ull << 62, STATUS = 3ull << 62;
constexpr unsigned long long BIG = 1ull << 32, LO = 0xffffffffull;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// two bit counts as (sum mod 2^32) | BIG if either reached 2^32
__device__ __forceinline__ unsigned long long combine(unsigned long long a,
                                                      unsigned long long b) {
  const unsigned long long s = (a & LO) + (b & LO);
  return (s & LO) | ((a | b | s) & BIG);
}

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

// The tile's bit count before it (bit0 included), on warp 0 (every lane
// returns it). Lane j of a round reads tile hi - j; tile 0 is always
// INCLUSIVE, so the rounds end.
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* desc, int c, int lane) {
  unsigned long long acc = 0;
  for (int hi = c - 1;; hi -= 32) {
    const int q = hi - lane;
    unsigned long long d = 0;
    if (q >= 0) {
      do d = ld_relaxed(desc + q);
      while ((d & STATUS) == 0);
    }
    const unsigned incl = __ballot_sync(FULL, q >= 0 && d >= INCLUSIVE);
    const int last = incl ? __ffs(incl) - 1 : 31;
    unsigned long long x = q >= 0 && lane <= last ? d & ~STATUS : 0;
#pragma unroll
    for (int off = 16; off; off >>= 1)
      x = combine(x, __shfl_xor_sync(FULL, x, off));
    acc = combine(acc, x);
    if (incl) return acc;
  }
}

// Block-wide exclusive scan of x over THREADS threads; *total gets the
// sum. Ends with a barrier.
__device__ __forceinline__ unsigned long long block_exclusive_scan(
    unsigned long long x, unsigned long long* s_warp,
    unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned long long y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    unsigned long long s = s_warp[w];
    before += w < warp ? s : 0ull;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + inc - x;
}

// the words of one field at offset off (uint32): the low word and the
// bits spilling into the next
__device__ __forceinline__ void field_words(uint32_t code, uint32_t nb,
                                            uint32_t off, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t v = code & (nb >= 32 ? FULL : (1u << nb) - 1u);
  const unsigned long long t = (unsigned long long)v << (off & 31u);
  lo = (uint32_t)t;
  hi = (uint32_t)(t >> 32);
}

__global__ void __launch_bounds__(THREADS)
pack_kernel(const int* __restrict__ vals, const int* __restrict__ mk,
            const int* __restrict__ tab, long long n, unsigned bit0,
            unsigned* __restrict__ words, long long cap_words,
            unsigned long long* desc, unsigned* ticket,
            unsigned long long* slow_tiles, unsigned long long* total) {
  __shared__ int s_tab[NTAB];
  __shared__ unsigned s_w[NWB];
  __shared__ unsigned long long s_warp[THREADS / 32];
  __shared__ unsigned long long s_start;
  __shared__ int s_c;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_c = (int)atomicAdd(ticket, 1u);
  for (int i = tid; i < NTAB; i += THREADS) s_tab[i] = tab[i];
  for (int i = tid; i < NWB; i += THREADS) s_w[i] = 0;
  __syncthreads();
  const int c = s_c;

  // 1. the fields, read once
  uint32_t code[ITEMS], nb[ITEMS];
  const long long f0 = (long long)c * TILE + (long long)tid * ITEMS;
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(mk)) & 15) == 0;
  if (vec && f0 + ITEMS <= n) {
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(vals + f0) + q);
      const int4 m = __ldcs(reinterpret_cast<const int4*>(mk + f0) + q);
      resolve(v.x, m.x, s_tab, code[4 * q], nb[4 * q]);
      resolve(v.y, m.y, s_tab, code[4 * q + 1], nb[4 * q + 1]);
      resolve(v.z, m.z, s_tab, code[4 * q + 2], nb[4 * q + 2]);
      resolve(v.w, m.w, s_tab, code[4 * q + 3], nb[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      code[i] = nb[i] = 0;
      if (f0 + i < n) resolve(vals[f0 + i], mk[f0 + i], s_tab, code[i], nb[i]);
    }
  }
  unsigned long long sum = 0;
  bool wide = false;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sum += nb[i];
    wide |= nb[i] > 32;
  }

  // 2. the block scan and 3. the look-back
  unsigned long long agg;
  const unsigned long long ex = block_exclusive_scan(sum, s_warp, &agg);
  wide = __syncthreads_or(wide);
  if (tid < 32) {
    const unsigned long long a = (agg & LO) | (agg >> 32 ? BIG : 0);
    unsigned long long start = bit0;
    if (c > 0) {
      if (lane == 0) st_relaxed(desc + c, AGGREGATE | a);
      start = look_back(desc, c, lane);
    }
    if (lane == 0) {
      st_relaxed(desc + c, INCLUSIVE | combine(start, a));
      s_start = start;
    }
  }
  __syncthreads();
  const unsigned long long start = s_start;
  const unsigned long long S = start & LO;  // the start bit mod 2^32
  const bool wraps = (start & BIG) || S + agg > (1ull << 32);
  const bool fast = !wide && !wraps &&
                    (agg == 0 || (long long)((S + agg - 1) >> 5) <
                                     cap_words - 1);

  if (agg > 0 && fast) {
    // 4. the words in shared memory, then out
    const unsigned long long w0 = S >> 5;
    unsigned long long off = S + ex;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (nb[i]) {
        uint32_t lo, hi;
        field_words(code[i], nb[i], (uint32_t)off, lo, hi);
        const int k = (int)((off >> 5) - w0);
        if (lo) atomicOr(&s_w[k], lo);
        if (hi) atomicOr(&s_w[k + 1], hi);
      }
      off += nb[i];
    }
    __syncthreads();
    const int nw = (int)(((S + agg + 31) >> 5) - w0);
    for (int k = tid; k < nw; k += THREADS) {
      const unsigned x = s_w[k];
      if (k > 0 && k < nw - 1)
        words[w0 + k] = x;
      else if (x)
        atomicAdd(&words[w0 + k], x);
    }
  } else if (agg > 0) {
    // 5. the slow path
    if (wraps) {
      if (tid < 32)
        for (int q = c - 1 - lane; q >= 0; q -= 32)
          while ((ld_relaxed(desc + q) & STATUS) != DONE) {
          }
      __threadfence();
      __syncthreads();
    }
    const long long last = cap_words - 1;
    unsigned long long off = S + ex;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (nb[i]) {
        uint32_t lo, hi;
        const uint32_t o = (uint32_t)off;  // uint32, as in JAX
        field_words(code[i], nb[i], o, lo, hi);
        const long long idx = o >> 5;
        if (lo) atomicAdd(&words[idx < last ? idx : last], lo);
        if (hi) atomicAdd(&words[idx + 1 < last ? idx + 1 : last], hi);
      }
      off += nb[i];
    }
    if (tid == 0) atomicAdd(slow_tiles, 1ull);
  }

  // 6. DONE once every thread's words are out (each fences its own
  // writes first); the last tile writes the total
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned long long incl = combine(start, (agg & LO) |
                                                       (agg >> 32 ? BIG : 0));
    st_relaxed(desc + c, DONE | incl);
    if (c == (int)gridDim.x - 1) *total = incl & LO;
  }
}

}  // namespace

// scratch: max(1, ceil(n / 4096)) tile descriptors, the ticket, the
// count of slow tiles and the total bit count (64-bit words); all but
// the total are zeroed here. The words are zeroed here too. Returns the
// memsets' error or cudaGetLastError() after the launch, -1 for bad
// arguments.
extern "C" int btt_bitpack(const int* vals, const int* markers,
                           const int* tab, long long n, int bit0,
                           int* words, long long cap_words, void* scratch,
                           cudaStream_t stream) {
  if (n < 0 || n >= (1ll << 31) || cap_words <= 0 || bit0 < 0)
    return -1;
  const int ntiles = n > 0 ? (int)((n + TILE - 1) / TILE) : 1;
  unsigned long long* desc = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(words, 0, cap_words * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(desc, 0, (ntiles + 2) * sizeof(unsigned long long),
                      stream);
  if (e != cudaSuccess) return (int)e;
  pack_kernel<<<ntiles, THREADS, 0, stream>>>(
      vals, markers, tab, n, (unsigned)bit0,
      reinterpret_cast<unsigned*>(words), cap_words, desc,
      reinterpret_cast<unsigned*>(desc + ntiles), desc + ntiles + 1,
      desc + ntiles + 2);
  return (int)cudaGetLastError();
}
