// K2: the greedy-parse chain walk of the device LZ matcher.
//
// Replaces brotli_tpu/ops/chain_pallas.py::chain_select (its kernel
// _chain_kernel). From `start`, walk pos -> pos + skip[pos] while
// pos < n and set sel[pos] = 1 at every visited pos with skip[pos] > 1;
// every other entry is 0. skip is int32 (n,) with 1 <= skip <= CAP = 16
// (the matcher's parallel match-length cap); a value outside that range
// sets *err and is walked as 1, so the walk always ends. A start of n or
// more marks nothing.
//
// The TPU kernel streamed skip through SMEM in order and carried the
// position from one grid step to the next: one scalar walker. On the
// card a single thread chasing the chain would wait on millions of
// dependent loads. Since 1 <= skip <= 16, a walk enters any span of
// positions at one of 16 offsets, so a span's effect is a map
// {0..15} -> {0..15} (16 nibbles in one 64-bit word), and such maps
// compose associatively. One launch, one CTA of 256 threads per chunk
// of L = 4096 positions, the chunk index from a ticket: the chunks from
// start's on first, in order (so every predecessor a look-back waits on
// is running or done), then the chunks before it, which wait on nothing.
//   1. stage the chunk's skips in shared memory as bytes (16-byte
//      loads), clamping and flagging values outside [1, 16];
//   2. thread (s, o) walks sub-chunk s (S = 256 positions) from offset
//      o < 16: its exit offset into sub-chunk s + 1 and a 256-bit mask
//      of the positions it visits. In the chunk that holds `start`,
//      walker (s0, 0) of start's sub-chunk walks from start instead (no
//      walker of sub-chunks up to s0 is used there);
//   3. the chunk map F_c(o) = e[15][...e[0][o]...], 16 lanes;
//   4. decoupled look-back (Merrill & Garland, 2016): publish F_c as
//      AGGREGATE, then compose the predecessors' maps, 32 a round (one
//      lane each), until one is INCLUSIVE and gives its exit offset;
//      publish INCLUSIVE exit_c = F_c(entry_c) at once. The chunk that
//      holds `start` publishes INCLUSIVE from its start walker; chunks
//      before it publish NOT_VISITED and store zeros;
//   5. entry_{s+1} = e[s][entry_s], 16 steps on one thread; then every
//      thread stores the chosen walkers' mask bits AND skip > 1 as
//      int32 sel, 16 bytes at a time, zeros included.
//
// Bound: bytes (n int32 read once, n int32 written once: 67 MB at
// n = 8 Mi, 0.020 ms at 3.35 TB/s). A chunk's dependent chain is
// S + 2 * 16 shared-memory loads and its look-back rounds, one L2
// round trip each; once every map is out, the INCLUSIVE front moves
// up to 2 * 32 chunks a round. 256 threads let 8 CTAs share an
// SM, so the 1,024 chunks after a start in the middle of 8 Mi are all
// resident at once.
//
// The descriptors, the ticket and the error flag are zeroed by
// cudaMemsetAsync in btt_chain_select before each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 4096;               // positions per chunk (one CTA)
constexpr int S = 256;                // positions per sub-chunk
constexpr int NSUB = L / S;           // 16 sub-chunks
constexpr int CAP = 16;               // largest skip: 16 entry offsets
constexpr int THREADS = NSUB * CAP;   // 256 sub-chunk walkers
constexpr int WORDS = S / 32;         // mask words per walker
// word w of walker t at mask[w * MSTRIDE + t]: conflict-free both for
// 32 walkers flushing one word and for 4 words of one walker read in
// the marking pass (MSTRIDE = 1 mod 32)
constexpr int MSTRIDE = THREADS + 1;

constexpr int AGGREGATE = 1, INCLUSIVE = 2, NOT_VISITED = 3;  // low 2 bits
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NIBBLES = 0x1111111111111111ull;

// A chunk's descriptor is two 64-bit words, each written whole by one
// relaxed store and each carrying its kind in its high half, so a
// reader needs no fence: word 0 holds the kind with the map's low 32
// bits (or, for INCLUSIVE, the exit offset in the kind), word 1 the
// kind AGGREGATE with the map's high 32 bits.
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

__device__ __forceinline__ void publish(unsigned long long* d, int kind) {
  st_relaxed(d, (unsigned long long)kind << 32);
}

__device__ __forceinline__ unsigned clamp_byte(int v, bool& bad) {
  if (v < 1 || v > CAP) {
    bad = true;
    return 1;
  }
  return (unsigned)v;
}

// Walk the sub-chunk [lo, lo + S) of the staged skips from local
// position p; write walker t's visit mask (bit p & 31 of word
// (p - lo) >> 5 set where the walk visits p) and return its exit
// offset into the next sub-chunk. Steps are below 32, so each inner
// loop ends in the next word, and the last one past the sub-chunk.
__device__ __forceinline__ int walk(const unsigned char* sk, int lo, int p,
                                    unsigned* mask, int t) {
  int w = (p - lo) >> 5;
  for (int k = 0; k < w; ++k) mask[k * MSTRIDE + t] = 0;
  for (; w < WORDS; ++w) {
    const int end = lo + 32 * (w + 1);
    unsigned cur = 0;
    do {
      cur |= 1u << (p & 31);
      p += sk[p];
    } while (p < end);
    mask[w * MSTRIDE + t] = cur;
  }
  return p - lo - S;
}

// Chunk c's entry offset, on warp 0 (every lane returns it). Lane j of
// a round reads chunk hi - j. acc holds, unpacked on lanes 0..15, the
// map from the exit offset of chunk hi to c's entry offset.
__device__ __forceinline__ int look_back(const unsigned long long* desc,
                                         int c, long long sc, int lane) {
  int acc = lane & (CAP - 1);
  for (long long hi = c - 1;; hi -= 32) {
    const long long q = hi - lane;
    const bool live = q >= sc;
    unsigned long long m = 0;
    int st = 0;
    if (live) {
      const unsigned long long* d = desc + 2 * q;
      unsigned long long lo = ld_relaxed(d), hi_word = ld_relaxed(d + 1);
      while ((lo >> 32) == 0) lo = ld_relaxed(d);
      st = (int)(lo >> 32);
      if ((st & 3) == AGGREGATE) {
        while ((hi_word >> 32) == 0) hi_word = ld_relaxed(d + 1);
        m = hi_word << 32 | (lo & 0xffffffffull);
      } else {
        m = (unsigned long long)(st >> 8) * NIBBLES;
      }
    }
    // chunk sc is INCLUSIVE, so a round that reaches past it has one
    const unsigned incl = __ballot_sync(FULL, live && (st & 3) == INCLUSIVE);
    const int last = incl ? __ffs(incl) - 1 : 31;
    // the round's map T = M_0 o M_1 o ... o M_last; acc = acc o T
    int x = lane & (CAP - 1);
    for (int j = last; j >= 0; --j)
      x = (int)(__shfl_sync(FULL, m, j) >> (4 * x)) & (CAP - 1);
    acc = __shfl_sync(FULL, acc, x);
    if (incl) return acc;  // T is constant: acc is the entry
  }
}

__global__ void __launch_bounds__(THREADS)
chain_select_kernel(const int* __restrict__ skip, int* __restrict__ sel,
                    unsigned long long* desc, int* ticket, int* err,
                    long long start) {
  __shared__ __align__(16) unsigned char sk[L];
  __shared__ unsigned mask[WORDS * MSTRIDE];
  __shared__ unsigned char ex[THREADS];  // e[s][o] at ex[s * CAP + o]
  __shared__ int ent[NSUB];              // walker of each sub-chunk, -1 none
  __shared__ int s_c;
  const int tid = threadIdx.x;

  const long long sc = start / L;
  if (tid == 0) {
    const int t = atomicAdd(ticket, 1);
    const int nv = (int)(sc < gridDim.x ? sc : gridDim.x);
    s_c = t < (int)gridDim.x - nv ? nv + t : t - ((int)gridDim.x - nv);
  }
  __syncthreads();
  const int c = s_c;
  const long long base = (long long)c * L;

  // 1. stage
  bool bad = false;
  unsigned* sk32 = reinterpret_cast<unsigned*>(sk);
  const int* src = skip + base;
  const bool vec = (reinterpret_cast<uintptr_t>(skip) & 15) == 0;
  for (int k = tid; k < L / 4; k += THREADS) {
    const int4 v = vec ? __ldcs(reinterpret_cast<const int4*>(src) + k)
                       : make_int4(src[4 * k], src[4 * k + 1],
                                   src[4 * k + 2], src[4 * k + 3]);
    sk32[k] = clamp_byte(v.x, bad) | clamp_byte(v.y, bad) << 8 |
              clamp_byte(v.z, bad) << 16 | clamp_byte(v.w, bad) << 24;
  }
  if (__syncthreads_or(bad) && tid == 0) atomicOr(err, 1);

  int4* dst = reinterpret_cast<int4*>(sel + base);
  if (c < sc) {
    if (tid == 0) publish(desc + 2 * c, NOT_VISITED);
    for (int k = tid; k < L / 4; k += THREADS)
      dst[k] = make_int4(0, 0, 0, 0);
    return;
  }

  // 2. sub-chunk walks
  const int os = c == sc ? (int)(start - base) : -1;  // start's offset
  {
    // in the chunk that holds start, walker (s0, 0) walks from start
    // instead: no walker of sub-chunks s0 and before is used there
    const int s = tid / CAP;
    const int p = os >= 0 && tid == os / S * CAP ? os : s * S + tid % CAP;
    ex[tid] = (unsigned char)walk(sk, s * S, p, mask, tid);
  }
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    int entry = 0;
    if (os < 0) {
      // 3. the chunk map, packed on all lanes, published as AGGREGATE
      int x = lane & (CAP - 1);
      for (int s = 0; s < NSUB; ++s) x = ex[s * CAP + x];
      unsigned long long m =
          lane < CAP ? (unsigned long long)x << (4 * lane) : 0;
      for (int off = 16; off; off >>= 1) m |= __shfl_xor_sync(FULL, m, off);
      const unsigned long long agg = (unsigned long long)AGGREGATE << 32;
      if (lane == 0) {
        st_relaxed(desc + 2 * c + 1, agg | m >> 32);
        st_relaxed(desc + 2 * c, agg | (m & 0xffffffffull));
      }
      // 4. look back; the exit F_c(entry) goes out before the entries
      entry = look_back(desc, c, sc, lane);
      if (lane == 0)
        publish(desc + 2 * c,
                INCLUSIVE | (int)(m >> (4 * entry) & (CAP - 1)) << 8);
    }
    // 5. the entries (and the start chunk's exit, published)
    if (lane == 0) {
      int s = 0, x = entry;
      if (os >= 0) {
        for (; s < os / S; ++s) ent[s] = -1;
        ent[s] = s * CAP;
        x = ex[s * CAP];
        ++s;
      }
      for (; s < NSUB; ++s) {
        ent[s] = s * CAP + x;
        x = ex[s * CAP + x];
      }
      if (os >= 0) publish(desc + 2 * c, INCLUSIVE | x << 8);
    }
  }
  __syncthreads();

  // the visited positions whose skip exceeds 1 (a byte above 1 has a
  // bit in 0x1e: the bytes lie in [1, 16])
  for (int k = tid; k < L / 4; k += THREADS) {
    const int p = 4 * k;
    const int w = ent[p / S];
    const unsigned b =
        w < 0 ? 0u : mask[(p % S) / 32 * MSTRIDE + w] >> (p % 32);
    const unsigned v = sk32[k] & 0x1e1e1e1eu;
    dst[k] = make_int4(b & ((v & 0xffu) != 0), (b >> 1) & ((v & 0xff00u) != 0),
                       (b >> 2) & ((v & 0xff0000u) != 0),
                       (b >> 3) & ((v & 0xff000000u) != 0));
  }
}

}  // namespace

// scratch: the chunk descriptors (2 * n / L 64-bit words, 8-byte
// aligned), the ticket and the error flag (one int each), all zeroed
// here. sel must be 16-byte aligned. Returns the memset's error or
// cudaGetLastError() after the launch, -1 for bad arguments.
extern "C" int btt_chain_select(const int* skip, int* sel, void* scratch,
                                long long n, long long start,
                                cudaStream_t stream) {
  if (n <= 0 || n % L || n >= (1ll << 31) || start < 0) return -1;
  const int nchunks = (int)(n / L);
  unsigned long long* desc = static_cast<unsigned long long*>(scratch);
  int* ticket = reinterpret_cast<int*>(desc + 2 * nchunks);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, 2 * nchunks * sizeof(unsigned long long) + 2 * sizeof(int),
      stream);
  if (e != cudaSuccess) return (int)e;
  chain_select_kernel<<<nchunks, THREADS, 0, stream>>>(
      skip, sel, desc, ticket, ticket + 1, start);
  return (int)cudaGetLastError();
}
