// K5: LZ copy resolution of the device decoder.
//
// Replaces brotli_tpu/ops/lz_resolve.py::_resolve, whose pointer
// doubling is a device-side lax.fori_loop. The symbol parse gives a
// command list (nlit, ncopy, dist) and the flat literal stream; output
// position j of command ci is a literal when its offset in the command
// is below nlit[ci], else a copy of position f(j) = j - dist[ci]. Let
// depth(j) be 0 for a literal and depth(f(j)) + 1 for a copy. After k
// out-of-place doubling rounds the JAX code holds f^(2^k)(j), so it
// returns the chain's literal where depth(j) <= 2^n_steps and 0
// elsewhere. This kernel computes every position's root literal and its
// EXACT depth, then applies that rule: the same bytes at every n_steps,
// cut-short counts included, whatever order it resolves in.
//
// State of a position, one 64-bit word: bit 63 set = resolved (the low
// byte is the literal), else the low 32 bits point at an earlier
// position t = f^d(j) that is not known to be a literal; bits 32..62
// hold d. Depths stay below n_out < 2^31, so composing two states is one
// add: state(j) <- state(t) + (state(j) & DEPTH).
//
// Two launches:
//   1. tile: a CTA of 512 threads per tile of T = 8,192 positions.
//      One cooperative search finds the tile's first command (512
//      probes a round, three rounds for a million commands: no search
//      per position), and the tile's literals, which are consecutive in
//      the literal stream from that command's, are staged in shared
//      memory (the first 4,096). The commands that overlap the tile
//      mark their first position in shared memory, and a block max-scan
//      gives every position its command. Each position's state: a
//      literal (resolved, depth 0), or a pointer to j - dist with depth
//      1; a copy whose source is not in [0, j) sets *err and resolves
//      to byte 0. Then the pointers into the same tile are jumped in
//      shared memory, in place (each thread owns 16 consecutive
//      positions and walks those still in the tile lowest first, so a
//      run copied at a short distance collapses in one pass), until a
//      block-wide vote finds none left. This is where RLE chains live
//      (distance < length). Every position is now resolved or points
//      before its tile; the states go to global memory (8 B a position)
//      and the count of unresolved ones to cnt[1].
//   2. jump: a persistent grid over the positions, low to high, each
//      thread following U = 4 positions at once (independent loads).
//      An unresolved position follows its chain in place: read the
//      target's word (relaxed, at GPU scope), compose, store its own
//      word, until resolved; then out[j] = byte if depth <= 2^n_steps,
//      else 0. Only a position's owner writes its word, and every word
//      read is some valid (f^e(t), e) with the chain's exact depth
//      preserved, so any interleaving gives the one answer: in-place
//      and asynchronous rather than out-of-place rounds, because what
//      other threads have already resolved only shortens a walk
//      (positions low in the output finish first, and later chains land
//      on them), and no grid-wide barrier is needed. The hops go to
//      cnt[2] (sum) and cnt[3] (most of one position).
//
// Bound: bytes. The function reads the literals and the three command
// arrays once and writes n_out bytes: 0.0095 ms at 3.35 TB/s for the
// q11 stream's 16,777,216 positions and 1.12 M commands. This design
// moves, at n positions and c commands: the wrapper's two cumsums
// (~5 * 4c B); launch 1 reads the five command arrays (20c B) and the
// literals and writes the states (8n B); launch 2 reads them (8n B),
// gathers 8 B and stores 8 B a hop and writes the bytes (n B). At the
// q11 stream's sizes that is ~300 MB plus 16 B a hop: the states'
// round trip through memory is this design's floor (~0.085 ms).
//
// cnt (four 64-bit counters: err, unresolved after the tile collapse,
// hops, most hops) is zeroed by cudaMemsetAsync in btt_lz_resolve.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int T = 8192;           // positions per tile (one CTA)
constexpr int NT = 512;           // threads of a tile CTA
constexpr int ITEMS = T / NT;     // 16 consecutive positions a thread
// a pad word after every 16: thread t's first word then sits at
// 17 t, so a half-warp's 64-bit accesses to its own positions (and 16
// consecutive positions) fall in distinct banks
constexpr int SMEM_WORDS = T + T / 16;
// the tile's first LITS literals, staged (a tile holds ~9% literals on
// the corpus streams; a literal past them is read from global memory)
constexpr int LITS = 4096;
constexpr int SMEM_BYTES = SMEM_WORDS * 8 + LITS;
constexpr int JUMP_THREADS = 256;
constexpr int MAX_DEVICES = 64;  // devices btt_lz_resolve sets up

constexpr unsigned long long RES = 1ull << 63;
constexpr unsigned long long DEPTH = 0x7fffffffull << 32;
constexpr unsigned long long LOW = 0xffffffffull;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int sk(int p) { return p + (p >> 4); }

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Block-wide exclusive max-scan of x over NT threads (0 before the
// first); s_warp holds one word a warp. Ends with a barrier.
__device__ __forceinline__ unsigned long long block_exclusive_max(
    unsigned long long x, unsigned long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc = max(inc, y);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before = max(before, s_warp[w]);
  unsigned long long ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = 0;
  __syncthreads();
  return max(before, ex);
}

// A run's descriptor, marked at its first position m of the tile: the
// key m + 1 on top (so a max-scan carries each position's run), bit 32
// set for a copy run, and the low word: dist for a copy run, lit_off -
// start for a literal run (a literal's index is that plus j).
constexpr unsigned long long COPY_RUN = 1ull << 32;
__device__ __forceinline__ unsigned long long run_desc(int m, bool copy,
                                                       int v) {
  return (unsigned long long)(m + 1) << 50 | (copy ? COPY_RUN : 0ull) |
         (unsigned)v;
}

// Steps 1 and 2 for tile c: the states of its positions in s, each
// resolved or pointing before the tile. A bad copy sets cnt[0].
__device__ __forceinline__ void tile_states(
    int c, const uint8_t* __restrict__ lits, long long nlits,
    const int* __restrict__ nlit, const int* __restrict__ ncopy,
    const int* __restrict__ dist, const int* __restrict__ ends,
    const int* __restrict__ lit_off, int ncmd, int n_out,
    unsigned long long* s, unsigned long long* s_warp,
    unsigned long long* cnt) {
  const int tid = threadIdx.x;
  const int t0 = c * T;
  const int len = min(T, n_out - t0);
  const int t1 = t0 + len;

  for (int i = tid; i < SMEM_WORDS; i += NT) s[i] = 0;
  __syncthreads();

  // the tile's first command: the first ci with ends[ci] > t0. Probe
  // k of a round reads ends[lo + k * step]; the probes below t0 are a
  // prefix (ends does not decrease), so their count places the answer
  // between two probes.
  int lo = 0, hi = ncmd;
  while (lo < hi) {
    const int step = (hi - lo + NT - 1) / NT;
    const long long q = lo + (long long)tid * step;
    const int below = __syncthreads_count(q < hi && ends[q] <= t0);
    if (below == 0) {
      hi = lo;
    } else {
      const long long qc = lo + (long long)below * step;
      lo += (below - 1) * step + 1;
      hi = qc < hi ? (int)qc : hi;
    }
  }
  const int c0 = lo;

  // stage the tile's first LITS literals: the first literal at or after
  // t0 is lit_off[c0] + min(max(t0 - start, 0), nlit[c0]), and the
  // tile's literals follow it in order
  uint8_t* s_lits = reinterpret_cast<uint8_t*>(s + SMEM_WORDS);
  long long l0;
  {
    const int nl0 = nlit[c0];
    const int start0 = ends[c0] - nl0 - ncopy[c0];
    l0 = (long long)lit_off[c0] + min(max(t0 - start0, 0), nl0);
  }
  for (int i = tid; i < LITS; i += NT)
    if (l0 + i < nlits) s_lits[i] = lits[l0 + i];

  // every command that reaches the tile marks the first position of
  // its literal run and of its copy run there; the rounds end at the
  // first command that starts past the tile (ends[k] > t0 from c0 on)
  for (int k = c0 + tid;; k += NT) {
    bool in = false;
    if (k < ncmd) {
      const int nl = nlit[k], nc = ncopy[k];
      const int s0 = ends[k] - nl - nc;
      if (s0 < t1) {
        in = true;
        const int m1 = s0 - t0, m2 = m1 + nl;  // literal, copy run starts
        if (nl > 0 && m2 > 0)
          s[sk(max(m1, 0))] = run_desc(max(m1, 0), false, lit_off[k] - s0);
        if (nc > 0 && m2 < len)
          s[sk(max(m2, 0))] = run_desc(max(m2, 0), true, dist[k]);
      }
    }
    if (__syncthreads_count(in) < NT) break;
  }

  // each position's run: a max-scan of the marks; then its state, and
  // bit i of act set where position p0 + i points into the tile
  const int p0 = tid * ITEMS;
  unsigned long long run = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) run = max(run, s[sk(p0 + i)]);
  run = block_exclusive_max(run, s_warp);
  bool bad = false;
  unsigned act = 0;
  for (int i = 0; i < ITEMS && p0 + i < len; ++i) {
    const int p = p0 + i;
    run = max(run, s[sk(p)]);
    const int v = (int)(unsigned)run;
    const int j = t0 + p;
    unsigned long long w;
    if (!(run & COPY_RUN)) {
      long long li = (long long)v + j;
      li = li < 0 ? 0 : (li >= nlits ? nlits - 1 : li);
      w = RES | (li >= l0 && li < l0 + LITS ? s_lits[li - l0] : lits[li]);
    } else {
      const long long src = (long long)j - v;
      if (src >= 0 && src < j) {
        w = 1ull << 32 | (unsigned long long)src;
        if (src >= t0) act |= 1u << i;
      } else {
        bad = true;
        w = RES;
      }
    }
    s[sk(p)] = w;
  }
  if (__syncthreads_or(bad) && tid == 0) atomicOr(cnt, 1ull);

  // collapse the pointers into the tile, in place, lowest first
  volatile unsigned long long* vs = s;
  while (__syncthreads_or(act != 0)) {
    unsigned next = 0;
    for (unsigned m = act; m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      const int p = p0 + i;
      unsigned long long w = vs[sk(p)];
      w = vs[sk((int)(w & LOW) - t0)] + (w & DEPTH);
      vs[sk(p)] = w;
      if (!(w & RES) && (int)(w & LOW) >= t0) next |= 1u << i;
    }
    act = next;
  }
}

// the count of unresolved positions of the tile (striped p = k * NT +
// tid) into cnt[1], and their states into st
__device__ __forceinline__ void store_states(int t0, int len,
                                             const unsigned long long* s,
                                             unsigned long long* st,
                                             unsigned long long* s_warp,
                                             unsigned long long* cnt) {
  const int tid = threadIdx.x;
  int left = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = k * NT + tid;
    if (p < len) {
      const unsigned long long w = s[sk(p)];
      st[t0 + p] = w;
      left += !(w & RES);
    }
  }
  const int wl = __reduce_add_sync(FULL, left);
  if ((tid & 31) == 0) s_warp[tid >> 5] = wl;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int w = 0; w < NT / 32; ++w) sum += s_warp[w];
    if (sum) atomicAdd(cnt + 1, (unsigned long long)sum);
  }
}

__global__ void __launch_bounds__(NT)
tile_kernel(const uint8_t* __restrict__ lits, long long nlits,
            const int* __restrict__ nlit, const int* __restrict__ ncopy,
            const int* __restrict__ dist, const int* __restrict__ ends,
            const int* __restrict__ lit_off, int ncmd, int n_out,
            unsigned long long* __restrict__ st,
            unsigned long long* __restrict__ cnt) {
  extern __shared__ unsigned long long s[];  // SMEM_BYTES
  __shared__ unsigned long long s_warp[NT / 32];
  tile_states(blockIdx.x, lits, nlits, nlit, ncopy, dist, ends, lit_off,
              ncmd, n_out, s, s_warp, cnt);
  const int t0 = blockIdx.x * T;
  store_states(t0, min(T, n_out - t0), s, st, s_warp, cnt);
}

constexpr int U = 4;  // positions a jump thread follows at once

__global__ void __launch_bounds__(JUMP_THREADS)
jump_kernel(unsigned long long* st, uint8_t* __restrict__ out,
            long long n_out, unsigned long long limit,
            unsigned long long* __restrict__ cnt) {
  unsigned hops = 0, most = 0;
  const long long stride = (long long)gridDim.x * JUMP_THREADS * U;
  for (long long b = (long long)blockIdx.x * JUMP_THREADS * U + threadIdx.x;
       b < n_out; b += stride) {
    unsigned long long w[U], t[U];
    unsigned h[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = b + u * JUMP_THREADS;
      w[u] = j < n_out ? st[j] : RES;
      h[u] = 0;
    }
    for (;;) {
      bool any = false;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (!(w[u] & RES)) t[u] = ld_relaxed(st + (w[u] & LOW));
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (!(w[u] & RES)) {
          w[u] = t[u] + (w[u] & DEPTH);
          ++h[u];
          st_relaxed(st + b + u * JUMP_THREADS, w[u]);
          any |= !(w[u] & RES);
        }
      if (!any) break;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = b + u * JUMP_THREADS;
      if (j < n_out)
        out[j] = (w[u] >> 32 & 0x7fffffffull) <= limit ? (uint8_t)w[u] : 0;
      hops += h[u];
      most = max(most, h[u]);
    }
  }
  __shared__ unsigned s_hops[JUMP_THREADS / 32], s_most[JUMP_THREADS / 32];
  hops = __reduce_add_sync(FULL, hops);
  most = __reduce_max_sync(FULL, most);
  if ((threadIdx.x & 31) == 0) {
    s_hops[threadIdx.x >> 5] = hops;
    s_most[threadIdx.x >> 5] = most;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < JUMP_THREADS / 32; ++w) {
      sum += s_hops[w];
      most = max(most, s_most[w]);
    }
    if (sum) {
      atomicAdd(cnt + 2, sum);
      atomicMax(cnt + 3, (unsigned long long)most);
    }
  }
}

}  // namespace

// st: int64 (n_out,) states; out: uint8 (n_out,); cnt: four 64-bit
// counters (err, unresolved after the tile collapse, hops, most hops),
// zeroed here. Returns the memset's error or cudaGetLastError() after
// the launches, -1 for bad arguments.
extern "C" int btt_lz_resolve(const uint8_t* lits, long long nlits,
                              const int* nlit, const int* ncopy,
                              const int* dist, const int* ends,
                              const int* lit_off, int ncmd, int n_out,
                              int n_steps, void* st, uint8_t* out,
                              void* cnt, cudaStream_t stream) {
  if (nlits <= 0 || ncmd <= 0 || n_out <= 0 || n_steps < 0) return -1;
  // The tile kernel's shared-memory attribute and the jump grid belong
  // to the current device: a process that decodes on a second card must
  // set the attribute there too, or the tile launch fails. Both are set
  // up once a device, under a lock, since any host thread may launch.
  static std::mutex setup_lock;
  static int jump_grids[MAX_DEVICES];  // 0: not set up on that device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  int jump_grid;
  {
    std::lock_guard<std::mutex> guard(setup_lock);
    if (jump_grids[dev] == 0) {
      int sms = 0, per_sm = 0;
      if ((e = cudaFuncSetAttribute(
               tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
               SMEM_BYTES)) != cudaSuccess ||
          (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
          (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, jump_kernel, JUMP_THREADS, 0)) != cudaSuccess)
        return (int)e;
      jump_grids[dev] = sms * per_sm;
    }
    jump_grid = jump_grids[dev];
  }
  unsigned long long* c = static_cast<unsigned long long*>(cnt);
  unsigned long long* w = static_cast<unsigned long long*>(st);
  e = cudaMemsetAsync(c, 0, 4 * sizeof(*c), stream);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n_out + T - 1) / T;
  tile_kernel<<<tiles, NT, SMEM_BYTES, stream>>>(
      lits, nlits, nlit, ncopy, dist, ends, lit_off, ncmd, n_out, w, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const unsigned long long limit =
      n_steps >= 31 ? ~0ull : 1ull << n_steps;
  const long long need =
      ((long long)n_out + JUMP_THREADS * U - 1) / (JUMP_THREADS * U);
  jump_kernel<<<(int)(need < jump_grid ? need : jump_grid), JUMP_THREADS, 0,
                stream>>>(w, out, n_out, limit, c);
  return (int)cudaGetLastError();
}
