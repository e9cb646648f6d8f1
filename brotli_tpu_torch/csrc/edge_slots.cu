// K11: the edge-slot tables and literal costs of one DP segment.
//
// Replaces the slot rows of brotli_tpu/ops/optimal_jax.py::_edges_slots
// (the seed continuation scatter and fill, the per-slot length, distance
// and cost, the block clip), the dictionary and literal rows of
// _dp_v3_impl and, for v1, the literal row of _edges_kernel. On the TPU,
// XLA fuses them into a few loops; the port ran ~250 torch launches a
// segment. Inputs: K10's int32 (n, ncand) candidates (len << 25 | dist),
// the segment's bytes, the seed matches (int64 pos, len, dist) and, for
// v3, the dictionary hits (int64 pos, payload advance << 22 | wlen << 17
// | offset). Outputs, in the layout K1 (suffix_min.cu) and K7
// (dp_scan_v1.cu) read: int32 (nslots, n) pd (len << 25 | dist, dist 0
// below length 2) and cs (distance cost, 1 << 28 where no edge), int32
// (n,) litq and dist_fill.
//
// Per position p, room = B - p % B (edges never cross a DP block):
//   candidate slot s: le = min(cand >> 25, W - 1), di = cand & (2^25 - 1),
//     ls = min(le, room), cs = ls >= 2 ? dist_cost(di) : INF;
//   v3's dictionary slot (slot ncand, inserted after the clip, before the
//     continuation): dls = the largest advance of a hit at p, kept only if
//     dls <= room (a word reference is atomic), ddist = min(seg_base + p,
//     max_distance) + 1 + the largest offset of a hit at p, and pd =
//     dls << 25 | ddist in 64 bits cut to int32 (a length of 64 or more
//     wraps, as the JAX code's int32 shift does);
//   the continuation slot (last): end_fill and dist_fill are the ends
//     (pos + len) and the distances of the seed matches, scattered at
//     their clamped starts with a max PER FIELD (two seeds at one start
//     may give the end of one and the distance of the other), then each
//     filled forward with the last positive value at or before p, or 0
//     (_fill_last_positive's x[0], never positive there);
//     cont_len = clamp(end_fill - p, 0, W - 1), cont_dist = cont_len >= 2 ?
//     dist_fill : 0; its length is 0 unless cont_dist > 0;
//   litq: v3 lit_tab[ctx_tab[p1 << 8 | p2] << 8 | byte] * 2, v1
//     lit_tab[p1 << 8 | byte] (no * 2), p1 and p2 the bytes before p, 0
//     before the segment (a shift, not jnp.roll's wrap).
// dist_cost is _dist_cost_q in 64-bit arithmetic (the plain version's),
// its 64-entry symbol table in shared memory.
//
// Bound: bytes. Per 4 MiB segment it reads the 27 candidate columns
// (453 MB) and writes the 29 pd and cs rows and two (n,) rows (1,007
// MB): 0.44 ms at 3.35 TB/s. Design: one C call, two kernels after two
// memsets. The scatter kernel takes one thread per seed and per
// dictionary hit, with 64-bit atomicMax into zeroed (n,) rows, and
// records for each tile of TILE positions the last position that got a
// positive end (and distance). The slot kernel takes one CTA per tile:
// a warp finds the last positive position before the tile by walking
// the tiles' records back 32 at a time (one step when seeds are dense,
// n / TILE / 32 at most), then 256 threads sweep the tile in 16 rows of
// 256 positions, a block max-scan of positions per row giving the fill's
// source, and write every slot row coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int B = 4096;
constexpr int QB = 16;
constexpr int INF = 1 << 28;
constexpr int MASK25 = (1 << 25) - 1;
constexpr int TILE = 4096;  // positions per CTA of the slot kernel
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLOTS = 64;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const int* cand;
  const unsigned char* data;
  const long long* seed_pos;
  const long long* seed_len;
  const long long* seed_dist;
  const long long* dict_pos;
  const long long* dict_pay;
  const int* distq;
  const int* lit_tab;
  const int* ctx_tab;
  int* pd;
  int* cs;
  int* litq;
  int* dist_fill;
  long long* ends;   // scratch, zeroed: max end of a seed at each start
  long long* sdist;  // max distance of a seed at each start
  int* dls;          // max advance of a dictionary hit at each position
  int* doff;         // max offset
  int* tile_e;       // per tile: last start with a positive end, or -1
  int* tile_d;       // last start with a positive distance, or -1
  long long n, ns, nd, max_distance, seg_base;
  int ncand;
};

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// optimal._dist_cost_q: symbol bits + extra bits, npostfix = ndirect = 0
__device__ __forceinline__ int dist_cost(long long dist, const int* sym) {
  const long long d = (dist < 1 ? 1 : dist) - 1;
  const long long v = (d + 4) >> 2;
  const int nbits = 64 - __clzll(v | 1);
  const long long half =
      ((d + 4 - (long long)(2ULL << nbits)) >> nbits) & 1;
  const long long s = clampll(16 + ((((long long)nbits - 1) << 1) | half),
                              0, 63);
  return (int)((long long)sym[s] + (long long)nbits * QB);
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(FULL, x, d));
  return x;
}

__device__ __forceinline__ int warp_scan_max(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = max(x, y);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS) scatter_kernel(Args a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < a.ns) {
    const long long s0 = a.seed_pos[i], len = a.seed_len[i];
    const long long sp = clampll(s0, 0, a.n - 1);
    const long long ve = len > 0 ? s0 + len : 0;
    const long long vd = len > 0 ? a.seed_dist[i] : 0;
    // a value <= 0 leaves the zeroed row as it is
    if (ve > 0) {
      atomicMax(a.ends + sp, ve);
      atomicMax(a.tile_e + sp / TILE, (int)sp);
    }
    if (vd > 0) {
      atomicMax(a.sdist + sp, vd);
      atomicMax(a.tile_d + sp / TILE, (int)sp);
    }
  }
  if (a.dict_pos != nullptr && i < a.nd) {
    const long long val = a.dict_pay[i];
    if (val > 0) {
      const long long dp = clampll(a.dict_pos[i], 0, a.n - 1);
      atomicMax(a.dls + dp, (int)((val >> 22) & 0x3FF));
      atomicMax(a.doff + dp, (int)(val & ((1 << 17) - 1)));
    }
  }
}

__device__ __forceinline__ void put(const Args& a, int s, long long p, int ls,
                                    int dist, int cost) {
  a.pd[s * a.n + p] =
      (int)(((unsigned)ls << 25) | (unsigned)(ls >= 2 ? dist : 0));
  a.cs[s * a.n + p] = ls >= 2 ? cost : INF;
}

__global__ void __launch_bounds__(THREADS) slots_kernel(Args a) {
  __shared__ int sym[64];
  __shared__ int tot_e[WARPS], tot_d[WARPS];
  __shared__ int carry[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = blockIdx.x;
  if (threadIdx.x < 64) sym[threadIdx.x] = __ldg(a.distq + threadIdx.x);
  if (warp == 0) {
    // the last positive start before this tile: the first window of 32
    // earlier tiles (walking back) that holds one has it at its maximum
    int ce = -1, cd = -1;
    for (long long u0 = t - 1; u0 >= 0 && (ce < 0 || cd < 0); u0 -= 32) {
      const long long u = u0 - lane;
      int e = -1, d = -1;
      if (u >= 0) {
        e = a.tile_e[u];
        d = a.tile_d[u];
      }
      e = warp_max(e);
      d = warp_max(d);
      if (ce < 0) ce = e;
      if (cd < 0) cd = d;
    }
    if (lane == 0) {
      carry[0] = ce;
      carry[1] = cd;
    }
  }
  __syncthreads();
  int run_e = carry[0], run_d = carry[1];
  const bool v3 = a.ctx_tab != nullptr;
  const int nslots = a.ncand + (v3 ? 2 : 1);
  for (int c = 0; c < TILE; c += THREADS) {
    const long long p = t * TILE + c + threadIdx.x;
    const bool in = p < a.n;
    int ie = -1, id = -1;
    if (in) {
      if (a.ends[p] > 0) ie = (int)p;
      if (a.sdist[p] > 0) id = (int)p;
    }
    ie = warp_scan_max(ie, lane);
    id = warp_scan_max(id, lane);
    if (lane == 31) {
      tot_e[warp] = ie;
      tot_d[warp] = id;
    }
    __syncthreads();
    int pe = run_e, pdd = run_d;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) {
        pe = max(pe, tot_e[w]);
        pdd = max(pdd, tot_d[w]);
      }
      run_e = max(run_e, tot_e[w]);
      run_d = max(run_d, tot_d[w]);
    }
    ie = max(ie, pe);
    id = max(id, pdd);
    __syncthreads();
    if (!in) continue;

    const long long efill = ie >= 0 ? a.ends[ie] : 0;
    const long long dfill = id >= 0 ? a.sdist[id] : 0;
    const int room = B - (int)(p % B);
    const int* cp = a.cand + p * a.ncand;
    for (int s = 0; s < a.ncand; ++s) {
      const int v = __ldg(cp + s);
      const int le = min(v >> 25, W - 1);
      const int ls = min(le, room);
      const int di = v & MASK25;
      put(a, s, p, ls, di, ls >= 2 ? dist_cost(di, sym) : INF);
    }
    if (v3) {
      // the atomic dictionary slot, after the clip
      long long dl = a.dls[p];
      if (dl > room) dl = 0;
      const long long maxd_at =
          a.seg_base + p < a.max_distance ? a.seg_base + p : a.max_distance;
      const long long ddist = dl >= 2 ? maxd_at + 1 + a.doff[p] : 0;
      const int s = a.ncand;
      a.pd[s * a.n + p] = (int)(unsigned long long)((dl << 25) | ddist);
      a.cs[s * a.n + p] = dl >= 2 ? dist_cost(ddist, sym) : INF;
    }
    {
      const long long cl = clampll(efill - p, 0, W - 1);
      const long long cdist = cl >= 2 ? dfill : 0;
      const int ls = min((int)(cdist > 0 ? cl : 0), room);
      const int cost = (cl >= 2 && cdist > 0) ? dist_cost(cdist, sym) : INF;
      put(a, nslots - 1, p, ls, (int)cdist, cost);
    }
    const int d0 = a.data[p];
    const int p1 = p >= 1 ? a.data[p - 1] : 0;
    if (v3) {
      const int p2 = p >= 2 ? a.data[p - 2] : 0;
      const long long cid = __ldg(a.ctx_tab + ((p1 << 8) | p2));
      a.litq[p] = (int)((unsigned)__ldg(a.lit_tab + ((cid << 8) | d0)) * 2u);
    } else {
      a.litq[p] = __ldg(a.lit_tab + ((p1 << 8) | d0));
    }
    a.dist_fill[p] = (int)dfill;
  }
}

}  // namespace

// scratch: int64 (3n + ntiles,) with ntiles = ceil(n / TILE): the ends
// and distances rows, the dictionary's two int32 rows, the tiles' two
// int32 records
extern "C" int btt_edge_slots(const int* cand, const unsigned char* data,
                              const long long* seed_pos,
                              const long long* seed_len,
                              const long long* seed_dist, long long ns,
                              const long long* dict_pos,
                              const long long* dict_pay, long long nd,
                              const int* distq, const int* lit_tab,
                              const int* ctx_tab, int* pd, int* cs,
                              int* litq, int* dist_fill, long long* scratch,
                              long long n, int ncand, long long max_distance,
                              long long seg_base, cudaStream_t stream) {
  const bool v3 = ctx_tab != nullptr;
  if (n <= 0 || n >= (1LL << 31) || ncand < 1 ||
      ncand + (v3 ? 2 : 1) > MAX_SLOTS || ns < 0 || nd < 0 ||
      (v3 && (dict_pos == nullptr || dict_pay == nullptr)))
    return -1;
  const long long ntiles = (n + TILE - 1) / TILE;
  Args a;
  a.cand = cand;
  a.data = data;
  a.seed_pos = seed_pos;
  a.seed_len = seed_len;
  a.seed_dist = seed_dist;
  a.dict_pos = v3 ? dict_pos : nullptr;
  a.dict_pay = dict_pay;
  a.distq = distq;
  a.lit_tab = lit_tab;
  a.ctx_tab = ctx_tab;
  a.pd = pd;
  a.cs = cs;
  a.litq = litq;
  a.dist_fill = dist_fill;
  a.ends = scratch;
  a.sdist = scratch + n;
  a.dls = reinterpret_cast<int*>(scratch + 2 * n);
  a.doff = a.dls + n;
  a.tile_e = reinterpret_cast<int*>(scratch + 3 * n);
  a.tile_d = a.tile_e + ntiles;
  a.n = n;
  a.ns = ns;
  a.nd = v3 ? nd : 0;
  a.max_distance = max_distance;
  a.seg_base = seg_base;
  a.ncand = ncand;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 3 * n * sizeof(long long),
                                  stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(a.tile_e, 0xFF, 2 * ntiles * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const long long nsc = ns > a.nd ? ns : a.nd;
  if (nsc > 0)
    scatter_kernel<<<(unsigned)((nsc + THREADS - 1) / THREADS), THREADS, 0,
                     stream>>>(a);
  slots_kernel<<<(unsigned)ntiles, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
