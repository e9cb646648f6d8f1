// K7: the v1 DP wavefront, every edge slot relaxed in the scan itself.
//
// Replaces brotli_tpu/ops/optimal_jax.py::_scan_kernel, a lax.scan over
// the B in-block positions with the blocks as the vector axis. Per step
// i, with F/P the (cost, payload) of window columns 0..W-1 (column c is
// position i + c) and cost_i = F[0]:
//   1. the final payload of position i is P[0];
//   2. literal relax into column 1 (strict <; payload 0);
//   3. every slot s relaxes every column c with 2 <= c <= len_s at
//      cost_i + cs_s + copyq[c]; minv[c] is the minimum over the slots
//      (1<<30 where none reaches c) and pay[c] the smallest
//      (c << 25) | dist_s among the slots that give minv[c];
//   4. where minv < F (strict), F = minv and P = pay;
//   5. shift the window by one (new column W-1 = (1<<30, 0)).
// Output: paymat (nb, B + 1) int32, the payloads of positions 0..B.
// It differs from K1 + K3 in three ways, all kept: a tie goes to the
// smallest distance, not the lowest slot; an unreached column is 1<<30,
// not 1<<29; a slot with len >= 2 is priced whatever its cost. All
// sums are int32 with wrap-around, like XLA's.
//
// Bound: bytes. A 2 MiB segment (28 slots, 38 with the 16-byte level)
// reads 470 MB of slots, 0.14 ms at the card's byte rate; its compare
// work, done once per (step, slot), is far below the int32 peak. What
// held the first version back was the chain: one CTA of two warps per
// DP block, and after every step's __syncthreads each column thread
// looped over all 28-38 slots, 4,096 dependent steps of ~1,600 cycles
// (3.792 ms alone on the 2 MiB segment, 26x the bound, on an H100 80GB
// HBM3 at 700 W).
//
// This design takes the slots out of the step. The step depends on the
// slots only through cost_i: with no int32 wrap, column c's winner is
// cost_i + copyq[c] + min cs_s over the live slots (len >= 2) with
// len_s >= c, the tie to the smallest distance. So one CTA per DP block
// is split by role:
//   * the producer warp takes rounds of T = 32 steps, one step a lane.
//     It copies the round after next's slots into shared memory with
//     cp.async (16 bytes a lane, one 128-byte run a slot row); then each
//     lane scatters its step's live slots, as the 64-bit key
//     (cs + 2^31) << 25 | dist, with a min into bucket[len] (a lane owns
//     its step's buckets, so no atomic is needed), and runs the
//     suffix-min from column 63 down to 2 in place, leaving
//     (cs + copyq[c], (c << 25) | dist) per column (payload 0 where no
//     slot reaches). It also leaves the step's literal cost and the
//     interval of cost_i for which no live sum can wrap:
//     cost_i + max(cs_max, cs_max + cq_max) < 2^31 and
//     cost_i + min(cs_min, cs_min + cq_min) >= -2^31, cs over the live
//     slots, cq over columns 2..63;
//   * the consumer warp runs the scan: lane l owns window ring slots l
//     and l + 32, (F, P) in registers; cost_i reaches every lane by one
//     __shfl_sync from the lane that holds column 0, so no barrier and
//     no shared round trip sit on the chain. A step is K3's work: one
//     add, compare and select a column, plus the literal relax.
// The roles meet at one __syncthreads a round, double-buffered. A step
// whose cost_i lies outside its interval runs the first version's exact
// slot loop (out of line: inlined into the 64 unrolled steps it made the
// scan's code too big to run fast) over the raw slots, read from global
// memory where the producer's copy left them in L2 (the shared copy is
// recycled a round earlier); the branch is warp-uniform and chosen per
// step, and the kernel adds the count of such steps to `slow` (0 on real
// data, whose costs stay below ~2^20). The CTA holds 34 KB of shared
// memory plus 512 bytes a slot (48 KB at 28 slots, 53 KB at 38): four to
// an SM.
//
// What bounds this design is dependent instructions, not bytes: the
// producer's per-step work (the slots, then 62 columns of 64-bit
// minima) runs as dependent chains in few warps, two a CTA and four CTAs
// an SM, so the schedulers have little to hide them behind, and the
// consumer's chain waits behind them: with the consumer taken out the
// producer alone takes most of the kernel's time. A second producer
// warp, each lane half the columns but every slot, was slower. On the
// H100 (80GB HBM3, 700 W) this design takes 0.81 ms alone at 28 slots
// and 0.97 at 38 (tools/probe_k78.py).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int W = 64;
constexpr int B = 4096;
constexpr int INF = 1 << 30;
constexpr int MASK25 = (1 << 25) - 1;
constexpr int MAX_SLOTS = 64;
constexpr int T = 32;              // steps a round, one a producer lane
constexpr int TP = T + 1;          // padded: the consumer reads a column
constexpr int NR = B / T;          // rounds a block
constexpr int THREADS = 64;        // warp 0 scans, warp 1 produces
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long NONE = ~0ull;  // above every key

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 wrap like XLA
}

// dynamic shared memory, in this order:
//   bk[2][W][TP] u64   buckets, then (M, pay) int2 in place
//   raw[2][2 * ns][T]  the round's pd rows, then its cs rows
//   lq[2][T] int, thr[2][T] int2, cq[W] int
__host__ __device__ constexpr size_t bucket_bytes() {
  return 2 * (size_t)W * TP * 8;
}
__host__ __device__ inline size_t smem_bytes(int ns) {
  return bucket_bytes() + 2 * 2 * (size_t)ns * T * 4 + 2 * T * 4 +
         2 * T * 8 + W * 4;
}

struct Smem {
  unsigned long long (*bk)[W][TP];
  int* raw;
  int* lq;
  int2* thr;
  int* cq;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int ns) {
  Smem s;
  s.bk = reinterpret_cast<unsigned long long (*)[W][TP]>(base);
  s.raw = reinterpret_cast<int*>(base + bucket_bytes());
  s.lq = s.raw + 2 * 2 * ns * T;
  s.thr = reinterpret_cast<int2*>(s.lq + 2 * T);
  s.cq = reinterpret_cast<int*>(s.thr + 2 * T);
  return s;
}

// the producer's copy of round r's slots into raw stage k: 2 * ns rows
// of 128 bytes, eight lanes a row, one cp.async group a lane
__device__ __forceinline__ void copy_round(const Smem& s, int k, int ns,
                                           const int* pd, const int* cs,
                                           long long n, long long g0,
                                           int lane) {
  int* dst0 = s.raw + k * 2 * ns * T;
  for (int q = lane >> 3; q < 2 * ns; q += 4) {
    const int* src = (q < ns ? pd + (long long)q * n
                             : cs + (long long)(q - ns) * n) +
                     g0 + (lane & 7) * 4;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(
        dst0 + q * T + (lane & 7) * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// producer lane t: step t of the round in stage k
__device__ __forceinline__ void reduce_step(const Smem& s, int k, int ns,
                                            int t, int lqv, int cqmin,
                                            int cqmax) {
  unsigned long long(*bk)[TP] = s.bk[k];
  const int* rp = s.raw + k * 2 * ns * T;
#pragma unroll
  for (int c = 2; c < W; ++c) bk[c][t] = NONE;
  int csmin = INT_MAX, csmax = INT_MIN;
#pragma unroll 4
  for (int e = 0; e < ns; ++e) {
    const int v = rp[e * T + t];
    const int w = rp[(ns + e) * T + t];
    const int ls = v >> 25;  // <= 63 always
    if (ls >= 2) {
      const unsigned long long key =
          ((unsigned long long)((unsigned)w ^ 0x80000000u) << 25) |
          (unsigned)(v & MASK25);
      csmin = min(csmin, w);
      csmax = max(csmax, w);
      unsigned long long* b = &bk[ls][t];
      if (key < *b) *b = key;
    }
  }
  unsigned long long run = NONE;
#pragma unroll
  for (int c = W - 1; c >= 2; --c) {
    const unsigned long long x = bk[c][t];
    run = x < run ? x : run;
    int2 e = make_int2(0, 0);  // payload 0: no slot reaches c
    if (run != NONE)
      e = make_int2(add32((int)((unsigned)(run >> 25) ^ 0x80000000u),
                          s.cq[c]),
                    (c << 25) | (int)(run & MASK25));
    *reinterpret_cast<int2*>(&bk[c][t]) = e;
  }
  int lo = INT_MIN, hi = INT_MAX;  // no live slot: every cost_i exact
  if (csmin <= csmax) {
    const long long top = max((long long)csmax, (long long)csmax + cqmax);
    const long long bot = min((long long)csmin, (long long)csmin + cqmin);
    const long long hi64 = (long long)INT_MAX - top;
    const long long lo64 = (long long)INT_MIN - bot;
    if (lo64 > hi64 || lo64 > INT_MAX) {
      lo = INT_MAX;  // empty: no cost_i passes
      hi = INT_MIN;
    } else {
      lo = (int)max(lo64, (long long)INT_MIN);
      hi = (int)min(hi64, (long long)INT_MAX);
    }
  }
  s.lq[k * T + t] = lqv;
  s.thr[k * T + t] = make_int2(lo, hi);
}

// the first version's step for one column, over the raw slots of
// position g (global memory)
__device__ __forceinline__ void exact_column(int c, int& F, int& P, int cost,
                                             const int* pd, const int* cs,
                                             long long n, long long g,
                                             int ns, const int* scq) {
  if (c < 2) return;
  const int cqc = scq[c];
  int best = INF, bpay = 0x7FFFFFFF;
  for (int e = 0; e < ns; ++e) {
    const int v = __ldg(pd + (long long)e * n + g);
    if (c <= (v >> 25)) {
      const int val = add32(add32(cost, __ldg(cs + (long long)e * n + g)),
                            cqc);
      const int pay = (c << 25) | (v & MASK25);
      if (val < best || (val == best && pay < bpay)) {
        best = val;
        bpay = pay;
      }
    }
  }
  // best starts at INF and F <= INF always, so a column no slot
  // reaches (or reaches only at INF and above) never updates
  if (best < F) {
    F = best;
    P = bpay;
  }
}

// the exact path of a step whose sums may wrap, for both columns of a
// consumer lane: (Flo, Plo, Fhi, Phi) in and out
__device__ __noinline__ int4 exact_step(int4 st, int clo, int chi, int cost,
                                        const int* pd, const int* cs,
                                        long long n, long long g, int ns,
                                        const int* scq) {
  exact_column(clo, st.x, st.y, cost, pd, cs, n, g, ns, scq);
  exact_column(chi, st.z, st.w, cost, pd, cs, n, g, ns, scq);
  return st;
}

struct Scan {
  int Flo, Plo, Fhi, Phi, slow;
};

// the consumer's round r, H = r mod 2: step i = 32r + t is column 0 of
// ring slot 32H + t, held by lane t
template <int H>
__device__ __forceinline__ void scan_round(const Smem& s, int r, int lane,
                                           Scan& z, int* prow,
                                           const int* pd, const int* cs,
                                           long long n, long long base,
                                           int ns) {
  const unsigned long long(*bk)[TP] = s.bk[H];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int i = r * T + t;
    const int clo = (lane - 32 * H - t) & (W - 1);
    const int chi = (lane + 32 - 32 * H - t) & (W - 1);
    const int cost = __shfl_sync(FULL, H ? z.Fhi : z.Flo, t);
    if (lane == t) {  // column 0: publish, then the shift
      prow[i] = H ? z.Phi : z.Plo;
      if (H) {
        z.Fhi = INF;
        z.Phi = 0;
      } else {
        z.Flo = INF;
        z.Plo = 0;
      }
    }
    const int lv = add32(cost, s.lq[H * T + t]);
    if (clo == 1 && lv < z.Flo) {
      z.Flo = lv;
      z.Plo = 0;
    }
    if (chi == 1 && lv < z.Fhi) {
      z.Fhi = lv;
      z.Phi = 0;
    }
    const int2 th = s.thr[H * T + t];
    if (cost >= th.x && cost <= th.y) {
      if (clo >= 2) {
        const int2 e = *reinterpret_cast<const int2*>(&bk[clo][t]);
        const int v = add32(cost, e.x);
        if (e.y != 0 && v < z.Flo) {
          z.Flo = v;
          z.Plo = e.y;
        }
      }
      if (chi >= 2) {
        const int2 e = *reinterpret_cast<const int2*>(&bk[chi][t]);
        const int v = add32(cost, e.x);
        if (e.y != 0 && v < z.Fhi) {
          z.Fhi = v;
          z.Phi = e.y;
        }
      }
    } else {
      ++z.slow;
      const int4 st = exact_step(make_int4(z.Flo, z.Plo, z.Fhi, z.Phi), clo,
                                 chi, cost, pd, cs, n, base + i, ns, s.cq);
      z.Flo = st.x;
      z.Plo = st.y;
      z.Fhi = st.z;
      z.Phi = st.w;
    }
  }
}

// one round of both roles, then the round's barrier: the consumer scans
// round r from stage H while the producer fills stage 1 - H with round
// r + 1, after queueing round r + 2's copy into the raw stage round r
// left
template <int H>
__device__ __forceinline__ void round_both(const Smem& s, int r, int warp,
                                           int lane, Scan& z, int* prow,
                                           const int* pd, const int* cs,
                                           const int* litq, long long n,
                                           long long base, int ns,
                                           int cqmin, int cqmax) {
  if (warp == 0) {
    scan_round<H>(s, r, lane, z, prow, pd, cs, n, base, ns);
  } else if (r + 1 < NR) {
    const int lqv = __ldg(litq + base + (r + 1) * T + lane);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    if (r + 2 < NR)
      copy_round(s, H, ns, pd, cs, n, base + (r + 2) * T, lane);
    reduce_step(s, 1 - H, ns, lane, lqv, cqmin, cqmax);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
dp_scan_v1_kernel(const int* __restrict__ pd, const int* __restrict__ cs,
                  const int* __restrict__ litq, const int* __restrict__ cq,
                  int* __restrict__ paymat, int* __restrict__ slow_count,
                  int ns, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, ns);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * B;
  int* prow = paymat + (long long)blockIdx.x * (B + 1);
  s.cq[threadIdx.x] = __ldg(cq + threadIdx.x);  // THREADS == W
  __syncthreads();
  int cqmin = INT_MAX, cqmax = INT_MIN;
  if (warp == 1) {
    for (int c = 2; c < W; ++c) {
      cqmin = min(cqmin, s.cq[c]);
      cqmax = max(cqmax, s.cq[c]);
    }
    const int lqv = __ldg(litq + base + lane);
    copy_round(s, 0, ns, pd, cs, n, base, lane);
    copy_round(s, 1, ns, pd, cs, n, base + T, lane);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    reduce_step(s, 0, ns, lane, lqv, cqmin, cqmax);
  }
  __syncthreads();
  Scan z{(lane == 0) ? 0 : INF, 0, INF, 0, 0};
  for (int r = 0; r < NR; r += 2) {
    round_both<0>(s, r, warp, lane, z, prow, pd, cs, litq, n, base, ns,
                  cqmin, cqmax);
    round_both<1>(s, r + 1, warp, lane, z, prow, pd, cs, litq, n, base, ns,
                  cqmin, cqmax);
  }
  if (warp == 0 && lane == 0) {
    prow[B] = z.Plo;  // column 0 after the end: ring slot B mod W = 0
    if (z.slow) atomicAdd(slow_count, z.slow);
  }
}

}  // namespace

extern "C" int btt_dp_scan_v1(const int* pd, const int* cs, const int* litq,
                              const int* cq, int* paymat, int* slow_count,
                              int nslots, int nb, cudaStream_t stream) {
  if (nb <= 0 || nslots < 1 || nslots > MAX_SLOTS) return -1;
  const size_t bytes = smem_bytes(nslots);
  cudaError_t err = cudaFuncSetAttribute(
      dp_scan_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dp_scan_v1_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dp_scan_v1_kernel<<<nb, THREADS, bytes, stream>>>(
      pd, cs, litq, cq, paymat, slow_count, nslots, (long long)nb * B);
  return (int)cudaGetLastError();
}
