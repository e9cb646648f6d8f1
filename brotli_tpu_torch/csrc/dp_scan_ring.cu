// K8: the DP wavefront with the path's last distance carried in the scan.
//
// Replaces the path-ring branch of
// brotli_tpu/ops/optimal_jax.py::_scan_math_v3 (BROTLI_TPU_RING_SCAN=1),
// a lax.scan over the B in-block positions with the blocks as the vector
// axis. It is K3 (dp_scan.cu) plus R, the ring[0] (last distance) of the
// best path into each window column. Per step i, with cost_i = F[0] and
// ring_i = R[0]:
//   1. the final payload of position i is P[0];
//   2. literal relax into column 1 (strict <; payload 0, R = ring_i);
//   3. the ring edge: where ring_i > 0 and src = pos - ring_i >= 0 (src
//      may lie in an earlier DP block, never before the segment), its
//      length is the count of equal leading bytes of the 16 at pos and
//      at src, the segment's bytes read cyclically (the JAX code builds
//      them with jnp.roll, so the last positions compare against the
//      segment's head), capped at B - i and at max(npos + 3 - pos, 0);
//      columns 2..len relax at cost_i + rw[c] (strict <; P = c << 25 |
//      ring_i, R = ring_i), rw[c] = min(ring_cost + copyq[c], icell[c])
//      with the implicit-cell row, else min(ring_cost + copyq[c], 1<<28);
//   4. min-merge cost_i + M[c] into F[c] (strict <), P = PY[c], R =
//      PY[c] & (2^25 - 1);
//   5. shift the window (new column W-1 = (1<<30, 0, 0)).
// R starts at ring_init[block] in every column. Output: paymat (nb, B+1)
// int32. Sums are int32 with wrap-around, like XLA's.
//
// Bound: bytes, as K3: the (n, 2W) rows of K1 (2.15 GB per 4 MiB
// segment) read once, plus the literal costs, the segment's bytes and
// paymat. The first version was K3 with the ring edge's compare
// on the chain: after each step's barrier, 16 lanes read the bytes at
// pos and pos - ring_i from global memory and a ballot found the first
// mismatch, one dependent memory round trip a step, 1.640 ms alone on
// the 4 MiB segment against K3's 0.752 (H100 80GB HBM3, 700 W).
//
// This design keeps K3's (one CTA of W threads per DP block, thread j
// owning window ring slot j with its (F, P, R) in registers, the rows
// prefetched U steps ahead, one __syncthreads a step) and moves the
// compare one step ahead. ring_{i+1} is R of column 1 after step i, and
// step i changes that R only by the literal relax (to ring_i) or by the
// rows' merge (to PY_i[1] & MASK25, which K1 never sets: no slot reaches
// column 1). So ring_{i+1} is ring_i, or R1, the R column 1 held before
// step i, or (never on K1's rows) a row's payload. The owner of column 1
// publishes R1 beside (cost_i, ring_i); right after the barrier every
// warp takes the lengths of step i's two candidates from one ballot of
// the bytes it loaded a step ago, then queues the compares of position
// i + 1 against R1 and ring_i (lanes 0..15 and 16..31, one byte each:
// the block's own bytes from shared memory, the source's from global
// memory, left in registers), and only then picks step i's length by
// ring_i. A ring that is neither (and is live: ring > 0, src >= 0) is
// compared on the chain as before, and the kernel adds the count of
// those steps to `slow`. Rows are loaded with an evict-first hint, and
// positions are 32-bit (n < 2^31).
//
// What bounds it: the chain between two barriers. Clock stamps of
// thread 0 on the H100 show K8's step at more than twice K3's: the
// source loads queue behind K1's row stream (they stall before leaving
// the warp, and the ballot after the barrier waits for them), and the
// pick and the relax of the ring edge add dependent work that K3 has
// not. Designs that
// took the compare further from the chain were slower still: comparing
// two steps ahead against four candidates (R1, R2, ring_i, PY_i[2]),
// and a four-step look-ahead with 32-byte masks carried by the columns,
// which left the chain compare to very few steps but added more
// bookkeeping to every step than the wait it removed. This design takes
// 1.45 ms alone on the 4 MiB segment (H100 80GB HBM3, 700 W;
// tools/probe_k78.py).

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int B = 4096;
constexpr int INF = 1 << 30;
constexpr int EDGE_INF = 1 << 28;
constexpr int MASK25 = (1 << 25) - 1;
constexpr int U = 8;       // rows prefetched per buffer
constexpr int CMP = 16;    // bytes a ring edge compares
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 wrap like XLA
}

struct Rows {
  int m[U], py[U], lq[U];
};

__device__ __forceinline__ void load_rows(Rows& r, const int* rows,
                                          const int* lq, int j, int i0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u;
    const int c = (j - i) & (W - 1);
    const int* row = rows + (long long)i * (2 * W);
    r.m[u] = __ldcs(row + c);  // streamed once: evict first
    r.py[u] = __ldcs(row + W + c);
    r.lq[u] = __ldg(lq + i);
  }
}

struct Seg {
  const unsigned char* data;
  const unsigned char* own;  // shared: the block's bytes base..
  int n, npos, base;
};

__device__ __forceinline__ int wrap(int a, int n) {
  return a >= n ? a - n : a;
}

// whether the ring edge of in-block step i with distance ring compares
// any byte (ring > 0 and src >= 0)
__device__ __forceinline__ bool live_ring(const Seg& g, int i, int ring) {
  return ring > 0 && g.base + i - ring >= 0;
}

// the caps: the block's end and max(npos + 3 - pos, 0)
__device__ __forceinline__ int cap_len(const Seg& g, int i, int rl) {
  rl = min(rl, B - i);
  const int room = g.npos + 3 - (g.base + i);
  return room < rl ? max(room, 0) : rl;
}

// the equal leading bytes of the 16 at pos and pos - ring, capped, on
// the chain (every lane of the warp with the same (i, ring))
__device__ __forceinline__ int chain_len(const Seg& g, int i, int ring) {
  if (!live_ring(g, i, ring)) return 0;
  const int lane = threadIdx.x & 31;
  bool diff = false;
  if (lane < CMP)
    diff = g.own[i + lane] !=
           __ldg(g.data + wrap(g.base + i - ring + lane, g.n));
  return cap_len(g, i, __ffs(__ballot_sync(FULL, diff) | (1u << CMP)) - 1);
}

// two candidate distances of one step's ring (lanes 0..15 compare the
// first, lanes 16..31 the second, one byte each) and this lane's pair of
// loaded bytes
struct Ahead {
  int a, b;
  unsigned char own, src;
};

// queue the compares of in-block step i against the candidates
__device__ __forceinline__ void queue_compare(Ahead& x, const Seg& g,
                                              int i) {
  const int lane = threadIdx.x & 31;
  const int d = lane < CMP ? x.a : x.b;
  x.own = x.src = 0;
  if (live_ring(g, i, d)) {
    const int k = lane & (CMP - 1);
    x.own = g.own[i + k];
    x.src = __ldg(g.data + wrap(g.base + i - d + k, g.n));
  }
}

__device__ __forceinline__ void run_steps(const Rows& r, int& F, int& P,
                                          int& R, int4* bcast, int* prow,
                                          const int* rw, const Seg& g,
                                          Ahead& ah, int& slow, int j,
                                          int i0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u;
    const int c = (j - i) & (W - 1);
    const int rwc = rw[c];
    if (c == 0) {
      bcast[i & 1].x = F;
      bcast[i & 1].y = R;
      prow[i] = P;
    }
    if (c == 1) bcast[i & 1].z = R;  // R1: a candidate of ring_{i+1}
    __syncthreads();
    const int4 cr = bcast[i & 1];
    const int cost = cr.x, ring = cr.y;
    // step i's two lengths from the bytes loaded a step ago, then the
    // next step's compares, then the pick
    const unsigned m = __ballot_sync(FULL, ah.own != ah.src);
    const int la = __ffs((m & 0xFFFFu) | (1u << CMP)) - 1;
    const int lb = __ffs((m >> CMP) | (1u << CMP)) - 1;
    const int da = ah.a, db = ah.b;
    ah.a = cr.z;
    ah.b = ring;
    queue_compare(ah, g, i + 1);
    int rl;
    if (!live_ring(g, i, ring)) {
      rl = 0;
    } else if (ring == da) {
      rl = cap_len(g, i, la);
    } else if (ring == db) {
      rl = cap_len(g, i, lb);
    } else {
      if (j == 0) ++slow;
      rl = chain_len(g, i, ring);
    }
    if (c == 1) {
      const int lv = add32(cost, r.lq[u]);
      if (lv < F) {
        F = lv;
        P = 0;
        R = ring;
      }
    }
    if (c >= 2 && c <= rl) {
      const int rv = add32(cost, rwc);
      if (rv < F) {
        F = rv;
        P = (c << 25) | ring;
        R = ring;
      }
    }
    const int mv = add32(cost, r.m[u]);
    if (mv < F) {
      F = mv;
      P = r.py[u];
      R = r.py[u] & MASK25;
    }
    if (c == 0) {  // the shift: this slot becomes column W-1
      F = INF;
      P = 0;
      R = 0;
    }
  }
}

__global__ void __launch_bounds__(W)
dp_scan_ring_kernel(const int* __restrict__ mp, const int* __restrict__ litq,
                    const unsigned char* __restrict__ data,
                    const int* __restrict__ ring_init,
                    const int* __restrict__ ring_cost,
                    const int* __restrict__ cq, const int* __restrict__ icell,
                    int* __restrict__ paymat, int* __restrict__ slow_count,
                    int n, int npos) {
  __shared__ int4 bcast[2];
  __shared__ int rw[W];
  __shared__ unsigned char own[B + CMP];
  const int j = threadIdx.x;
  const int blk = blockIdx.x;
  const int* rows = mp + (long long)blk * B * (2 * W);
  const int* lq = litq + (long long)blk * B;
  int* prow = paymat + (long long)blk * (B + 1);
  const Seg g{data, own, n, npos, blk * B};
  rw[j] = min(add32(__ldg(ring_cost), __ldg(cq + j)),
              icell ? __ldg(icell + j) : EDGE_INF);
  for (int x = j; x < B + CMP; x += W)
    own[x] = __ldg(data + wrap(g.base + x, n));
  int F = (j == 0) ? 0 : INF;
  int P = 0;
  int R = __ldg(ring_init + blk);
  Rows r0, r1;
  load_rows(r0, rows, lq, j, 0);
  __syncthreads();
  // step 0's ring is ring_init, the candidate of both halves
  Ahead ah{R, R, 0, 0};
  queue_compare(ah, g, 0);
  int slow = 0;
  for (int i0 = 0; i0 < B; i0 += 2 * U) {
    load_rows(r1, rows, lq, j, i0 + U);
    run_steps(r0, F, P, R, bcast, prow, rw, g, ah, slow, j, i0);
    if (i0 + 2 * U < B) load_rows(r0, rows, lq, j, i0 + 2 * U);
    run_steps(r1, F, P, R, bcast, prow, rw, g, ah, slow, j, i0 + U);
  }
  if (((j - B) & (W - 1)) == 0) prow[B] = P;  // column 0 after the end
  if (j == 0 && slow) atomicAdd(slow_count, slow);
}

}  // namespace

extern "C" int btt_dp_scan_ring(const int* mp, const int* litq,
                                const unsigned char* data,
                                const int* ring_init, const int* ring_cost,
                                const int* cq, const int* icell, int* paymat,
                                int* slow_count, int nb, long long npos,
                                cudaStream_t stream) {
  if (nb <= 0 || (long long)nb * B >= (1LL << 31) || npos < 0 ||
      npos >= (1LL << 31) - 4)
    return -1;
  dp_scan_ring_kernel<<<nb, W, 0, stream>>>(mp, litq, data, ring_init,
                                            ring_cost, cq, icell, paymat,
                                            slow_count, nb * B, (int)npos);
  return (int)cudaGetLastError();
}
