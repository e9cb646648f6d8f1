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
// paymat. Design: K3's, one block of W threads per DP block, thread j
// owning window ring slot j with its (F, P, R) in registers and the rows
// prefetched U steps ahead. The owner of column 0 publishes (cost_i,
// ring_i) through a double-buffered shared pair, one __syncthreads a
// step. The ring edge's length costs each step one dependent read of
// the segment's bytes (the distance is path state, known only after the
// step's publish): in each of the two warps, lanes 0..15 compare one
// byte each and a ballot gives the first mismatch, so no second barrier
// is needed. The segment (4 MiB) stays in L2.

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int B = 4096;
constexpr int INF = 1 << 30;
constexpr int EDGE_INF = 1 << 28;
constexpr int MASK25 = (1 << 25) - 1;
constexpr int U = 8;  // rows prefetched per buffer
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
    r.m[u] = __ldg(row + c);
    r.py[u] = __ldg(row + W + c);
    r.lq[u] = __ldg(lq + i);
  }
}

struct Seg {
  const unsigned char* data;
  long long n, npos, base;
};

// the ring edge's length at in-block step i: equal leading bytes of the
// 16 at pos and at pos - ring, capped. Called by every lane of a warp
// with the same (i, ring).
__device__ __forceinline__ int ring_len(const Seg& g, int i, int ring) {
  const long long pos = g.base + i;
  const long long src = pos - ring;
  if (ring <= 0 || src < 0) return 0;
  const int lane = threadIdx.x & 31;
  bool diff = false;
  if (lane < 16) {
    long long a = pos + lane, b = src + lane;
    if (a >= g.n) a -= g.n;
    if (b >= g.n) b -= g.n;
    diff = __ldg(g.data + a) != __ldg(g.data + b);
  }
  int rl = __ffs(__ballot_sync(FULL, diff) | (1u << 16)) - 1;
  rl = min(rl, B - i);
  const long long room = g.npos + 3 - pos;
  return room < rl ? (room > 0 ? (int)room : 0) : rl;
}

__device__ __forceinline__ void run_steps(const Rows& r, int& F, int& P,
                                          int& R, int2* bcast, int* prow,
                                          const int* rw, const Seg& g,
                                          int j, int i0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u;
    const int c = (j - i) & (W - 1);
    if (c == 0) {
      bcast[i & 1] = make_int2(F, R);
      prow[i] = P;
    }
    __syncthreads();
    const int2 cr = bcast[i & 1];
    const int cost = cr.x, ring = cr.y;
    if (c == 1) {
      const int lv = add32(cost, r.lq[u]);
      if (lv < F) {
        F = lv;
        P = 0;
        R = ring;
      }
    }
    const int rl = ring_len(g, i, ring);
    if (c >= 2 && c <= rl) {
      const int rv = add32(cost, rw[c]);
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
                    int* __restrict__ paymat, long long n, long long npos) {
  __shared__ int2 bcast[2];
  __shared__ int rw[W];
  const int j = threadIdx.x;
  const long long blk = blockIdx.x;
  const int* rows = mp + blk * B * (2 * W);
  const int* lq = litq + blk * B;
  int* prow = paymat + blk * (B + 1);
  const Seg g{data, n, npos, blk * B};
  rw[j] = min(add32(__ldg(ring_cost), __ldg(cq + j)),
              icell ? __ldg(icell + j) : EDGE_INF);
  int F = (j == 0) ? 0 : INF;
  int P = 0;
  int R = __ldg(ring_init + blk);
  Rows r0, r1;
  load_rows(r0, rows, lq, j, 0);
  // rw is read only after the first step's __syncthreads
  for (int i0 = 0; i0 < B; i0 += 2 * U) {
    load_rows(r1, rows, lq, j, i0 + U);
    run_steps(r0, F, P, R, bcast, prow, rw, g, j, i0);
    if (i0 + 2 * U < B) load_rows(r0, rows, lq, j, i0 + 2 * U);
    run_steps(r1, F, P, R, bcast, prow, rw, g, j, i0 + U);
  }
  if (((j - B) & (W - 1)) == 0) prow[B] = P;  // column 0 after the end
}

}  // namespace

extern "C" int btt_dp_scan_ring(const int* mp, const int* litq,
                                const unsigned char* data,
                                const int* ring_init, const int* ring_cost,
                                const int* cq, const int* icell, int* paymat,
                                int nb, long long npos, cudaStream_t stream) {
  if (nb <= 0) return -1;
  dp_scan_ring_kernel<<<nb, W, 0, stream>>>(mp, litq, data, ring_init,
                                            ring_cost, cq, icell, paymat,
                                            (long long)nb * B, npos);
  return (int)cudaGetLastError();
}
