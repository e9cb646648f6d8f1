// K3: the DP wavefront scan of every DP block.
//
// K3 (dp_scan_kernel) replaces the default branch of
// brotli_tpu/ops/optimal_jax.py::_scan_math_v3, a lax.scan over the B
// in-block positions with the blocks as the vector axis. Per step i,
// with F/P the (cost, payload) of window columns 0..W-1 (column c is
// position i + c):
//   1. cost_i = F[0]; the final payload of position i is P[0];
//   2. literal relax into column 1 (strict <, before the matches, so a
//      literal beats a match on ties);
//   3. min-merge cost_i + M[c] into F[c] (strict <), payload PY[c];
//   4. shift the window by one (new column W-1 = (1<<30, 0)).
// Output: paymat (nb, B + 1) int32, the payloads of positions 0..B.
//
// Bound: bytes, and the 4096 dependent steps of each block. The scan
// reads the (n, 2W) int32 rows of K1 once (2.15 GB per 4 MiB segment)
// plus the literal costs and writes paymat (both 17 MB). Design: one
// block of W threads per DP block. The window is a ring, not a shift:
// thread j owns ring slot j for the whole scan, keeping its (F, P) in
// registers; at step i it is column (j - i) mod W. The owner of column 0
// publishes cost_i through shared memory (double-buffered, so one
// __syncthreads per step suffices). Each thread loads its column of the
// next rows U steps ahead into registers, double-buffered, so the row
// stream overlaps the dependent chain.
//
// K4, the backtrack that reads paymat, is dp_backtrack.cu.

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int B = 4096;
constexpr int INF = 1 << 30;
constexpr int U = 8;  // rows prefetched per buffer

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

__device__ __forceinline__ void run_steps(const Rows& r, int& F, int& P,
                                          int* bcast, int* prow, int j,
                                          int i0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = i0 + u;
    const int c = (j - i) & (W - 1);
    if (c == 0) {
      bcast[i & 1] = F;
      prow[i] = P;
    }
    __syncthreads();
    const int cost = bcast[i & 1];
    if (c == 1) {
      const int lv = add32(cost, r.lq[u]);
      if (lv < F) {
        F = lv;
        P = 0;
      }
    }
    const int mv = add32(cost, r.m[u]);
    if (mv < F) {
      F = mv;
      P = r.py[u];
    }
    if (c == 0) {  // the shift: this slot becomes column W-1
      F = INF;
      P = 0;
    }
  }
}

__global__ void __launch_bounds__(W)
dp_scan_kernel(const int* __restrict__ mp, const int* __restrict__ litq,
               int* __restrict__ paymat) {
  __shared__ int bcast[2];
  const int j = threadIdx.x;
  const long long blk = blockIdx.x;
  const int* rows = mp + blk * B * (2 * W);
  const int* lq = litq + blk * B;
  int* prow = paymat + blk * (B + 1);
  int F = (j == 0) ? 0 : INF;
  int P = 0;
  Rows r0, r1;
  load_rows(r0, rows, lq, j, 0);
  for (int i0 = 0; i0 < B; i0 += 2 * U) {
    load_rows(r1, rows, lq, j, i0 + U);
    run_steps(r0, F, P, bcast, prow, j, i0);
    if (i0 + 2 * U < B) load_rows(r0, rows, lq, j, i0 + 2 * U);
    run_steps(r1, F, P, bcast, prow, j, i0 + U);
  }
  if (((j - B) & (W - 1)) == 0) prow[B] = P;  // column 0 after the end
}

}  // namespace

extern "C" int btt_dp_scan(const int* mp, const int* litq, int* paymat,
                           int nb, cudaStream_t stream) {
  if (nb <= 0) return -1;
  dp_scan_kernel<<<nb, W, 0, stream>>>(mp, litq, paymat);
  return (int)cudaGetLastError();
}
