// K1: suffix-min pre-reduction of the DP edge slots.
//
// Replaces brotli_tpu/ops/optimal_jax.py::_suffix_kernel (launched by
// _suffix_pallas). For every position p and window column c < W:
//   M[p][c] = min over slots s with lo_s <= c <= len_s of cost_s, plus
//             copyq[c]; 1<<29 when no slot reaches c,
//   P[p][c] = (c << 25) | dist of the argmin slot; 0 when none,
// with a strict < in slot order (the lowest slot wins ties), lo_s = 2,
// except the dictionary slot nslots-2, which is atomic: lo = len.
//
// Layout: the output is position-major, (n, 2W) int32 rows [M | P], so
// the scan (dp_scan.cu) reads one contiguous 512-byte row per step. The
// TPU kernel wrote (2W, n) and transposed afterwards; no transpose here.
//
// Bound: bytes. Per 4 MiB segment it reads the 29 (pd, cost) slot rows
// (0.97 GB) and writes 2.15 GB; the work is ~nslots * W compare-selects
// per position. Design: one block takes a tile of 64 positions; its
// threads stage the tile's slots, pre-decoded as {lo, len, cost, dist},
// in shared memory with coalesced loads, then each thread owns one
// window column of a position and loops the slots out of shared memory
// (every thread of a warp reads the same slot entry: a broadcast). A
// warp stores 32 consecutive ints of a row, so the 2 GB write is fully
// coalesced. Offsets into the (n, 2W) output are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int TILE = 64;       // positions per block
constexpr int THREADS = 256;   // 4 position lanes x W columns
constexpr int MAX_SLOTS = 32;
constexpr int INF = 1 << 28;
constexpr int NO_EDGE = 1 << 29;
constexpr int BIGD = 0x7FFFFFFF;
constexpr int MASK25 = (1 << 25) - 1;

__global__ void __launch_bounds__(THREADS)
suffix_min_kernel(const int* __restrict__ pd, const int* __restrict__ cs,
                  const int* __restrict__ cq, int* __restrict__ out,
                  int nslots, long long n) {
  __shared__ int4 edge[MAX_SLOTS][TILE];  // {lo, len, cost, dist}
  const long long base = (long long)blockIdx.x * TILE;
  for (int k = threadIdx.x; k < nslots * TILE; k += THREADS) {
    const int s = k / TILE, p = k % TILE;
    const long long gp = base + p;
    int4 e = make_int4(2, 0, INF, 0);  // reaches no column
    if (gp < n) {
      const int v = pd[(long long)s * n + gp];
      const int len = v >> 25;
      const int lo = (s == nslots - 2) ? max(len, 2) : 2;
      e = make_int4(lo, len, cs[(long long)s * n + gp], v & MASK25);
    }
    edge[s][p] = e;
  }
  __syncthreads();
  const int c = threadIdx.x % W;
  const int cqc = cq[c];
  for (int p = threadIdx.x / W; p < TILE; p += THREADS / W) {
    const long long gp = base + p;
    if (gp >= n) break;
    int acc = INF, pay = BIGD;
    for (int s = 0; s < nslots; ++s) {
      const int4 e = edge[s][p];
      const int v = (c <= e.y && c >= e.x) ? e.z : INF;
      if (v < acc) {
        acc = v;
        pay = e.w;
      }
    }
    // int32 wrap-around like the JAX code (unsigned add)
    out[gp * (2 * W) + c] =
        acc < INF ? (int)((unsigned)acc + (unsigned)cqc) : NO_EDGE;
    out[gp * (2 * W) + W + c] = pay != BIGD ? ((c << 25) | pay) : 0;
  }
}

}  // namespace

extern "C" int btt_suffix_min(const int* pd, const int* cs, const int* cq,
                              int* out, int nslots, long long n,
                              cudaStream_t stream) {
  if (nslots < 2 || nslots > MAX_SLOTS || n <= 0) return -1;
  const long long blocks = (n + TILE - 1) / TILE;
  suffix_min_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      pd, cs, cq, out, nslots, n);
  return (int)cudaGetLastError();
}
