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
// Bound: operations. A 2 MiB segment (28 slots, 38 with the 16-byte
// level) reads 470 MB of slots, 0.14 ms at the card's byte rate, but
// asks for n * nslots * W = 3.8 G compare-selects, 0.06 ms at the
// card's int32 peak, in 4096 dependent steps per DP block. Design, the
// structure of K3 (dp_scan.cu): one block of W threads per DP block;
// thread j owns window ring slot j (column (j - i) mod W at step i),
// its (F, P) in registers; the owner of column 0 publishes cost_i
// through a double-buffered shared word, one __syncthreads a step. The
// block stages the next T steps' slots in shared memory with coalesced
// loads (one 128-byte run per slot), and each thread then loops over
// the slots for its column: a broadcast shared load a slot, no bank
// conflict. Simple and exact; a later redesign can pre-reduce the slots
// (the step depends on them only through cost_i) if it keeps the three
// rules and the wrap-around above.

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int B = 4096;
constexpr int INF = 1 << 30;
constexpr int MASK25 = (1 << 25) - 1;
constexpr int MAX_SLOTS = 64;
constexpr int T = 32;  // steps staged per round

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 wrap like XLA
}

__global__ void __launch_bounds__(W)
dp_scan_v1_kernel(const int* __restrict__ pd, const int* __restrict__ cs,
                  const int* __restrict__ litq, const int* __restrict__ cq,
                  int* __restrict__ paymat, int nslots, long long n) {
  __shared__ int spd[MAX_SLOTS][T];
  __shared__ int scs[MAX_SLOTS][T];
  __shared__ int slq[T];
  __shared__ int scq[W];
  __shared__ int bcast[2];
  const int j = threadIdx.x;
  const long long base = (long long)blockIdx.x * B;
  int* prow = paymat + (long long)blockIdx.x * (B + 1);
  scq[j] = __ldg(cq + j);
  int F = (j == 0) ? 0 : INF;
  int P = 0;
  for (int i0 = 0; i0 < B; i0 += T) {
    __syncthreads();  // every read of the previous round is done
    for (int k = j; k < nslots * T; k += W) {
      const int s = k / T, t = k % T;
      const long long g = (long long)s * n + base + i0 + t;
      spd[s][t] = __ldg(pd + g);
      scs[s][t] = __ldg(cs + g);
    }
    if (j < T) slq[j] = __ldg(litq + base + i0 + j);
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const int i = i0 + t;
      const int c = (j - i) & (W - 1);
      if (c == 0) {
        bcast[i & 1] = F;
        prow[i] = P;
      }
      __syncthreads();
      const int cost = bcast[i & 1];
      if (c == 1) {
        const int lv = add32(cost, slq[t]);
        if (lv < F) {
          F = lv;
          P = 0;
        }
      }
      if (c >= 2) {
        const int cqc = scq[c];
        int best = INF, bpay = 0x7FFFFFFF;
#pragma unroll 4
        for (int s = 0; s < nslots; ++s) {
          const int v = spd[s][t];
          if (c <= (v >> 25)) {
            const int val = add32(add32(cost, scs[s][t]), cqc);
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
      if (c == 0) {  // the shift: this slot becomes column W-1
        F = INF;
        P = 0;
      }
    }
  }
  if (((j - B) & (W - 1)) == 0) prow[B] = P;  // column 0 after the end
}

}  // namespace

extern "C" int btt_dp_scan_v1(const int* pd, const int* cs, const int* litq,
                              const int* cq, int* paymat, int nslots,
                              int nb, cudaStream_t stream) {
  if (nb <= 0 || nslots < 1 || nslots > MAX_SLOTS) return -1;
  dp_scan_v1_kernel<<<nb, W, 0, stream>>>(pd, cs, litq, cq, paymat, nslots,
                                          (long long)nb * B);
  return (int)cudaGetLastError();
}
