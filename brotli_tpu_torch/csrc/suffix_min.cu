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
// (0.97 GB) and writes 2.15 GB. The first design looped every slot for
// every (position, column): 29 x 64 compare-selects a position, which
// made it issue-bound at a quarter of its byte bound. This one does
// 29 + 64 steps a position, the same function:
//   1. each non-dictionary slot with 2 <= len and cost < INF becomes the
//      64-bit key (cost, slot << 25 | dist), ordered as the strict < in
//      slot order orders it, and is scattered with a min into
//      bucket[len] (len <= 63 always: it is pd >> 25);
//   2. one suffix-min over the buckets from column 63 down to 2 gives
//      every column the best slot that reaches it; columns 0, 1 get none;
//   3. the dictionary slot's key folds into its one column c == len;
//   4. M = cost + copyq[c] (int32 wrap), P = (c << 25) | dist, decoded
//      from the key.
// A block stages a tile of 64 positions' slots in shared memory with
// coalesced loads (stride MAXS + 1: conflict-free both ways). Then one
// warp takes one position: lane s holds slots s and s + 32 (the second
// only above 32 slots: the 16-byte level makes 39) and does a shared
// 64-bit atomicMin into the warp's 64 buckets; lane l holds columns 2l,
// 2l+1 and runs a 5-step shuffle suffix scan; the warp stores the
// 512-byte row as two 256-byte runs. Offsets into the (n, 2W) output are
// 64-bit. The kernel is built for at most 32 slots and for at most 64;
// the launch takes the smaller that fits (the wider one stages twice
// the shared memory).

#include <cuda_runtime.h>

namespace {

constexpr int W = 64;
constexpr int TILE = 64;       // positions per block
constexpr int THREADS = 256;   // 8 warps, one position each at a time
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLOTS = 64;
constexpr int INF = 1 << 28;
constexpr int NO_EDGE = 1 << 29;
constexpr int MASK25 = (1 << 25) - 1;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr long long NONE = (long long)INF << 32;  // above every live key

__device__ __forceinline__ long long make_key(int cost, int slot, int v) {
  return (long long)(((unsigned long long)(unsigned)cost << 32) |
                     (unsigned)((slot << 25) | (v & MASK25)));
}

__device__ __forceinline__ long long kmin(long long a, long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ int2 decode(long long k, int c, int cqc) {
  const int cost = (int)(k >> 32);
  if (cost >= INF) return make_int2(NO_EDGE, 0);
  // int32 wrap-around like the JAX code (unsigned add)
  return make_int2((int)((unsigned)cost + (unsigned)cqc),
                   (c << 25) | ((int)k & MASK25));
}

template <int MAXS>
__global__ void __launch_bounds__(THREADS)
suffix_min_kernel(const int* __restrict__ pd, const int* __restrict__ cs,
                  const int* __restrict__ cq, int* __restrict__ out,
                  int nslots, long long n) {
  constexpr int STRIDE = MAXS + 1;
  __shared__ int spd[TILE * STRIDE];
  __shared__ int scs[TILE * STRIDE];
  __shared__ __align__(16) long long bucket[WARPS][W];
  const long long base = (long long)blockIdx.x * TILE;
  for (int k = threadIdx.x; k < nslots * TILE; k += THREADS) {
    const int s = k / TILE, p = k % TILE;
    const long long gp = base + p;
    int v = 0, c = INF;  // reaches no column
    if (gp < n) {
      v = __ldg(pd + (long long)s * n + gp);
      c = __ldg(cs + (long long)s * n + gp);
    }
    spd[p * STRIDE + s] = v;
    scs[p * STRIDE + s] = c;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dslot = nslots - 2;
  const int c0 = 2 * lane, c1 = 2 * lane + 1;
  const int cq0 = __ldg(cq + c0), cq1 = __ldg(cq + c1);
  longlong2* bk2 = reinterpret_cast<longlong2*>(bucket[warp]);
  for (int p = warp; p < TILE; p += WARPS) {
    const long long gp = base + p;
    if (gp >= n) break;
    bk2[lane] = make_longlong2(NONE, NONE);
    __syncwarp();
    long long dkey = NONE;
    int dlen = -1;
#pragma unroll
    for (int h = 0; h < MAXS / 32; ++h) {
      const int s = lane + 32 * h;
      if (s < nslots) {
        const int v = spd[p * STRIDE + s];
        const int cost = scs[p * STRIDE + s];
        const int len = v >> 25;
        if (cost < INF && len >= 2) {
          const long long key = make_key(cost, s, v);
          if (s == dslot) {
            dkey = key;
            dlen = len;
          } else {
            atomicMin(&bucket[warp][len], key);
          }
        }
      }
    }
    __syncwarp();
    const longlong2 b = bk2[lane];
    // inclusive suffix-min over lanes of the pair minimum, then the
    // exclusive carry from the lanes above
    long long x = kmin(b.x, b.y);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long t = __shfl_down_sync(FULL, x, d);
      if (lane + d < 32) x = kmin(x, t);
    }
    long long above = __shfl_down_sync(FULL, x, 1);
    if (lane == 31) above = NONE;
    long long k1 = kmin(b.y, above);
    long long k0 = kmin(b.x, k1);
    if (lane == 0) k0 = k1 = NONE;  // columns 0 and 1 take no slot
    // the dictionary slot relaxes only its exact length
    const long long dk = __shfl_sync(FULL, dkey, dslot & 31);
    const int dl = __shfl_sync(FULL, dlen, dslot & 31);
    if (dl == c0) k0 = kmin(k0, dk);
    if (dl == c1) k1 = kmin(k1, dk);
    const int2 e0 = decode(k0, c0, cq0), e1 = decode(k1, c1, cq1);
    int* row = out + gp * (2 * W);
    reinterpret_cast<int2*>(row)[lane] = make_int2(e0.x, e1.x);
    reinterpret_cast<int2*>(row + W)[lane] = make_int2(e0.y, e1.y);
    __syncwarp();
  }
}

}  // namespace

extern "C" int btt_suffix_min(const int* pd, const int* cs, const int* cq,
                              int* out, int nslots, long long n,
                              cudaStream_t stream) {
  if (nslots < 2 || nslots > MAX_SLOTS || n <= 0) return -1;
  const long long blocks = (n + TILE - 1) / TILE;
  if (nslots <= 32) {
    suffix_min_kernel<32><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pd, cs, cq, out, nslots, n);
  } else {
    suffix_min_kernel<MAX_SLOTS><<<(unsigned)blocks, THREADS, 0, stream>>>(
        pd, cs, cq, out, nslots, n);
  }
  return (int)cudaGetLastError();
}
