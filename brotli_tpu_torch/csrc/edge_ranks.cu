// K10: the rank candidates of one level of a DP segment.
//
// Replaces the rank loop of brotli_tpu/ops/optimal_jax.py::
// _level_candidates and its sorts back to position order: after the
// level's stable sort on K9's keys (lax.sort there, torch.sort here,
// outside the kernel), for every sorted row i and each rank k of the
// level, row i - k is the k-th nearest earlier position sharing the
// level's hash. On the TPU, XLA fuses the 8 word compares of a rank into
// one loop; the port ran ~110 torch launches a rank.
//
// Per sorted row i (key_s[i], position p = order[i]) and rank k:
//   same  = key_s[i] >> 14 == key_s[i - k] >> 14 and key_s[i] < 1 << 31.
//           Rows i < k have no row i - k: _shift_up fills the head of the
//           sorted arrays with hash 0xFFFFFFFF, position -1 and word 0,
//           so they never match, and neither does a padding row (its
//           key keeps bit 31, its hash is above every live one);
//   dist  = p - order[i - k], kept when 0 < dist <= max_distance (the
//           tests also run a window of (1 << 10) - 16);
//   mlen  = the count of equal leading bytes of the 32 bytes at p and at
//           p - dist, both read cyclically (jnp.roll's wrap at the
//           segment's bucket end), capped at max(npos + 3 - p, 0) with
//           npos the level's (the segment's npos - (plen - 4)): the
//           guard is what keeps a match from running into the wrap;
//   out   = mlen >= 2 ? mlen << 25 | dist : 0, written as int32 at row p,
//           column col + r of the (n, ld) candidate table: position
//           order, which the JAX code reached with one more sort.
//
// Layout: position-major (n, ld), so a thread's ranks land in one
// contiguous run of its row (13 or 14 words) instead of nranks scattered
// 4-byte stores into an (nranks, n) table. K11 (edge_slots.cu) reads the
// same layout.
//
// Bound: bytes. Per 4 MiB segment and level it reads the sorted keys
// and order (2 x 33.6 MB) and the data, and writes nranks x 16.8 MB:
// 0.09 ms for the 14-rank level at 3.35 TB/s. One thread per sorted row:
// the key and order loads of row i - k are coalesced across the warp;
// the thread keeps its own 32 bytes in registers (read once, when a
// first candidate shares its hash) and compares a candidate's word by
// word, stopping at the first difference. Those bytes, and the row's
// stores, lie anywhere in the segment: the gathers and the scattered
// 4-byte stores keep it far from its bound (reading each window as the
// three aligned 16-byte loads that cover it timed the same, at twice
// the registers).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 16;
constexpr int CAPD_WORDS = 8;  // the 32-byte length cap

struct Ranks {
  int k[MAX_RANKS];
};

__device__ __forceinline__ unsigned word_at(const unsigned char* __restrict__ d,
                                            long long n, long long q) {
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    long long i = q + j;
    if (i >= n) i -= n;  // the cyclic read of jnp.roll
    w |= (unsigned)__ldg(d + i) << (8 * j);
  }
  return w;
}

__global__ void __launch_bounds__(THREADS)
edge_ranks_kernel(const long long* __restrict__ key_s,
                  const long long* __restrict__ order,
                  const unsigned char* __restrict__ data, int* __restrict__ out,
                  long long n, int ld, int col, Ranks rk, int nranks,
                  long long npos, long long max_distance) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long ki = __ldg(key_s + i);
  const long long p = __ldg(order + i);
  int* row = out + p * ld + col;
  if (ki >= (1LL << 31)) {  // a padding row: no candidate
    for (int r = 0; r < nranks; ++r) row[r] = 0;
    return;
  }
  const long long h = ki >> 14;
  long long guard = npos + 3 - p;
  if (guard < 0) guard = 0;
  unsigned mine[CAPD_WORDS];
  bool loaded = false;
  for (int r = 0; r < nranks; ++r) {
    const int k = rk.k[r];
    int packed = 0;
    if (i >= k && (__ldg(key_s + i - k) >> 14) == h) {
      const long long dist = p - __ldg(order + i - k);
      if (dist > 0 && dist <= max_distance) {
        if (!loaded) {
#pragma unroll
          for (int w = 0; w < CAPD_WORDS; ++w)
            mine[w] = word_at(data, n, p + 4 * w);
          loaded = true;
        }
        const long long q = p - dist;
        int mlen = 0;
#pragma unroll
        for (int w = 0; w < CAPD_WORDS; ++w) {
          const unsigned x = mine[w] ^ word_at(data, n, q + 4 * w);
          if (x != 0) {
            mlen += (__ffs((int)x) - 1) >> 3;  // equal low bytes
            break;
          }
          mlen += 4;
        }
        const long long m = mlen < guard ? mlen : guard;
        if (m >= 2) packed = (int)((m << 25) | dist);
      }
    }
    row[r] = packed;
  }
}

}  // namespace

extern "C" int btt_edge_ranks(const long long* key_s, const long long* order,
                              const unsigned char* data, int* out,
                              long long n, int ld, int col, const int* ranks,
                              int nranks, long long npos,
                              long long max_distance, cudaStream_t stream) {
  if (n < 32 || n >= (1LL << 31) || nranks < 1 || nranks > MAX_RANKS ||
      col < 0 || col + nranks > ld)
    return -1;
  Ranks rk{};
  for (int r = 0; r < nranks; ++r) {
    if (ranks[r] < 1) return -1;
    rk.k[r] = ranks[r];
  }
  const long long blocks = (n + THREADS - 1) / THREADS;
  edge_ranks_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      key_s, order, data, out, n, ld, col, rk, nranks, npos, max_distance);
  return (int)cudaGetLastError();
}
