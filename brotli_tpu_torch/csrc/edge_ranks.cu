// K10: the rank candidates of a DP segment's levels, in two launches.
//
// Replaces the rank loop of brotli_tpu/ops/optimal_jax.py::
// _level_candidates and its sorts back to position order: after the
// level's stable sort on K9's keys (lax.sort there, torch.sort here,
// outside the kernel), for every sorted row i and each rank k of the
// level, row i - k is the k-th nearest earlier position sharing the
// level's hash. Per sorted row i (key_s[i], position p = order[i]) and
// rank k:
//   same  = key_s[i] >> 14 == key_s[i - k] >> 14 and key_s[i] < 0 (K9's
//           int32 keys are the JAX uint32 keys - 2^31: live rows are
//           negative). Rows i < k have no row i - k: _shift_up fills the
//           head of the sorted arrays with a hash no row has, position
//           -1 and word 0, so they never match, and neither does a
//           padding row;
//   dist  = p - order[i - k], kept when 0 < dist <= max_distance (the
//           tests also run a window of (1 << 10) - 16);
//   mlen  = the count of equal leading bytes of the 32 bytes at p and at
//           p - dist, both read cyclically (jnp.roll's wrap at the
//           segment's bucket end), capped at max(npos + 3 - p, 0) with
//           npos the level's (the segment's npos - (plen - 4)): the
//           guard is what keeps a match from running into the wrap;
//   out   = mlen >= 2 ? mlen << 25 | dist : 0, as int32.
//
// Launch 1, btt_edge_ranks, once a level: the sort-carry. The TPU sorts
// the 8 words of every position along with its key, so each rank's
// compare is a shift of contiguous rows. Here a CTA of T threads owns T
// consecutive sorted rows and stages them in shared memory, with the
// rows before the tile that a rank can reach: those that share row
// i0's hash among the kmax before it (kmax the level's largest rank,
// 16, 512 or 256; they are a suffix of that halo, the rows being
// sorted by hash, so one barrier count finds them). Every staged live
// row that shares its hash with another staged row gets its 32-byte
// window gathered once, as the three aligned 16-byte loads that cover
// it, all issued before any is used, and funnel-shifted into 8 words
// (word-major in shared memory, so a warp's reads of 32 rows fall in
// distinct banks). After one barrier, every thread computes its row's
// ranks from shared memory alone and writes them, zero-padded to
// STRIDE = 16 words, as one whole aligned 64-byte row p of the level's
// (n, 16) block: four 16-byte stores that fill two whole sectors.
//
// Launch 2, btt_edge_rows, once after the last level: a CTA of ROWS
// threads owns ROWS consecutive positions, reads their rows of every
// level's block (coalesced 16-byte loads) into a shared tile, and writes
// the tile's (ROWS, ld) rows of the position-major candidate table as
// one coalesced run. K11 (edge_slots.cu) reads that table.
//
// What limited the first version, and the choice of stores. It
// ran one thread a sorted row: the neighbour's key, its order, its
// window and the candidate's words were a chain of dependent random
// loads, and the thread stored its 13 or 14 words straight into row p
// of the (n, ld) table, 52 or 56 bytes at any offset of a 108-byte row,
// so a warp's stores wrote parts of sectors in 32 unrelated rows of a
// 453 MB table that the 50 MB L2 cannot hold, each level a different
// part. tools/probe_k10.py on the first 4 MiB segment of the 16 MiB
// corpus at the 8-byte level (NVIDIA H100 80GB HBM3, 700 W): the first
// version 1.926 ms; the same kernel storing made-up words with no window
// loads 1.894 ms; the full compares with the words stored in sorted
// order 1.512 ms. So the partial-sector stores alone cost nearly all of
// it. Writing sorted-order words coalesced and the inverse permutation,
// then gathering each position's runs through it, took 0.443 ms a level
// and 1.125 ms for the gather (56-byte runs at random rows), or 0.498
// and 0.520 ms with the runs padded to aligned 64 bytes; whole aligned
// 64-byte rows written at position p take 0.433 ms a level and 0.327 ms
// for the row pass, which then reads in position order (scratch
// harnesses around the probe's builds, same card). That is the design
// here: what the first version's stores lacked was whole sectors, not
// order. With three CTAs an SM (below), one call of the probe: 0.372 ms
// at the 14-rank level against the first version's 1.923, and 0.328 ms
// for the row pass of the two default levels.
//
// Bound: bytes. Launch 1 reads the keys (4n), the order (8n) and the
// data (n), and writes the level's 4 nranks n words: 289 MB for the
// 14-rank level of a 4 MiB segment, 0.086 ms at 3.35 TB/s (its padded
// rows move 64n, not 56n). Launch 2 reads and writes the 4 ld n words of
// the table: 906 MB for the two default levels (27 columns), 0.27 ms
// (reading whole rows moves 128n, not 108n).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// T: rows a CTA, one a thread, and one halo row a thread. 512 rows and
// a 512-row halo keep the staging (keys, positions, 8 window words: 40
// bytes a slot) at 40 KB of static shared memory, and the halo, whose
// windows only the rows that share the tile's first hash need, at most
// doubles the key and order reads. Three CTAs an SM (40 registers a
// thread) overlap one CTA's gathers with another's compares and stores:
// 0.370 ms at the 14-rank level against 0.433 ms at two CTAs (56
// registers); CTAs of 256 rows, which would need two halo rows a thread,
// timed 6-8% faster at the 4-byte level (scratch harness, same card).
constexpr int T = 512;
constexpr int HALO = 512;          // the largest rank of any level
static_assert(T >= HALO, "a thread loads one halo row");
constexpr int CTAS_PER_SM = 3;
constexpr int S = HALO + T;        // row j at slot j - i0 + HALO
constexpr int WORDS = 8;           // the 32-byte length cap
constexpr int MAX_RANKS = 16;
constexpr int STRIDE = MAX_RANKS;  // words of a level's row: 64 bytes
constexpr int MAX_LEVELS = 3;
constexpr int ROWS = 128;          // positions a CTA of launch 2
constexpr int MAX_LD = MAX_LEVELS * MAX_RANKS;

struct Ranks {
  int k[MAX_RANKS];
};

struct Levels {
  int nranks[MAX_LEVELS];
};

// The 8 little-endian words of the 32 bytes at p, read cyclically at n:
// the three aligned 16-byte chunks that cover them, each wrapped whole
// (the bytes are 16-byte aligned and n a multiple of 16, as every
// bucket is; the entry point refuses others).
__device__ __forceinline__ void window(const unsigned char* __restrict__ d,
                                       long long n, long long p,
                                       unsigned w[WORDS]) {
  unsigned u[12];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    long long g = (p & ~15LL) + 16 * c;
    if (g >= n) g -= n;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(d + g));
    u[4 * c] = v.x;
    u[4 * c + 1] = v.y;
    u[4 * c + 2] = v.z;
    u[4 * c + 3] = v.w;
  }
  const int wo = (int)(p >> 2) & 3;
  const unsigned sh = 8u * (unsigned)(p & 3);
  unsigned a[WORDS + 1];
#pragma unroll
  for (int r = 0; r <= WORDS; ++r)
    a[r] = wo == 0   ? u[r]
           : wo == 1 ? u[r + 1]
           : wo == 2 ? u[r + 2]
                     : u[r + 3];
#pragma unroll
  for (int r = 0; r < WORDS; ++r) w[r] = __funnelshift_r(a[r], a[r + 1], sh);
}

__global__ void __launch_bounds__(T, CTAS_PER_SM)
edge_ranks_kernel(const int* __restrict__ key_s,
                  const long long* __restrict__ order,
                  const unsigned char* __restrict__ data,
                  int* __restrict__ words, long long n, Ranks rk,
                  int nranks, int kmax,
                  long long npos, long long max_distance) {
  __shared__ int key_sm[S];
  __shared__ int pos_sm[S];
  __shared__ unsigned win_sm[WORDS][S];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * T;
  const long long i = i0 + t;
  const int s = HALO + t;

  // 1. the tile's keys and positions, and the kmax rows before it
  int ki = 0, p = 0;
  if (i < n) {
    ki = __ldg(key_s + i);
    p = (int)__ldg(order + i);
    key_sm[s] = ki;
    pos_sm[s] = p;
  }
  const long long j = i0 - kmax + t;
  const int sh = HALO - kmax + t;
  bool in_grp = false;
  int pj = 0;
  if (t < kmax && j >= 0) {
    const int kj = __ldg(key_s + j);
    pj = (int)__ldg(order + j);
    key_sm[sh] = kj;
    pos_sm[sh] = pj;
    in_grp = kj < 0 && (kj >> 14) == (__ldg(key_s + i0) >> 14);
  }
  // the halo rows sharing row i0's hash: the last `grp` of the halo
  const int lo = HALO - __syncthreads_count(in_grp);

  // 2. the windows of the staged rows a rank can compare
  unsigned w[WORDS];
  const long long tile_end = n - i0 < T ? n : i0 + T;
  if (i < n && ki < 0 &&
      ((s - 1 >= lo && (key_sm[s - 1] >> 14) == (ki >> 14)) ||
       (i + 1 < tile_end && (key_sm[s + 1] >> 14) == (ki >> 14)))) {
    window(data, n, p, w);
#pragma unroll
    for (int r = 0; r < WORDS; ++r) win_sm[r][s] = w[r];
  }
  if (in_grp) {
    window(data, n, pj, w);
#pragma unroll
    for (int r = 0; r < WORDS; ++r) win_sm[r][sh] = w[r];
  }
  __syncthreads();

  // 3. the row's ranks, from shared memory alone
  int packed[MAX_RANKS];
#pragma unroll
  for (int r = 0; r < MAX_RANKS; ++r) packed[r] = 0;
  if (i < n && ki < 0) {
    const int h = ki >> 14;
    long long guard = npos + 3 - p;
    if (guard < 0) guard = 0;
    bool loaded = false;
#pragma unroll
    for (int r = 0; r < MAX_RANKS; ++r) {
      if (r >= nranks) break;
      const int sj = s - rk.k[r];
      if (sj < lo || (key_sm[sj] >> 14) != h) continue;
      const int dist = p - pos_sm[sj];
      if (dist <= 0 || dist > max_distance) continue;
      if (!loaded) {
#pragma unroll
        for (int x = 0; x < WORDS; ++x) w[x] = win_sm[x][s];
        loaded = true;
      }
      int mlen = 0;
#pragma unroll
      for (int x = 0; x < WORDS; ++x) {
        const unsigned d = w[x] ^ win_sm[x][sj];
        if (d != 0) {
          mlen += (__ffs((int)d) - 1) >> 3;  // equal low bytes
          break;
        }
        mlen += 4;
      }
      const long long m = mlen < guard ? mlen : guard;
      if (m >= 2) packed[r] = (int)((m << 25) | dist);
    }
  }
  if (i < n) {  // row p, whole: zeros past the level's ranks
    uint4* dst = reinterpret_cast<uint4*>(words + (long long)p * STRIDE);
#pragma unroll
    for (int q = 0; q < STRIDE / 4; ++q)
      dst[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2],
                          packed[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(ROWS)
edge_rows_kernel(const int* __restrict__ words, int* __restrict__ out,
                 long long n, Levels lv, int nlevels, int ld) {
  __shared__ int tile[ROWS * MAX_LD];
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * ROWS;
  const long long p = p0 + t;
  if (p < n) {
    int col = 0;
#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l >= nlevels) break;
      const uint4* src =
          reinterpret_cast<const uint4*>(words + (l * n + p) * STRIDE);
      int v[STRIDE];
#pragma unroll
      for (int q = 0; q < STRIDE / 4; ++q) {
        const uint4 x = __ldg(src + q);
        v[4 * q] = (int)x.x;
        v[4 * q + 1] = (int)x.y;
        v[4 * q + 2] = (int)x.z;
        v[4 * q + 3] = (int)x.w;
      }
      const int nr = lv.nranks[l];
#pragma unroll
      for (int r = 0; r < STRIDE; ++r)
        if (r < nr) tile[t * ld + col + r] = v[r];
      col += nr;
    }
  }
  __syncthreads();
  const long long rows = n - p0 < ROWS ? n - p0 : ROWS;
  int* dst = out + p0 * ld;
  for (int x = t; x < rows * ld; x += ROWS) dst[x] = tile[x];
}

}  // namespace

extern "C" int btt_edge_ranks(const int* key_s, const long long* order,
                              const unsigned char* data, int* words,
                              long long n, const int* ranks, int nranks,
                              long long npos, long long max_distance,
                              cudaStream_t stream) {
  if (n < 32 || n >= (1LL << 31) || (n & 15) != 0 || nranks < 1 ||
      nranks > MAX_RANKS || ((uintptr_t)data & 15) != 0 ||
      ((uintptr_t)words & 15) != 0)
    return -1;
  Ranks rk{};
  int kmax = 0;
  for (int r = 0; r < nranks; ++r) {
    if (ranks[r] < 1 || ranks[r] > HALO) return -1;
    rk.k[r] = ranks[r];
    if (ranks[r] > kmax) kmax = ranks[r];
  }
  const long long blocks = (n + T - 1) / T;
  edge_ranks_kernel<<<(unsigned)blocks, T, 0, stream>>>(
      key_s, order, data, words, n, rk, nranks, kmax, npos, max_distance);
  return (int)cudaGetLastError();
}

extern "C" int btt_edge_rows(const int* words, int* out, long long n,
                             const int* nranks, int nlevels,
                             cudaStream_t stream) {
  if (n < 1 || n >= (1LL << 31) || nlevels < 1 || nlevels > MAX_LEVELS ||
      ((uintptr_t)words & 15) != 0)
    return -1;
  Levels lv{};
  int ld = 0;
  for (int l = 0; l < nlevels; ++l) {
    if (nranks[l] < 1 || nranks[l] > MAX_RANKS) return -1;
    lv.nranks[l] = nranks[l];
    ld += nranks[l];
  }
  const long long blocks = (n + ROWS - 1) / ROWS;
  edge_rows_kernel<<<(unsigned)blocks, ROWS, 0, stream>>>(words, out, n, lv,
                                                          nlevels, ld);
  return (int)cudaGetLastError();
}
