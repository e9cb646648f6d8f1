// K9: the sort keys of one candidate level of a DP segment.
//
// Replaces the key lines of brotli_tpu/ops/optimal_jax.py::
// _level_candidates (the jnp.where before its lax.sort) and the words
// and hashes of _edges_slots that feed them: on the TPU, XLA fuses
// these into the sort's operands. For every position p of the
// segment's n bytes:
//   w_r  = the little-endian 32-bit word of bytes p + 4r .. p + 4r + 3,
//          read cyclically: jnp.roll/torch.roll wrap at the segment's
//          bucket end, and the npos + 3 guard of K10 relies on that wrap
//          (the bytes past the end are the segment's first ones);
//   hval = (w0 * 0x1E35A7BD) >> 15 at plen 4,
//          (w0 * 0x1E35A7BD ^ w1 * 0x9E3779B1) >> 15 at plen 8,
//          ... ^ w2 * 0x85EBCA77 ^ w3 * 0xC2B2AE3D at plen 16 (the level
//          of DPConfig.level3, whose 10 ranks make 39 slots), all uint32
//          products wrapping;
//   key  = p < npos ? hval << 14 | p >> 9 : 1 << 31 | p, the JAX uint32
//          key, stored as int32 key - 2^31 (bit 31 flipped): signed
//          order is then the uint32 order, so the stable torch.sort of
//          4-byte keys gives lax.sort's permutation, padding rows
//          included; live rows are negative, padding rows not, and
//          (key - 2^31) >> 14 (arithmetic) is hval - 2^17, which K10
//          compares.
// With `wide` (a window wider than 4 MiB, whose segments rank over up
// to 16 Mi rows: 128 a 17-bit hash, so a source 8 MiB back is rarely at
// one of the level's ranks) a live row's uint32 key is the product's
// top 31 bits instead, hash >> 1 before the >> 15, with no position
// bits: the stable sort orders a key's rows by position, and K10
// compares whole keys.
// npos is the level's: the segment's npos - (plen - 4), at least 0,
// which the caller computes (a 16-byte prefix must lie inside the
// segment's live bytes). The bytes are 16-byte aligned and n is a
// multiple of 16, as every bucket of a DP segment is; the entry point
// returns -1 for other input.
//
// Bound: bytes. It reads the n bytes and writes 4n (21 MB per 4 MiB
// segment, 0.0063 ms at 3.35 TB/s). The first version wrote the uint32
// key zero-extended in int64 (9n bytes against a 0.011 ms bound), so the
// level's radix sort ran 8-byte keys in 8 passes, and each thread read
// its plen bytes one by one through the read-only cache. Here a CTA of
// 256 threads owns TILE consecutive positions: it loads the TILE + 16
// bytes they read once, as aligned 16-byte loads, into shared memory
// (the wrap at n included), builds each word from two aligned shared
// words with a funnel shift, and writes 4 bytes a position, coalesced.
// On the first 4 MiB segment of the 16 MiB corpus at the 8-byte level,
// alone, in one call of tools/probe_k10.py (NVIDIA H100 80GB HBM3,
// 700 W): 0.0090 ms against the first version's 0.0228; the level's
// stable sort of the 4-byte keys 0.283 ms against 0.567 for 8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;              // positions per CTA
constexpr int CHUNKS = TILE / 16 + 1;   // 16-byte chunks: TILE + 16 bytes

__global__ void __launch_bounds__(THREADS)
edge_keys_kernel(const unsigned char* __restrict__ data,
                 int* __restrict__ key, long long n, int plen,
                 long long npos, int wide) {
  __shared__ uint4 chunk[CHUNKS];
  const long long p0 = (long long)blockIdx.x * TILE;
  // the bytes are 16-byte aligned and n a multiple of 16 (every bucket
  // is; the entry point refuses others), so a chunk lies wholly before n
  // or wholly in the wrap
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS)
    chunk[c] = __ldg(reinterpret_cast<const uint4*>(data +
                                                    (p0 + 16LL * c) % n));
  __syncthreads();
  const unsigned* s = reinterpret_cast<const unsigned*>(chunk);
  for (int q = threadIdx.x; q < TILE; q += THREADS) {
    const long long p = p0 + q;
    if (p >= n) break;
    const int a = q >> 2;
    const unsigned sh = 8u * (q & 3);
    // the word at byte q: bytes q .. q + 3 of the little-endian pair
    auto word = [&](int r) {
      return __funnelshift_r(s[a + r], s[a + r + 1], sh);
    };
    unsigned h = word(0) * 0x1E35A7BDu;
    if (plen >= 8) h ^= word(1) * 0x9E3779B1u;
    if (plen >= 16) {
      h ^= word(2) * 0x85EBCA77u;
      h ^= word(3) * 0xC2B2AE3Du;
    }
    const unsigned up = (unsigned)p;
    const unsigned live = wide ? h >> 1 : (h >> 15) << 14 | up >> 9;
    const unsigned k = p < npos ? live : (1u << 31) | up;
    key[p] = (int)(k ^ 0x80000000u);
  }
}

}  // namespace

extern "C" int btt_edge_keys(const unsigned char* data, int* key,
                             long long n, int plen, long long npos,
                             int wide, cudaStream_t stream) {
  if (n < 16 || n >= (1LL << 31) || (n & 15) != 0 ||
      ((uintptr_t)data & 15) != 0 || (plen != 4 && plen != 8 && plen != 16))
    return -1;
  const long long blocks = (n + TILE - 1) / TILE;
  edge_keys_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(data, key, n,
                                                             plen, npos,
                                                             wide);
  return (int)cudaGetLastError();
}
