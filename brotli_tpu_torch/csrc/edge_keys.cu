// K9: the sort keys of one candidate level of a DP segment.
//
// Replaces the key lines of brotli_tpu/ops/optimal_jax.py::
// _level_candidates (the jnp.where before its lax.sort) and the words
// and hashes of _edges_slots that feed them: on the TPU, XLA fuses
// these into the sort's operands; the port ran them as some twenty
// torch launches a level. For every position p of the segment's n
// bytes:
//   w_r  = the little-endian 32-bit word of bytes p + 4r .. p + 4r + 3,
//          read cyclically: jnp.roll/torch.roll wrap at the segment's
//          bucket end, and the npos + 3 guard of K10 relies on that wrap
//          (the bytes past the end are the segment's first ones);
//   hval = (w0 * 0x1E35A7BD) >> 15 at plen 4,
//          (w0 * 0x1E35A7BD ^ w1 * 0x9E3779B1) >> 15 at plen 8,
//          ... ^ w2 * 0x85EBCA77 ^ w3 * 0xC2B2AE3D at plen 16 (the level
//          of DPConfig.level3, whose 10 ranks make 39 slots), all uint32
//          products wrapping;
//   key  = p < npos ? hval << 14 | p >> 9 : 1 << 31 | p, as uint32,
//          stored zero-extended in int64 for torch.sort.
// npos is the level's: the segment's npos - (plen - 4), at least 0,
// which the caller computes (a 16-byte prefix must lie inside the
// segment's live bytes).
//
// Bound: bytes. It reads the n bytes and writes 8n (33.6 MB per 4 MiB
// segment, 0.010 ms at 3.35 TB/s). One thread per position; its plen
// bytes come through the read-only cache, which the 31 neighbours that
// read the same bytes share.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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
edge_keys_kernel(const unsigned char* __restrict__ data,
                 long long* __restrict__ key, long long n, int plen,
                 long long npos) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  unsigned h = word_at(data, n, p) * 0x1E35A7BDu;
  if (plen >= 8) h ^= word_at(data, n, p + 4) * 0x9E3779B1u;
  if (plen >= 16) {
    h ^= word_at(data, n, p + 8) * 0x85EBCA77u;
    h ^= word_at(data, n, p + 12) * 0xC2B2AE3Du;
  }
  h >>= 15;
  const unsigned up = (unsigned)p;
  key[p] = (long long)(p < npos ? (h << 14) | (up >> 9) : (1u << 31) | up);
}

}  // namespace

extern "C" int btt_edge_keys(const unsigned char* data, long long* key,
                             long long n, int plen, long long npos,
                             cudaStream_t stream) {
  if (n < 16 || n >= (1LL << 31) || (plen != 4 && plen != 8 && plen != 16))
    return -1;
  const long long blocks = (n + THREADS - 1) / THREADS;
  edge_keys_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(data, key, n,
                                                             plen, npos);
  return (int)cudaGetLastError();
}
