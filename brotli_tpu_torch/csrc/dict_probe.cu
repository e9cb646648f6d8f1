// K12: the q11 DP's static-dictionary probe over the whole input.
//
// Replaces no TPU kernel: it replaces the host stage both packages run
// before the DP's segments, btpu_dict_probe_all (native/btpu_enc.c;
// ops/optimal._dict_probe_global), which took 2.9 s of an 8.3 s q11
// request of 16 MiB on one core of an H100 machine's host while the card
// sat idle. Its contract is that function's: the hits' positions and
// payloads (out_advance << 22 | wlen << 17 | dictoff) in position order,
// bit for bit, and no hits at all when they number more than cap =
// max(n / 8 + 64, 1024). The probe at each position is
// csrc/dict_probe.h's, the code the native library runs in a host loop
// for the CPU tests (native/btpu_probe.c).
//
// The probe at p reads the input from p to at most p + reach (37 bytes:
// the longest prefix, word and suffix; the image's head says so), the
// position's gate and the read-only tables (the word and omit-first
// buckets, 0.83 MB, and the dictionary's 122,784 bytes, which stay in
// L2), so the positions are independent. Three launches, one C call:
//   probe:   a CTA of 256 threads owns TILE positions; it stages their
//            bytes plus REACH more (zero past n) in shared memory with
//            16-byte loads, and the affix forms, the transform pool and
//            the size bits (2.8 KB) beside them; each thread probes
//            every 256th position, skipping those inside a gate (the
//            seed gate: sorted, disjoint intervals, binary-searched
//            within the tile's range, which thread 0 finds); it writes a
//            payload a position (0 = none) into scratch and the tile's
//            hit count;
//   scan:    one CTA turns the tiles' counts into offsets and the total;
//   scatter: a CTA a tile reads its payloads (TILE / 256 consecutive
//            ones a thread), scans their hit counts and writes each hit's
//            position and payload at its offset, unless the total
//            exceeds cap.
// Bound: its byte bound counts the n input bytes and the tables (0.97 MB
// image; the scratch's 4n bytes are written and read once more), but the
// work per position varies with the text (bucket scans of unequal
// length, a word's suffix and prefix forms compared byte by byte) and the
// threads of a warp diverge on it: the kernel is bound by that and by the
// latency of its dependent L2 reads, far from bytes. On a 16 MiB document
// of the q11 benchmark's synthetic traffic (NVIDIA H100 80GB HBM3, 700 W)
// it takes 19.2-20.1 ms alone, against 1.5-2.5 s for btpu_dict_probe_all
// on that machine's host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dict_probe.h"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;                 // positions per CTA
constexpr int REACH = BTT_DICT_REACH;      // bytes staged past the tile
constexpr int CHUNKS = (TILE + REACH) / 16;
constexpr int POOL = BTT_DICT_POOL;        // the transform pool's most bytes
constexpr int SCAN_THREADS = 1024;
constexpr int PER = TILE / THREADS;        // payloads a scatter thread takes
static_assert(TILE % THREADS == 0 && TILE % 16 == 0, "tile shape");

struct Small {  // the image's small tables, in shared memory
  BttAffix suf[BTT_DICT_FORMS + 1];
  BttAffix pre[BTT_DICT_FORMS + 1];
  uint8_t pre_start[272];
  uint8_t size_bits[32];
  uint8_t pool[POOL];
};

__device__ __forceinline__ void copy_words(void* dst, const uint8_t* src,
                                           int bytes) {
  // src is 16-byte aligned and padded to 16 in the image
  unsigned* d = reinterpret_cast<unsigned*>(dst);
  const unsigned* s = reinterpret_cast<const unsigned*>(src);
  for (int i = threadIdx.x; i < (bytes + 3) / 4; i += blockDim.x)
    d[i] = __ldg(s + i);
}

// the sum of v over the CTA, for thread 0 (others get a partial)
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* warp) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); w++) s += warp[w];
  return s;
}

// the exclusive prefix sum of v over the CTA, and the total in *total
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* warp,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    unsigned w = lane < nw ? warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp[lane] = w;  // inclusive
  }
  __syncthreads();
  *total = warp[nw - 1];
  return x - v + (wid ? warp[wid - 1] : 0);
}

__global__ void __launch_bounds__(THREADS)
dict_probe_kernel(const uint8_t* __restrict__ data, long long n,
                  unsigned long long base, unsigned long long maxback,
                  const uint8_t* __restrict__ img,
                  const unsigned* __restrict__ glo,
                  const unsigned* __restrict__ ghi, unsigned ngate,
                  unsigned* __restrict__ pay,
                  unsigned* __restrict__ counts) {
  __shared__ uint4 chunk[CHUNKS];
  __shared__ Small sm;
  __shared__ unsigned range[2];
  __shared__ unsigned warp[THREADS / 32];
  const BttDictHead* h = reinterpret_cast<const BttDictHead*>(img);
  const long long p0 = (long long)blockIdx.x * TILE;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(chunk);
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const long long at = p0 + 16LL * c;
    if (at + 16 <= n) {
      chunk[c] = __ldg(reinterpret_cast<const uint4*>(data + at));
    } else {
      for (int i = 0; i < 16; i++)
        bytes[16 * c + i] = at + i < n ? data[at + i] : 0;
    }
  }
  copy_words(sm.suf, img + h->suf, (int)sizeof(BttAffix) * h->nsuf);
  copy_words(sm.pre, img + h->pre, (int)sizeof(BttAffix) * h->npre);
  copy_words(sm.pre_start, img + h->pre_start, 257);
  copy_words(sm.size_bits, img + h->size_bits, 32);
  copy_words(sm.pool, img + h->pool, (int)h->pool_len);
  if (threadIdx.x == 0) {
    // the gates that reach into [p0, p0 + TILE): from the first that
    // ends after p0 to the first that starts at or after p0 + TILE
    unsigned a = 0, b = ngate;
    while (a < b) {
      unsigned m = (a + b) >> 1;
      if ((long long)ghi[m] <= p0) a = m + 1; else b = m;
    }
    unsigned c = a, d = ngate;
    while (c < d) {
      unsigned m = (c + d) >> 1;
      if ((long long)glo[m] < p0 + TILE) c = m + 1; else d = m;
    }
    range[0] = a;
    range[1] = c;
  }
  __syncthreads();
  BttDict D;
  D.start = reinterpret_cast<const uint32_t*>(img + h->start);
  D.of_start = reinterpret_cast<const uint32_t*>(img + h->of_start);
  D.entries = reinterpret_cast<const BttWord*>(img + h->entries);
  D.of_entries = reinterpret_cast<const BttWord*>(img + h->of_entries);
  D.blob = img + h->blob;
  D.suf = sm.suf;
  D.pre = sm.pre;
  D.pre_start = sm.pre_start;
  D.size_bits = sm.size_bits;
  D.pool = sm.pool;
  D.omit_last_id = h->omit_last_id;
  D.omit_first_id = h->omit_first_id;
  D.nsuf = h->nsuf;
  D.npre = h->npre;
  D.uc_first_id = h->uc_first_id;
  D.uc_all_id = h->uc_all_id;
  const unsigned g0 = range[0], ng = range[1] - range[0];
  unsigned hits = 0;
  for (int q = threadIdx.x; q < TILE; q += THREADS) {
    const long long pos = p0 + q;
    unsigned v = 0;
    if (pos + 4 <= n && !btt_gated(glo + g0, ghi + g0, ng, (unsigned)pos))
      v = btt_dict_probe_at(&D, bytes + q, (uint64_t)pos, (uint64_t)n, base,
                            maxback);
    pay[pos] = v;
    hits += v != 0;
  }
  const unsigned s = block_sum(hits, warp);
  if (threadIdx.x == 0) counts[blockIdx.x] = s;
}

__global__ void __launch_bounds__(SCAN_THREADS)
dict_scan_kernel(const unsigned* __restrict__ counts,
                 unsigned* __restrict__ offsets, int ntiles, int* out) {
  __shared__ unsigned warp[SCAN_THREADS / 32];
  const int per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * per, ntiles);
  const int hi = min(lo + per, ntiles);
  unsigned s = 0;
  for (int i = lo; i < hi; i++) s += counts[i];
  unsigned total;
  unsigned e = block_scan(s, warp, &total);
  for (int i = lo; i < hi; i++) {
    offsets[i] = e;
    e += counts[i];
  }
  if (threadIdx.x == 0) {
    out[0] = (int)total;
    out[1] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
dict_scatter_kernel(const unsigned* __restrict__ pay,
                    const unsigned* __restrict__ offsets, int* out,
                    long long cap) {
  __shared__ unsigned warp[THREADS / 32];
  const long long p = (long long)blockIdx.x * TILE + PER * threadIdx.x;
  unsigned v[PER];
  unsigned c = 0;
#pragma unroll
  for (int k = 0; k < PER; k++) {
    v[k] = pay[p + k];
    c += v[k] != 0;
  }
  unsigned tile_total;
  unsigned dst = offsets[blockIdx.x] + block_scan(c, warp, &tile_total);
  if ((long long)(unsigned)out[0] > cap) return;
  int* out_pos = out + 2;
  int* out_pay = out + 2 + cap;
#pragma unroll
  for (int k = 0; k < PER; k++) {
    if (!v[k]) continue;
    out_pos[dst] = (int)(p + k);
    out_pay[dst] = (int)v[k];
    dst++;
  }
}

}  // namespace

// scratch: TILE * ntiles + 2 * ntiles int32 (payloads, counts, offsets);
// out: 2 + 2 * cap int32 (the hit count, 0, positions, payloads)
extern "C" int btt_dict_probe(const unsigned char* data, long long n,
                              unsigned long long base,
                              unsigned long long maxback,
                              const unsigned char* img, const int* gates,
                              long long ngate, int* scratch, int* out,
                              long long cap, cudaStream_t stream) {
  if (n < 1 || n >= (1LL << 31) || ngate < 0 || ngate >= (1LL << 31) ||
      cap < 1 || ((uintptr_t)data & 15) != 0 || ((uintptr_t)img & 15) != 0 ||
      ((uintptr_t)scratch & 15) != 0)
    return -1;
  const int ntiles = (int)((n + TILE - 1) / TILE);
  unsigned* pay = reinterpret_cast<unsigned*>(scratch);
  unsigned* counts = pay + (long long)ntiles * TILE;
  unsigned* offsets = counts + ntiles;
  const unsigned* glo = reinterpret_cast<const unsigned*>(gates);
  dict_probe_kernel<<<ntiles, THREADS, 0, stream>>>(
      data, n, base, maxback, img, glo, glo + ngate, (unsigned)ngate, pay,
      counts);
  dict_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, offsets, ntiles,
                                                   out);
  dict_scatter_kernel<<<ntiles, THREADS, 0, stream>>>(pay, offsets, out, cap);
  return (int)cudaGetLastError();
}
