// K5: LZ copy resolution of the device decoder, by pointer doubling.
//
// Replaces brotli_tpu/ops/lz_resolve.py::_resolve, whose doubling is a
// device-side lax.fori_loop. The symbol parse gives a command list
// (nlit, ncopy, dist) and the flat literal stream; output position j of
// command ci is a literal when its offset in the command is below
// nlit[ci], else a copy of position j - dist[ci]. Every position points
// at itself (a literal) or at its copy source; n_steps rounds of
// src <- src[src] collapse each chain (depth halves a round), and
// out[j] = the literal at src[j], or 0 where the chain is still a copy
// (a cut-short n_steps gives the JAX code's bytes, since every round is
// out of place).
//
// Launches:
//   1. setup, a thread a position: binary search of the inclusive
//      command ends (int32 prefix sums from the wrapper) for the
//      command; src = j and lv = the literal byte for a literal, src =
//      j - dist and lv = -1 for a copy. A copy whose source is not in
//      [0, j) (never in a stream the native parse accepts) sets *err and
//      points at itself;
//   2. n_steps rounds dst[j] = src[src[j]], out of place into the other
//      buffer; the last round also writes out[j] = max(lv[dst[j]], 0)
//      (n_steps = 0: out[j] from src itself).
//
// Bound: bytes. The function reads the literals and the three command
// arrays once and writes n_out bytes (16 MiB: 0.005 ms at 3.35 TB/s);
// each doubling round moves 12 B a position (read src[j], gather
// src[src[j]], write dst[j]) and the setup ~8 (src and lv), so 24
// rounds at 16 Mi positions take at least 1.5 ms. The rounds are
// latency-bound gathers; nothing here hides them yet.
//
// *err is zeroed by cudaMemsetAsync in btt_lz_resolve.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
setup_kernel(const uint8_t* __restrict__ lits, long long nlits,
             const int* __restrict__ nlit, const int* __restrict__ ncopy,
             const int* __restrict__ dist, const int* __restrict__ ends,
             const int* __restrict__ lit_off, int ncmd, int n_out,
             int* __restrict__ src, short* __restrict__ lv,
             int* __restrict__ err) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_out) return;
  // searchsorted(ends, j, side="right"): the first command ending after j
  int lo = 0, hi = ncmd;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int ci = lo;
  const int nl = nlit[ci];
  const int off = j - (ends[ci] - nl - ncopy[ci]);
  if (off < nl) {
    long long li = (long long)lit_off[ci] + off;
    li = li < 0 ? 0 : (li >= nlits ? nlits - 1 : li);
    src[j] = j;
    lv[j] = (short)lits[li];
  } else {
    const long long s = (long long)j - dist[ci];
    const bool ok = s >= 0 && s < j;
    if (!ok) *err = 1;
    src[j] = ok ? (int)s : j;
    lv[j] = -1;
  }
}

// one doubling round; with out != nullptr it is the last one and also
// writes the bytes
__global__ void __launch_bounds__(THREADS)
round_kernel(const int* __restrict__ src, int* __restrict__ dst,
             const short* __restrict__ lv, uint8_t* __restrict__ out,
             int n_out) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_out) return;
  const int s = src[src[j]];
  dst[j] = s;
  if (out) {
    const short v = lv[s];
    out[j] = v < 0 ? 0 : (uint8_t)v;
  }
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const int* __restrict__ src, const short* __restrict__ lv,
              uint8_t* __restrict__ out, int n_out) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_out) return;
  const short v = lv[src[j]];
  out[j] = v < 0 ? 0 : (uint8_t)v;
}

}  // namespace

// src_a, src_b: int32 (n_out,) ping-pong buffers; lv: int16 (n_out,);
// out: uint8 (n_out,); err: one int32.
extern "C" int btt_lz_resolve(const uint8_t* lits, long long nlits,
                              const int* nlit, const int* ncopy,
                              const int* dist, const int* ends,
                              const int* lit_off, int ncmd, int n_out,
                              int n_steps, int* src_a, int* src_b,
                              short* lv, uint8_t* out, int* err,
                              cudaStream_t stream) {
  if (nlits <= 0 || ncmd <= 0 || n_out <= 0 || n_steps < 0) return -1;
  cudaError_t e = cudaMemsetAsync(err, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(((long long)n_out + THREADS - 1) / THREADS);
  setup_kernel<<<grid, THREADS, 0, stream>>>(lits, nlits, nlit, ncopy, dist,
                                             ends, lit_off, ncmd, n_out,
                                             src_a, lv, err);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (n_steps == 0) {
    gather_kernel<<<grid, THREADS, 0, stream>>>(src_a, lv, out, n_out);
    return (int)cudaGetLastError();
  }
  int* cur = src_a;
  int* nxt = src_b;
  for (int r = 0; r < n_steps; ++r) {
    round_kernel<<<grid, THREADS, 0, stream>>>(
        cur, nxt, lv, r == n_steps - 1 ? out : nullptr, n_out);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}
