// K4: the backtrack of every DP block.
//
// Replaces the backtrack of brotli_tpu/ops/optimal_jax.py::_finish_math,
// a lax.scan of B steps with the blocks as the vector axis. Per block b,
// with row = paymat[b] (B + 1 payloads) and
//   next(p) = p - max(row[p] >> 25, 1) for p > 0,   next(p) = p for p <= 0,
// step k < B visits walk[k] = next^k(B) and records
//   gsrc[k][b] = src + b * B when len >= 2, p > 0 and src >= 0, else -1,
//   vals[k][b] = row[wrap(p)],
// with src = next(p), len = row[wrap(p)] >> 25 and wrap(p) = p + B + 1
// for p < 0 (the negative index of jnp and torch). Every step is 1..63,
// so the walk strictly descends through positions B..1 and then stays
// at its first position <= 0, which is >= -62. The stable compaction
// that follows stays a torch.sort.
//
// Bound: bytes (paymat read once, gsrc and vals written once: 50 MB at
// nb = 1,024, 0.015 ms). The first design walked each block's B
// dependent steps on one thread (a shared-memory load each, the other
// threads idle) and stored (k, b) with consecutive threads 4 KiB apart,
// one partial 32-byte sector per 4-byte store. This design removes both:
//   - the walk in 5 + B/32 + 32 dependent steps at most, not B: five
//     rounds of pointer doubling over every position (J_0 = next,
//     J_{r+1} = J_r o J_r) give J_32 = next^32; one thread per block
//     chains the checkpoints c_{i+1} = J_32(c_i) from c_0 = B up to the
//     first c <= 0, the walk's fixed point, which every later checkpoint
//     repeats; then 128 threads per block each walk 32 steps from their
//     checkpoint, so walk[32 i + j] = next^j(c_i). Positions <= 0 stay
//     fixed points throughout, so no step needs to know where the walk
//     ends;
//   - the store in full sectors: one CTA holds G = 8 consecutive DP
//     blocks and writes their 8 entries of each k together (32 bytes).
// Shared memory (dynamic, ~196 KB): the 8 rows, the jump table as int16
// (J_0 written as the rows arrive; reused for the walk once the
// checkpoints are set) and the checkpoints. The walk is padded by one
// entry in 32 so that the threads that write it, 32 entries apart, hit
// distinct banks. What bounds it now: one CTA fills an SM, so its load
// of the rows, its doubling and walk, and its stores run one after the
// other, each SM in step with the rest; the load and the stores run near
// the card's memory rate, and the ~11 us of work between them does not
// overlap either.

#include <cuda_runtime.h>

// Built with -DBTT_K4_STAMPS (tools/probe_k4.py), thread 0 of every CTA
// records %globaltimer at the start of each numbered phase and at the
// end, in btt_stamps[cta * 8 + phase]; otherwise STAMP is empty.
#ifdef BTT_K4_STAMPS
__device__ unsigned long long btt_stamps[1 << 15];
#define STAMP(ph)                                                      \
  if (threadIdx.x == 0) {                                              \
    unsigned long long gt;                                             \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));             \
    btt_stamps[blockIdx.x * 8 + (ph)] = gt;                            \
  }
#else
#define STAMP(ph)
#endif

namespace {

constexpr int B = 4096;
constexpr int ROW = B + 1;
constexpr int G = 8;             // DP blocks per CTA
constexpr int THREADS = 1024;
constexpr int LOG_S = 5;         // doubling rounds: checkpoints S apart
constexpr int S = 1 << LOG_S;
constexpr int NCK = B / S;       // checkpoints per block
constexpr int HALF = B / 2;      // int16 pairs of one jump table
constexpr int PAIRS = G * HALF / THREADS;
constexpr int WS = B + B / S + 2;  // padded walk stride in int16
constexpr size_t ROWS_BYTES = sizeof(int) * G * ROW;
constexpr size_t JMP_BYTES = sizeof(short) * G * WS;
constexpr size_t SMEM_BYTES =
    ROWS_BYTES + JMP_BYTES + sizeof(short) * G * NCK + sizeof(int) * 2 * G;
static_assert(ROWS_BYTES % 16 == 0 && JMP_BYTES % 16 == 0, "alignment");
static_assert(G * NCK == THREADS, "one walker per checkpoint");
static_assert(HALF == 2 * THREADS, "pairs t + i * THREADS lie in block i / 2");
// the 8 blocks' walks start one bank apart
static_assert((WS / 2) % 32 == 1, "walk stride");

__device__ __forceinline__ int next_pos(const int* row, int p) {
  return p > 0 ? p - max(row[p] >> 25, 1) : p;
}

__device__ __forceinline__ int widx(int k) { return k + (k >> LOG_S); }

// J_0 of the payload at flat index i of the staged rows
__device__ __forceinline__ void stage_jump(short* jmp, int i, int v) {
  const int g = i / ROW, p = i - g * ROW;
  if (p > 0) jmp[g * B + p - 1] = (short)(p - max(v >> 25, 1));
}

__global__ void __launch_bounds__(THREADS)
dp_backtrack_kernel(const int* __restrict__ paymat, int* __restrict__ gsrc,
                    int* __restrict__ vals, int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem);
  short* jmp = reinterpret_cast<short*>(smem + ROWS_BYTES);
  short* ck = reinterpret_cast<short*>(smem + ROWS_BYTES + JMP_BYTES);
  int* live = reinterpret_cast<int*>(ck + G * NCK);
  int* fixp = live + G;
  const int t = threadIdx.x;
  const long long b0 = (long long)blockIdx.x * G;
  const int ng = (int)min((long long)G, nb - b0);

  STAMP(0)
  // 1. stage the CTA's rows (contiguous in paymat) and J_0 = next over
  // positions 1..B (entry p - 1) as they arrive
  const int* src = paymat + b0 * ROW;
  const int total = ng * ROW;
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    done = total / 4 * 4;
    for (int i = t; i < total / 4; i += THREADS) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src) + i);
      reinterpret_cast<int4*>(rows)[i] = v;
      stage_jump(jmp, 4 * i, v.x);
      stage_jump(jmp, 4 * i + 1, v.y);
      stage_jump(jmp, 4 * i + 2, v.z);
      stage_jump(jmp, 4 * i + 3, v.w);
    }
  }
  for (int i = done + t; i < total; i += THREADS) {
    const int v = __ldg(src + i);
    rows[i] = v;
    stage_jump(jmp, i, v);
  }
  __syncthreads();

  STAMP(1)
  // 2. the jump table of the blocks this CTA holds, in registers as
  // int16 pairs: thread t owns the pairs t + i * THREADS, of block i / 2
  unsigned* jw = reinterpret_cast<unsigned*>(jmp);
  unsigned nj[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i)
    nj[i] = i / 2 < ng ? jw[t + i * THREADS] : 0u;

  STAMP(2)
  // 3. LOG_S doubling rounds: J_{r+1}(p) = J_r(J_r(p)); read, then write
  for (int r = 0; r < LOG_S; ++r) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const short* jg = jmp + (i / 2) * B;
      const int q0 = (short)(nj[i] & 0xFFFFu), q1 = (short)(nj[i] >> 16);
      const int n0 = q0 > 0 ? jg[q0 - 1] : q0;
      const int n1 = q1 > 0 ? jg[q1 - 1] : q1;
      nj[i] = (unsigned)(unsigned short)n0 |
              ((unsigned)(unsigned short)n1 << 16);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) jw[t + i * THREADS] = nj[i];
    __syncthreads();
  }

  STAMP(3)
  // 4. the checkpoints c_i = next^(S i)(B), one thread per block, up to
  // the first c <= 0: the walk's fixed point, which every later
  // checkpoint repeats
  const int g = t / NCK, i = t % NCK;
  if (i == 0) {
    const short* jg = jmp + g * B;
    int c = B, k = 0;
    for (; k < NCK && c > 0; ++k) {
      ck[g * NCK + k] = (short)c;
      c = jg[c - 1];
    }
    live[g] = k;
    fixp[g] = c;
  }
  __syncthreads();

  STAMP(4)
  // 5. each thread walks S steps from its checkpoint; the walk
  // overwrites the jump table
  {
    const int* row = rows + (g < ng ? g : 0) * ROW;
    short* walk = jmp + g * WS + widx(S * i);
    int p = i < live[g] ? ck[g * NCK + i] : fixp[g];
#pragma unroll 8
    for (int j = 0; j < S; ++j) {
      walk[j] = (short)p;
      p = next_pos(row, p);
    }
  }
  __syncthreads();

  STAMP(5)
  // 6. decode and store; thread t takes block t % G and every k that is
  // t / G mod THREADS / G, so a warp writes 4 k's x 8 blocks: four full
  // 32-byte sectors of each output
  const int gi = t % G;
  if (gi >= ng) return;
  const int* row = rows + gi * ROW;
  const short* walk = jmp + gi * WS;
  const unsigned b = (unsigned)(b0 + gi);
  const unsigned stride = (unsigned)(THREADS / G) * (unsigned)nb;
  unsigned o = (unsigned)(t / G) * (unsigned)nb + b;
#pragma unroll 4
  for (int k = t / G; k < B; k += THREADS / G, o += stride) {
    const int posv = walk[widx(k)];
    const int v = row[posv < 0 ? posv + ROW : posv];
    const int ln = v >> 25;
    const int s = posv - (posv > 0 ? max(ln, 1) : 0);
    const bool start = ln >= 2 && posv > 0 && s >= 0;
    gsrc[o] = start ? s + (int)(b * B) : -1;
    vals[o] = v;
  }
  STAMP(6)
}

}  // namespace

extern "C" int btt_dp_backtrack(const int* paymat, int* gsrc, int* vals,
                                int nb, cudaStream_t stream) {
  if (nb <= 0 || (long long)nb * B > 0x7FFFFFFFLL) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      dp_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dp_backtrack_kernel<<<(nb + G - 1) / G, THREADS, SMEM_BYTES, stream>>>(
      paymat, gsrc, vals, nb);
  return (int)cudaGetLastError();
}

#ifdef BTT_K4_STAMPS
extern "C" int btt_stamps_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, btt_stamps, sizeof(btt_stamps));
}
#endif
