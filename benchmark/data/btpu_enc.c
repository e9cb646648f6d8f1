/* brotli_tpu native encoder: host-side fast compress path, quality 0-9.
 *
 * Role parity with the reference's c/enc/ fast tiers
 * (compress_fragment*.c q0/q1, backward_references.c q2-9), but an
 * independent design: commands are buffered into arrays per metablock
 * and serialized in a second pass with package-merge *optimal*
 * depth-limited prefix codes (the reference uses a clamp-and-retry
 * heuristic, entropy_encode.c). Match finding is a chained hash with
 * distance-cache probing; the static dictionary is matched through a
 * runtime-built prefix hash with identity / UPPERCASE_FIRST /
 * omit-last cutoff transforms (role of static_dict.c kCutoffTransforms,
 * re-derived from the transform table at init).
 *
 * All format tables come from btpu_tables.h (generated from the Python
 * format layer -- single source of truth; nothing copied from the
 * reference).
 *
 * Build: cc -O2 -shared -fPIC -o libbtpu.so btpu_dec.c btpu_enc.c
 */

#define _GNU_SOURCE  /* qsort_r */
#include <math.h>
#include <stdio.h>
#include <time.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "btpu_tables.h"

#define EERR_ALLOC -3
#define EERR_PARAM -6

#define MAX_HUFF_LEN 15
#define NUM_LIT 256
#define NUM_CMD BTPU_NUM_CMD_SYMS
#define NUM_DIST BTPU_NUM_DIST_SYMS
/* large-window distance alphabet: 16 + (62 << 1) (RFC-LW, npostfix 0) */
#define NUM_DIST_LW 140
#define NUM_LIT_CTX 64
#define MAX_LIT_TREES 48
#define MAX_LIT_TYPES 16
#define MAX_CMD_TYPES 8
#define MAX_DIST_TYPES 6
#define MAX_DIST_TREES 8

/* ---------- bit writer ---------- */

typedef struct {
  uint8_t* buf;
  size_t cap;
  size_t len;     /* whole bytes emitted */
  uint64_t acc;   /* pending bits, LSB-first */
  unsigned nacc;  /* 0..7 after flush */
} BW;

static int bw_reserve(BW* b, size_t extra) {
  if (b->len + extra <= b->cap) return 0;
  size_t ncap = b->cap ? b->cap * 2 : 1 << 16;
  while (ncap < b->len + extra) ncap *= 2;
  uint8_t* nb = (uint8_t*)realloc(b->buf, ncap);
  if (!nb) return EERR_ALLOC;
  b->buf = nb;
  b->cap = ncap;
  return 0;
}

static inline int bw_put(BW* b, uint64_t v, unsigned n) {
  /* n <= 56; caller guarantees v < 2^n */
  b->acc |= v << b->nacc;
  b->nacc += n;
  if (b->nacc >= 32) {
    if (bw_reserve(b, 8)) return EERR_ALLOC;
    while (b->nacc >= 8) {
      b->buf[b->len++] = (uint8_t)b->acc;
      b->acc >>= 8;
      b->nacc -= 8;
    }
  }
  return 0;
}

static int bw_flush_align(BW* b) {
  if (bw_reserve(b, 8)) return EERR_ALLOC;
  while (b->nacc >= 8) {
    b->buf[b->len++] = (uint8_t)b->acc;
    b->acc >>= 8;
    b->nacc -= 8;
  }
  if (b->nacc) {
    b->buf[b->len++] = (uint8_t)b->acc;
    b->acc = 0;
    b->nacc = 0;
  }
  return 0;
}

static size_t bw_bitlen(const BW* b) { return b->len * 8 + b->nacc; }

#include <pthread.h>

/* Shared mutable init (dictionary index, xlogx table) is guarded: the
   ctypes boundary releases the GIL, so concurrent encodes are real. */
static pthread_mutex_t g_init_lock = PTHREAD_MUTEX_INITIALIZER;

/* ---------- package-merge: optimal depth-limited code lengths -------- */

typedef struct {
  uint64_t* w;     /* scratch: weights per level, 2n nodes */
  uint8_t* leaf;   /* scratch: is-leaf flags per level */
  int* idx;       /* sorted symbol order */
  uint32_t* sw;    /* sorted weights */
} PmScratch;

static int pm_cmp_r(const void* a, const void* b, void* ctx) {
  const uint32_t* freq = (const uint32_t*)ctx;
  int ia = *(const int*)a, ib = *(const int*)b;
  uint32_t fa = freq[ia], fb = freq[ib];
  if (fa != fb) return fa < fb ? -1 : 1;
  return ia - ib;
}

/* out[sym] = code length (0 for unused); optimal under maxlen. */
static void pm_lengths(const uint32_t* freq, int n, int maxlen,
                       uint8_t* out, PmScratch* s) {
  int used[1200];
  int nu = 0;
  memset(out, 0, (size_t)n);
  for (int i = 0; i < n; i++)
    if (freq[i]) used[nu++] = i;
  if (nu == 0) return;
  if (nu == 1) {
    out[used[0]] = 1;
    return;
  }
  qsort_r(used, (size_t)nu, sizeof(int), pm_cmp_r, (void*)freq);
  /* level lists: lists[l] has cnt[l] nodes (weights + leaf flags).
     lists[0] = leaves; lists[l] = merge(leaves, pairs of lists[l-1]). */
  int stride = 2 * nu;
  uint64_t* W = s->w;
  uint8_t* LF = s->leaf;
  int cnt[16];
  for (int i = 0; i < nu; i++) {
    W[i] = freq[used[i]];
    LF[i] = 1;
  }
  cnt[0] = nu;
  for (int l = 1; l < maxlen; l++) {
    uint64_t* prev = W + (size_t)(l - 1) * stride;
    uint8_t* prevf = LF + (size_t)(l - 1) * stride;
    (void)prevf;
    uint64_t* cur = W + (size_t)l * stride;
    uint8_t* curf = LF + (size_t)l * stride;
    int npkg = cnt[l - 1] / 2;
    int i = 0, j = 0, k = 0;
    while (i < nu && j < npkg) {
      uint64_t pw = prev[2 * j] + prev[2 * j + 1];
      if ((uint64_t)freq[used[i]] <= pw) {
        cur[k] = freq[used[i]];
        curf[k++] = 1;
        i++;
      } else {
        cur[k] = pw;
        curf[k++] = 0;
        j++;
      }
    }
    while (i < nu) {
      cur[k] = freq[used[i]];
      curf[k++] = 1;
      i++;
    }
    while (j < npkg) {
      cur[k] = prev[2 * j] + prev[2 * j + 1];
      curf[k++] = 0;
      j++;
    }
    cnt[l] = k;
  }
  /* walk down: at each level take the first `take` nodes; leaves among
     them are the smallest leaves and get +1 length. */
  uint8_t lens[1200];
  memset(lens, 0, (size_t)nu);
  int take = 2 * nu - 2;
  for (int l = maxlen - 1; l >= 0; l--) {
    uint8_t* curf = LF + (size_t)l * stride;
    int nleaf = 0;
    for (int i = 0; i < take; i++) nleaf += curf[i];
    for (int i = 0; i < nleaf; i++) lens[i]++;
    take = 2 * (take - nleaf);
    if (take == 0) break;
  }
  for (int i = 0; i < nu; i++) out[used[i]] = lens[i];
}

/* ---------- canonical code assignment (LSB-first stream) ---------- */

static inline uint32_t rev_bits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

static void lengths_to_codes_c(const uint8_t* len, int n, uint16_t* codes) {
  int bl_count[MAX_HUFF_LEN + 1] = {0};
  for (int i = 0; i < n; i++) bl_count[len[i]]++;
  uint32_t next[MAX_HUFF_LEN + 1];
  uint32_t code = 0;
  bl_count[0] = 0;
  for (int l = 1; l <= MAX_HUFF_LEN; l++) {
    code = (code + (uint32_t)bl_count[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; i++) {
    codes[i] = len[i] ? (uint16_t)rev_bits(next[len[i]]++, len[i]) : 0;
  }
}

/* ---------- prefix-code serialization (RFC 3.4 / 3.5) ---------- */

static int emit_repeat(BW* bw, const uint16_t* cl_codes,
                       const uint8_t* cl_lens, int single, int code,
                       int run, int extra_bits, int lit_sym) {
  /* emit `run` repetitions: short runs as plain symbols, longer via the
     16/17 repeat recurrence total' = (total-2)<<eb + 3 + e. */
  if (run <= 0) return 0;
  if (run < 3) {
    for (int i = 0; i < run; i++) {
      if (!single) bw_put(bw, cl_codes[lit_sym], cl_lens[lit_sym]);
    }
    return 0;
  }
  int reps = run - 3;
  int stack[16];
  int sp = 0;
  for (;;) {
    stack[sp++] = reps & ((1 << extra_bits) - 1);
    reps >>= extra_bits;
    if (reps == 0) break;
    reps -= 1;
  }
  while (sp--) {
    if (!single) bw_put(bw, cl_codes[code], cl_lens[code]);
    bw_put(bw, (uint64_t)stack[sp], (unsigned)extra_bits);
  }
  return 0;
}

/* Histogram RLE smoothing before tree building (role parity:
   BrotliOptimizeHistograms / BrotliOptimizeHistogramRle,
   entropy_encode.c:241): replace stretches of similar nonzero counts
   by their average so package-merge assigns them EQUAL depths and the
   code-length sequence collapses into repeat-16 runs. Trades a
   fraction of a percent of payload entropy for a much cheaper tree
   description. Never zeroes a used symbol, so every stream symbol
   keeps a code. Writes the smoothed copy into `out` (>= n). */
static void smooth_hist_rle(const uint32_t* h, int n, uint32_t* out,
                            uint32_t ratio, int min_run) {
  uint64_t total = 0;
  for (int i = 0; i < n; i++) total += h[i];
  memcpy(out, h, (size_t)n * sizeof(uint32_t));
  if (total < 64) return;
  int i = 0;
  while (i < n) {
    if (!h[i]) {
      i++;
      continue;
    }
    /* maximal run [i, j) of similar counts (max <= ratio*min + 4) */
    int j = i + 1;
    uint32_t mn = h[i], mx = h[i];
    uint64_t sum = h[i];
    while (j < n && h[j]) {
      uint32_t nm = h[j] < mn ? h[j] : mn;
      uint32_t nx = h[j] > mx ? h[j] : mx;
      if ((uint64_t)nx > (uint64_t)ratio * nm + 4) break;
      mn = nm;
      mx = nx;
      sum += h[j];
      j++;
    }
    if (j - i >= min_run) {
      uint32_t avg = (uint32_t)((sum + (uint64_t)(j - i) / 2) /
                                (uint64_t)(j - i));
      if (avg == 0) avg = 1;
      for (int k = i; k < j; k++) out[k] = avg;
    }
    i = j;
  }
}

static int write_huffman_code_c(BW* bw, const uint8_t* lengths, int n,
                                int alphabet_size, PmScratch* pm);

/* total bits of (tree description + payload) for `lens` against the
   TRUE histogram; the description is measured exactly by serializing
   into a scratch writer */
static uint64_t tree_total_bits(const uint32_t* h, int n,
                                int alphabet_size, const uint8_t* lens,
                                PmScratch* pm) {
  BW scratch;
  memset(&scratch, 0, sizeof(scratch));
  write_huffman_code_c(&scratch, lens, n, alphabet_size, pm);
  uint64_t bits = scratch.len * 8ull + scratch.nacc;
  free(scratch.buf);
  for (int s = 0; s < n; s++)
    bits += (uint64_t)h[s] * lens[s];
  return bits;
}

/* depth-limited lengths, picking the cheaper of the plain optimal
   depths vs depths from the RLE-smoothed histogram, scored by true
   payload + measured description (the smoothing is a heuristic; this
   makes it never-worse per tree) */
static void pm_lengths_rle(const uint32_t* h, int n, int alphabet_size,
                           uint8_t* lens, PmScratch* pm) {
  pm_lengths(h, n, MAX_HUFF_LEN, lens, pm);
  uint64_t best = tree_total_bits(h, n, alphabet_size, lens, pm);
  static const uint32_t kRatio[] = {2, 4, 8, 24};
  static const int kRun[] = {4, 4, 3, 3};
  uint32_t sm[1200];
  uint8_t lens2[1200];
  for (int v = 0; v < 4; v++) {
    smooth_hist_rle(h, n, sm, kRatio[v], kRun[v]);
    if (memcmp(sm, h, (size_t)n * sizeof(uint32_t)) == 0) continue;
    pm_lengths(sm, n, MAX_HUFF_LEN, lens2, pm);
    uint64_t cost = tree_total_bits(h, n, alphabet_size, lens2, pm);
    if (cost < best) {
      best = cost;
      memcpy(lens, lens2, (size_t)n);
    }
  }
}

static int write_huffman_code_c(BW* bw, const uint8_t* lengths, int n,
                                int alphabet_size, PmScratch* pm) {
  int used[1200];
  int nu = 0;
  for (int i = 0; i < n; i++)
    if (lengths[i]) used[nu++] = i;
  uint8_t one = 1;
  const uint8_t* lens = lengths;
  if (nu == 0) { /* degenerate: 1-symbol code over symbol 0 */
    used[nu++] = 0;
    lens = &one; /* only lens[used[0]] is read below via special-case */
  }
  if (nu <= 4) {
    /* simple form: symbols ordered by (length, value) */
    int order[4];
    for (int i = 0; i < nu; i++) order[i] = used[i];
    for (int i = 1; i < nu; i++) { /* insertion sort by (len, sym) */
      int s = order[i], j = i - 1;
      int sl = (lens == &one) ? 1 : lens[s];
      while (j >= 0) {
        int t = order[j];
        int tl = (lens == &one) ? 1 : lens[t];
        if (tl < sl || (tl == sl && t < s)) break;
        order[j + 1] = t;
        j--;
      }
      order[j + 1] = s;
    }
    bw_put(bw, 1, 2);
    bw_put(bw, (uint64_t)(nu - 1), 2);
    int max_bits = 0;
    while ((1 << max_bits) < alphabet_size) max_bits++;
    for (int i = 0; i < nu; i++)
      bw_put(bw, (uint64_t)order[i], (unsigned)max_bits);
    if (nu == 4) {
      int shape[4];
      for (int i = 0; i < 4; i++) shape[i] = lens[used[i]];
      /* tree-select: depths {1,2,3,3} vs {2,2,2,2} */
      int deep = 0;
      for (int i = 0; i < 4; i++)
        if (shape[i] == 3) deep++;
      bw_put(bw, deep == 2 ? 1 : 0, 1);
    }
    return 0;
  }

  /* complex form: RLE the length sequence, code the cl symbols */
  int last = used[nu - 1];
  uint32_t cl_freq[18] = {0};
  /* first pass: count cl symbols */
  {
    int prev_nz = 8, i = 0;
    while (i <= last) {
      int v = lengths[i], j = i;
      while (j <= last && lengths[j] == v) j++;
      int run = j - i;
      if (v == 0) {
        if (run < 3)
          cl_freq[0] += (uint32_t)run;
        else {
          int reps = run - 3;
          for (;;) {
            cl_freq[17]++;
            reps >>= 3;
            if (reps == 0) break;
            reps -= 1;
          }
        }
      } else {
        if (v != prev_nz) {
          cl_freq[v]++;
          run -= 1;
        }
        prev_nz = v;
        if (run < 3)
          cl_freq[v] += (uint32_t)run;
        else {
          int reps = run - 3;
          for (;;) {
            cl_freq[16]++;
            reps >>= 2;
            if (reps == 0) break;
            reps -= 1;
          }
        }
      }
      i = j;
    }
  }
  uint8_t cl_lens[18];
  uint16_t cl_codes[18];
  pm_lengths(cl_freq, 18, 5, cl_lens, pm);
  lengths_to_codes_c(cl_lens, 18, cl_codes);
  int num_codes = 0;
  for (int i = 0; i < 18; i++)
    if (cl_lens[i]) num_codes++;
  int single = num_codes == 1;

  int skip = 0;
  while (skip < 3 && cl_lens[kClcOrder[skip]] == 0) skip++;
  if (skip == 1) skip = 0;
  bw_put(bw, (uint64_t)skip, 2);
  int space = 32;
  for (int oi = skip; oi < 18; oi++) {
    int v = cl_lens[kClcOrder[oi]];
    bw_put(bw, kClcLenCode[v], kClcLenBits[v]);
    if (v != 0) {
      space -= 32 >> v;
      if (space <= 0) break;
    }
  }
  /* second pass: emit symbol lengths through the cl code */
  {
    int prev_nz = 8, i = 0;
    while (i <= last) {
      int v = lengths[i], j = i;
      while (j <= last && lengths[j] == v) j++;
      int run = j - i;
      if (v == 0) {
        emit_repeat(bw, cl_codes, cl_lens, single, 17, run, 3, 0);
      } else {
        if (v != prev_nz) {
          if (!single) bw_put(bw, cl_codes[v], cl_lens[v]);
          run -= 1;
        }
        prev_nz = v;
        emit_repeat(bw, cl_codes, cl_lens, single, 16, run, 2, v);
      }
      i = j;
    }
  }
  return 0;
}

/* ---------- histogram clustering (greedy agglomerative) ---------- */

static double hist_entropy(const uint32_t* h, int n) {
  uint64_t total = 0;
  for (int i = 0; i < n; i++) total += h[i];
  if (total == 0) return 0.0;
  double bits = 0.0, lt = log2((double)total);
  for (int i = 0; i < n; i++)
    if (h[i]) bits += (double)h[i] * (lt - log2((double)h[i]));
  return bits;
}

/* fast x*log2(x): small-value table, then exponent extraction + a
   2048-bin mantissa lerp (|log2 err| < 4e-8 -- far below clustering
   decision noise; libm log2 was the clustering hot spot on dense
   binary histograms whose counts exceed the table) */
static double g_xlogx[4096];
static double g_log2m[2049];
static volatile int g_xlogx_ready = 0;
static inline double xlogx(uint64_t x) {
  if (x < 4096) return g_xlogx[x];
  double d = (double)x;
  int64_t b;
  memcpy(&b, &d, 8);
  int e = (int)((b >> 52) & 0x7FF) - 1023;
  double fi = (double)(b & 0xFFFFFFFFFFFFFULL) *
              (2048.0 / 4503599627370496.0);
  int i = (int)fi;
  double t = fi - i;
  double lm = g_log2m[i] + t * (g_log2m[i + 1] - g_log2m[i]);
  return d * ((double)e + lm);
}

static void ensure_xlogx(void) {
  pthread_mutex_lock(&g_init_lock);
  if (!g_xlogx_ready) {
    g_xlogx[0] = 0.0;
    for (int i = 1; i < 4096; i++)
      g_xlogx[i] = (double)i * log2((double)i);
    for (int i = 0; i <= 2048; i++)
      g_log2m[i] = log2(1.0 + (double)i / 2048.0);
    g_xlogx_ready = 1;
  }
  pthread_mutex_unlock(&g_init_lock);
}

static double hist_cost(const uint32_t* h, int n) {
  uint64_t total = 0;
  double sx = 0.0;
  for (int i = 0; i < n; i++) {
    total += h[i];
    if (h[i]) sx += xlogx(h[i]);
  }
  if (total == 0) return 0.0;
  return xlogx(total) - sx;
}

static double pair_cost(const uint32_t* a, const uint32_t* b, int n) {
  uint64_t total = 0;
  double sx = 0.0;
  for (int i = 0; i < n; i++) {
    uint32_t v = a[i] + b[i];
    total += v;
    if (v) sx += xlogx(v);
  }
  if (total == 0) return 0.0;
  return xlogx(total) - sx;
}

/* Cluster k histograms (alphabet n) to <= max_trees; fills assign[k]
   and returns the tree count. hists is modified in place (merged rows).
   tree id t's histogram ends up in hists[reps[t]*n]. Gains are cached
   in a k x k matrix; only the merged row is recomputed per step. */
static inline double desc_cost(const uint32_t* h, int n,
                               double per_sym) {
  /* serialized-tree cost estimate: each used symbol needs a
     code-length entry (the BrotliPopulationCost code-description
     role); zero runs RLE away */
  int nnz = 0;
  for (int i = 0; i < n; i++) nnz += h[i] != 0;
  return per_sym * (double)nnz;
}

static int cluster_hists(uint32_t* hists, int k, int n, int max_trees,
                         double table_cost, double per_sym, int* assign,
                         int* reps) {
  double* cost = (double*)malloc(sizeof(double) * (size_t)k);
  int* alive = (int*)malloc(sizeof(int) * (size_t)k);
  int* group_of = (int*)malloc(sizeof(int) * (size_t)k);
  int* remap = (int*)malloc(sizeof(int) * (size_t)k);
  double* gain = (double*)malloc(sizeof(double) * (size_t)k * (size_t)k);
  double* desc = (double*)malloc(sizeof(double) * (size_t)k);
  /* per-row cached best partner: finding the global best pair is an
     O(k) scan instead of O(k^2); only rows whose cached partner was
     touched by a merge rescan their row (amortized O(k) per merge) */
  double* best_g = (double*)malloc(sizeof(double) * (size_t)k);
  int* best_p = (int*)malloc(sizeof(int) * (size_t)k);
  if (!cost || !alive || !group_of || !remap || !gain || !desc ||
      !best_g || !best_p) {
    free(cost);
    free(alive);
    free(group_of);
    free(remap);
    free(gain);
    free(desc);
    free(best_g);
    free(best_p);
    return -1;
  }
#define GAIN(a_, b_) gain[(size_t)(a_) * (size_t)k + (b_)]
  ensure_xlogx();
  int n_alive = 0;
  for (int i = 0; i < k; i++) {
    uint64_t tot = 0;
    for (int s = 0; s < n; s++) tot += hists[(size_t)i * n + s];
    if (tot == 0) {
      /* all-zero row (unused type x context cell): it costs nothing
         and merges freely -- skip it in the O(k^2) clustering and
         absorb it into a neighbor's group afterwards (big context
         maps are mostly empty rows; this is the dominant speedup) */
      alive[i] = 0;
      group_of[i] = -1;
      continue;
    }
    cost[i] = hist_cost(hists + (size_t)i * n, n);
    desc[i] = desc_cost(hists + (size_t)i * n, n, per_sym);
    alive[i] = 1;
    group_of[i] = i;
    n_alive++;
  }
  if (n_alive == 0) { /* degenerate: no symbols at all */
    alive[0] = 1;
    group_of[0] = 0;
    cost[0] = 0;
    desc[0] = 0;
    n_alive = 1;
  }
  /* merged-tree description cost: union support <= sum of supports;
     approximate with max(desc_a, desc_b) (similar rows share most of
     their support) */
  for (int a = 0; a < k; a++) {
    if (!alive[a]) continue;
    for (int b = a + 1; b < k; b++) {
      if (!alive[b]) continue;
      GAIN(a, b) = cost[a] + cost[b] -
                   pair_cost(hists + (size_t)a * n, hists + (size_t)b * n,
                             n) +
                   table_cost + desc[a] + desc[b] -
                   (desc[a] > desc[b] ? desc[a] : desc[b]);
    }
  }
#define GAIN_AT(a_, b_) ((a_) < (b_) ? GAIN(a_, b_) : GAIN(b_, a_))
  /* cache each live row's best partner: the global best pair becomes
     an O(k) scan instead of O(k^2) per merge; only rows whose cached
     partner was touched by a merge rescan their row */
  for (int a = 0; a < k; a++) {
    best_g[a] = -1e300;
    best_p[a] = -1;
    if (!alive[a]) continue;
    for (int b = 0; b < k; b++) {
      if (!alive[b] || b == a) continue;
      double g = GAIN_AT(a, b);
      if (g > best_g[a]) {
        best_g[a] = g;
        best_p[a] = b;
      }
    }
  }
  while (n_alive > 1) {
    double best = -1e300;
    int ba = -1, bb = -1;
    for (int a = 0; a < k; a++) {
      if (!alive[a] || best_p[a] < 0) continue;
      if (best_g[a] > best) {
        best = best_g[a];
        ba = a;
        bb = best_p[a];
      }
    }
    if (ba < 0) break;
    if (best <= 0 && n_alive <= max_trees) break;
    if (bb < ba) { /* canonical order for the updates below */
      int t = ba;
      ba = bb;
      bb = t;
    }
    for (int i = 0; i < n; i++)
      hists[(size_t)ba * n + i] += hists[(size_t)bb * n + i];
    cost[ba] = hist_cost(hists + (size_t)ba * n, n);
    desc[ba] = desc_cost(hists + (size_t)ba * n, n, per_sym);
    alive[bb] = 0;
    for (int i = 0; i < k; i++)
      if (group_of[i] == bb) group_of[i] = ba;
    n_alive--;
    for (int b = 0; b < k; b++) {
      if (!alive[b] || b == ba) continue;
      double g = cost[ba] + cost[b] -
                 pair_cost(hists + (size_t)ba * n,
                           hists + (size_t)b * n, n) +
                 table_cost + desc[ba] + desc[b] -
                 (desc[ba] > desc[b] ? desc[ba] : desc[b]);
      if (b > ba)
        GAIN(ba, b) = g;
      else
        GAIN(b, ba) = g;
      /* ba's gains changed; a partner may improve in O(1) */
      if (g > best_g[b]) {
        best_g[b] = g;
        best_p[b] = ba;
      }
    }
    /* rows whose cached partner was ba or bb rescan their row */
    for (int a = 0; a < k; a++) {
      if (!alive[a]) continue;
      if (a != ba && best_p[a] != ba && best_p[a] != bb) continue;
      best_g[a] = -1e300;
      best_p[a] = -1;
      for (int b = 0; b < k; b++) {
        if (!alive[b] || b == a) continue;
        double g = GAIN_AT(a, b);
        if (g > best_g[a]) {
          best_g[a] = g;
          best_p[a] = b;
        }
      }
    }
  }
#undef GAIN_AT
  /* absorb skipped all-zero rows into the previous live group (RLE-
     friendly in the serialized context map); leading zeros take the
     first live group */
  {
    int first_live = -1;
    for (int i = 0; i < k && first_live < 0; i++)
      if (group_of[i] >= 0) first_live = group_of[i];
    int prev = first_live;
    for (int i = 0; i < k; i++) {
      if (group_of[i] < 0)
        group_of[i] = prev;
      else
        prev = group_of[i];
    }
  }
  /* renumber in first-appearance order */
  int ntrees = 0;
  for (int i = 0; i < k; i++) remap[i] = -1;
  for (int i = 0; i < k; i++) {
    int g = group_of[i];
    if (remap[g] < 0) {
      remap[g] = ntrees;
      reps[ntrees] = g;
      ntrees++;
    }
    assign[i] = remap[g];
  }
#undef GAIN
  free(cost);
  free(alive);
  free(group_of);
  free(remap);
  free(gain);
  free(desc);
  free(best_g);
  free(best_p);
  return ntrees;
}

/* ---------- context map serialization (RFC 7.3) ---------- */

static int write_context_map_c(BW* bw, const int* cmap, int nctx,
                               int ntrees, PmScratch* pm) {
  if (nctx > 1024) return EERR_PARAM; /* seq/sym buffers below */
  /* varlen_uint8(ntrees - 1) */
  int v = ntrees - 1;
  if (v == 0) {
    bw_put(bw, 0, 1);
  } else {
    bw_put(bw, 1, 1);
    int nbits = 0;
    while ((2 << nbits) <= v) nbits++;
    bw_put(bw, (uint64_t)nbits, 3);
    if (nbits) bw_put(bw, (uint64_t)(v - (1 << nbits)), (unsigned)nbits);
  }
  if (ntrees <= 1) return 0;
  /* forward MTF */
  uint8_t mtf[256];
  for (int i = 0; i < 256; i++) mtf[i] = (uint8_t)i;
  uint8_t seq[1024];
  for (int i = 0; i < nctx; i++) {
    uint8_t val = (uint8_t)cmap[i];
    int j = 0;
    while (mtf[j] != val) j++;
    seq[i] = (uint8_t)j;
    memmove(mtf + 1, mtf, (size_t)j);
    mtf[0] = val;
  }
  /* zero-RLE: pick RLEMAX from the longest runs */
  int sym[1024], extra[1024], ebits[1024];
  int ns = 0, rlemax = 0;
  {
    int i = 0;
    while (i < nctx) {
      if (seq[i] != 0) {
        sym[ns] = seq[i];
        extra[ns] = 0;
        ebits[ns++] = 0;
        i++;
        continue;
      }
      int j = i;
      while (j < nctx && seq[j] == 0) j++;
      int run = j - i;
      while (run > 0) {
        if (run == 1) {
          sym[ns] = 0;
          extra[ns] = 0;
          ebits[ns++] = 0;
          run = 0;
        } else {
          int vb = 0;
          while ((2 << vb) <= run) vb++;
          if (vb > 16) vb = 16;
          int ex = run - (1 << vb);
          if (ex > (1 << vb) - 1) ex = (1 << vb) - 1;
          sym[ns] = vb; /* placeholder: run code vb */
          extra[ns] = ex;
          ebits[ns++] = -vb; /* negative marks run codes */
          run -= (1 << vb) + ex;
          if (vb > rlemax) rlemax = vb;
        }
      }
      i = j;
    }
  }
  if (rlemax) {
    bw_put(bw, 1, 1);
    bw_put(bw, (uint64_t)(rlemax - 1), 4);
  } else {
    bw_put(bw, 0, 1);
  }
  int alphabet = ntrees + rlemax;
  uint32_t freq[300];
  memset(freq, 0, sizeof(uint32_t) * (size_t)alphabet);
  for (int i = 0; i < ns; i++) {
    int s = ebits[i] < 0 ? sym[i] : (sym[i] ? sym[i] + rlemax : 0);
    freq[s]++;
  }
  uint8_t lens[300];
  uint16_t codes[300];
  pm_lengths(freq, alphabet, MAX_HUFF_LEN, lens, pm);
  write_huffman_code_c(bw, lens, alphabet, alphabet, pm);
  int used = 0;
  for (int i = 0; i < alphabet; i++)
    if (lens[i]) used++;
  lengths_to_codes_c(lens, alphabet, codes);
  for (int i = 0; i < ns; i++) {
    int s = ebits[i] < 0 ? sym[i] : (sym[i] ? sym[i] + rlemax : 0);
    if (used > 1) bw_put(bw, codes[s], lens[s]);
    if (ebits[i] < 0) bw_put(bw, (uint64_t)extra[i], (unsigned)(-ebits[i]));
  }
  bw_put(bw, 1, 1); /* IMTF */
  return 0;
}

/* ---------- static dictionary matcher ---------- */

typedef struct {
  uint32_t word_off; /* offset of word bytes in dict blob */
  uint16_t idx;      /* index within its length bucket */
  uint8_t len;
} DictEntry;

#define DICT_HBITS 15
#define DICT_HSIZE (1 << DICT_HBITS)

/* affix transforms (identity / uppercase-first core with literal
   prefix and/or suffix additions): matched by byte-comparing the
   input against prefix + core(word) + suffix (static_dict.c role,
   generalized from the reference's hand-picked suffix checks) */
typedef struct {
  uint8_t tid;
  uint8_t uc;       /* core: 0 identity, 1 uppercase-first */
  uint8_t plen, slen;
  uint16_t poff, soff;  /* into kTransformPool */
} AffixTf;

typedef struct {
  uint32_t word_off;
  uint16_t idx;
  uint8_t len;
  uint8_t k;               /* omitted leading bytes */
} OmitEntry;

typedef struct {
  const uint8_t* blob;
  DictEntry* entries;       /* grouped by bucket */
  uint32_t start[DICT_HSIZE + 1];
  OmitEntry* of_entries;    /* omit-first forms, bucketed by the hash
                               of the word's post-omit 4-byte prefix */
  uint32_t of_start[DICT_HSIZE + 1];
  int omit_last_id[10];     /* bare omit-last-k transform id, 1..9 */
  int omit_first_id[10];    /* bare omit-first-k transform id, 1..9 */
  int uc_first_id;
  int uc_all_id;            /* bare UPPERCASE_ALL transform id */
  AffixTf suf[121];         /* no-prefix, suffix-only forms */
  int nsuf;
  AffixTf pre[121];         /* prefix forms, sorted by first prefix
                               byte (suffix may be present) */
  int npre;
  uint8_t pre_start[257];   /* CSR over pre[] keyed by first byte */
  int ready;
} DictIndex;

static DictIndex g_dict;

static inline uint32_t dict_hash4(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return (uint32_t)((v * 0x9E3779B1u) >> (32 - DICT_HBITS));
}

static int dict_index_init_locked(const uint8_t* blob);

static int dict_index_init(const uint8_t* blob) {
  pthread_mutex_lock(&g_init_lock);
  int rc = dict_index_init_locked(blob);
  pthread_mutex_unlock(&g_init_lock);
  return rc;
}

static int dict_index_init_locked(const uint8_t* blob) {
  if (g_dict.ready && g_dict.blob == blob) return 0;
  free(g_dict.entries);
  free(g_dict.of_entries);
  memset(&g_dict, 0, sizeof(g_dict));
  g_dict.blob = blob;
  g_dict.uc_first_id = -1;
  g_dict.uc_all_id = -1;
  for (int k = 1; k <= 9; k++) {
    g_dict.omit_last_id[k] = -1;
    g_dict.omit_first_id[k] = -1;
  }
  for (int t = 0; t < 121; t++) {
    int op = kTransformOp[t];
    if (!kTransformPrefixLen[t] && !kTransformSuffixLen[t]) {
      if (op == 1 && g_dict.uc_first_id < 0) g_dict.uc_first_id = t;
      if (op == 2 && g_dict.uc_all_id < 0) g_dict.uc_all_id = t;
      if (op >= 21 && op <= 29 && g_dict.omit_last_id[op - 20] < 0)
        g_dict.omit_last_id[op - 20] = t;
      if (op >= 11 && op <= 19 && g_dict.omit_first_id[op - 10] < 0)
        g_dict.omit_first_id[op - 10] = t;
      continue;
    }
    /* affix forms: identity / uppercase-first / uppercase-all cores */
    if (op != 0 && op != 1 && op != 2) continue;
    AffixTf a;
    a.tid = (uint8_t)t;
    a.uc = (uint8_t)op;
    a.plen = kTransformPrefixLen[t];
    a.poff = kTransformPrefixOff[t];
    a.slen = kTransformSuffixLen[t];
    a.soff = kTransformSuffixOff[t];
    if (a.plen == 0)
      g_dict.suf[g_dict.nsuf++] = a;
    else
      g_dict.pre[g_dict.npre++] = a;
  }
  /* counting sort the prefix forms by first prefix byte so probes
     only visit entries whose prefix can match at all */
  {
    int cnt[256];
    memset(cnt, 0, sizeof(cnt));
    for (int i = 0; i < g_dict.npre; i++)
      cnt[kTransformPool[g_dict.pre[i].poff]]++;
    int acc = 0;
    for (int b = 0; b < 256; b++) {
      g_dict.pre_start[b] = (uint8_t)acc;
      acc += cnt[b];
    }
    g_dict.pre_start[256] = (uint8_t)acc;
    AffixTf tmp[121];
    int w[256];
    for (int b = 0; b < 256; b++) w[b] = g_dict.pre_start[b];
    for (int i = 0; i < g_dict.npre; i++)
      tmp[w[kTransformPool[g_dict.pre[i].poff]]++] = g_dict.pre[i];
    memcpy(g_dict.pre, tmp, sizeof(AffixTf) * (size_t)g_dict.npre);
  }
  /* count words */
  size_t total = 0;
  for (int L = 4; L <= 24; L++)
    if (kDictSizeBits[L]) total += (size_t)1 << kDictSizeBits[L];
  uint32_t* counts = (uint32_t*)calloc(DICT_HSIZE + 1, sizeof(uint32_t));
  DictEntry* ents = (DictEntry*)malloc(sizeof(DictEntry) * total);
  if (!counts || !ents) {
    free(counts);
    free(ents);
    return EERR_ALLOC;
  }
  for (int L = 4; L <= 24; L++) {
    if (!kDictSizeBits[L]) continue;
    uint32_t cnt = 1u << kDictSizeBits[L];
    uint32_t off = kDictOffsets[L];
    for (uint32_t i = 0; i < cnt; i++)
      counts[dict_hash4(blob + off + (size_t)i * L)]++;
  }
  uint32_t acc = 0;
  for (int h = 0; h <= DICT_HSIZE; h++) {
    uint32_t c = h < DICT_HSIZE ? counts[h] : 0;
    g_dict.start[h] = acc;
    counts[h] = acc;
    acc += c;
  }
  for (int L = 4; L <= 24; L++) {
    if (!kDictSizeBits[L]) continue;
    uint32_t cnt = 1u << kDictSizeBits[L];
    uint32_t off = kDictOffsets[L];
    for (uint32_t i = 0; i < cnt; i++) {
      uint32_t woff = off + (uint32_t)((size_t)i * L);
      uint32_t h = dict_hash4(blob + woff);
      DictEntry* e = &ents[counts[h]++];
      e->word_off = woff;
      e->idx = (uint16_t)i;
      e->len = (uint8_t)L;
    }
  }
  /* omit-first index: for each word and omitted-count k with a bare
     transform, key on the post-omit 4-byte prefix */
  {
    size_t oftotal = 0;
    for (int L = 4; L <= 24; L++) {
      if (!kDictSizeBits[L]) continue;
      uint32_t cnt = 1u << kDictSizeBits[L];
      for (int k = 1; k <= 9 && L - k >= 4; k++)
        if (g_dict.omit_first_id[k] >= 0) oftotal += cnt;
    }
    uint32_t* ofc = (uint32_t*)calloc(DICT_HSIZE + 1, sizeof(uint32_t));
    OmitEntry* ofe = (OmitEntry*)malloc(sizeof(OmitEntry) * oftotal);
    if (!ofc || !ofe) {
      free(ofc);
      free(ofe);
      free(counts);
      free(ents);
      memset(&g_dict, 0, sizeof(g_dict));
      return EERR_ALLOC;
    }
    for (int L = 4; L <= 24; L++) {
      if (!kDictSizeBits[L]) continue;
      uint32_t cnt = 1u << kDictSizeBits[L];
      uint32_t off = kDictOffsets[L];
      for (uint32_t i = 0; i < cnt; i++)
        for (int k = 1; k <= 9 && L - k >= 4; k++)
          if (g_dict.omit_first_id[k] >= 0)
            ofc[dict_hash4(blob + off + (size_t)i * L + k)]++;
    }
    uint32_t acc2 = 0;
    for (int h = 0; h <= DICT_HSIZE; h++) {
      uint32_t c = h < DICT_HSIZE ? ofc[h] : 0;
      g_dict.of_start[h] = acc2;
      ofc[h] = acc2;
      acc2 += c;
    }
    for (int L = 4; L <= 24; L++) {
      if (!kDictSizeBits[L]) continue;
      uint32_t cnt = 1u << kDictSizeBits[L];
      uint32_t off = kDictOffsets[L];
      for (uint32_t i = 0; i < cnt; i++) {
        uint32_t woff = off + (uint32_t)((size_t)i * L);
        for (int k = 1; k <= 9 && L - k >= 4; k++) {
          if (g_dict.omit_first_id[k] < 0) continue;
          OmitEntry* e = &ofe[ofc[dict_hash4(blob + woff + k)]++];
          e->word_off = woff;
          e->idx = (uint16_t)i;
          e->len = (uint8_t)L;
          e->k = (uint8_t)k;
        }
      }
    }
    free(ofc);
    g_dict.of_entries = ofe;
  }
  free(counts);
  g_dict.entries = ents;
  g_dict.ready = 1;
  return 0;
}

static inline size_t common_len(const uint8_t* a, const uint8_t* b,
                                size_t max) {
  size_t i = 0;
  while (i + 8 <= max) {
    uint64_t x, y;
    memcpy(&x, a + i, 8);
    memcpy(&y, b + i, 8);
    uint64_t d = x ^ y;
    if (d) return i + (size_t)(__builtin_ctzll(d) >> 3);
    i += 8;
  }
  while (i < max && a[i] == b[i]) i++;
  return i;
}

/* Probe the static dictionary at data[pos..]; returns output length (0
   = no match) and fills copy-code value, transform id, word index and
   word length. */
static int dict_probe(const uint8_t* data, size_t pos, size_t n,
                      int min_out, int level, int* out_copy,
                      int* out_tid, uint32_t* out_idx, int* out_wlen) {
  if (pos + 4 > n || !g_dict.ready) return 0;
  size_t rem = n - pos;
  const uint8_t* p = data + pos;
  int best_out = 0, best_copy = 0, best_tid = 0, best_wlen = 0;
  uint32_t best_idx = 0;
  int best_score = 0;
#define DICT_TAKE(out_, score_, tid_, idx_, wlen_)                     \
  do {                                                                 \
    if ((out_) >= min_out && (score_) > best_score) {                  \
      best_score = (score_);                                           \
      best_out = (out_);                                               \
      best_copy = (wlen_);                                             \
      best_tid = (tid_);                                               \
      best_idx = (idx_);                                               \
      best_wlen = (wlen_);                                             \
    }                                                                  \
  } while (0)
  for (int tf = 0; tf < 3; tf++) {
    uint8_t first = p[0];
    uint8_t key[4];
    if (tf >= 1) {
      if (first < 'A' || first > 'Z') break;
      if (tf == 1) {
        if (g_dict.uc_first_id < 0) break;
        key[0] = (uint8_t)(first | 0x20);
        key[1] = p[1];
        key[2] = p[2];
        key[3] = p[3];
      } else {
        /* uppercase-all (ASCII): lowercase every A-Z key byte; skip
           unless a second input byte is also uppercase (else ucfirst
           already covers it) */
        if (g_dict.uc_all_id < 0) break;
        if (!(p[1] >= 'A' && p[1] <= 'Z')) break;
        for (int b = 0; b < 4; b++)
          key[b] = (uint8_t)(p[b] >= 'A' && p[b] <= 'Z' ? p[b] | 0x20
                                                        : p[b]);
      }
    }
    uint32_t h = dict_hash4(tf ? key : p);
    uint32_t lo = g_dict.start[h], hi = g_dict.start[h + 1];
    for (uint32_t e = lo; e < hi; e++) {
      const DictEntry* de = &g_dict.entries[e];
      const uint8_t* w = g_dict.blob + de->word_off;
      int L = de->len;
      if (tf == 1) {
        if (w[0] != key[0]) continue;
        size_t m1 = 1 + common_len(p + 1, w + 1,
                                   (rem < (size_t)L ? rem : (size_t)L) - 1);
        if ((int)m1 != L) continue; /* uc_first: full word only */
        DICT_TAKE(L, L * 128 - 140, g_dict.uc_first_id, de->idx, L);
        /* uppercase-first + suffix forms */
        for (int s = 0; level >= 1 && s < g_dict.nsuf; s++) {
          const AffixTf* a = &g_dict.suf[s];
          if (a->uc != 1) continue;
          int out = L + a->slen;
          if ((size_t)out > rem) continue;
          if (memcmp(p + L, kTransformPool + a->soff, a->slen)) continue;
          DICT_TAKE(out, out * 128 - 170, a->tid, de->idx, L);
        }
        continue;
      }
      if (tf == 2) {
        if ((size_t)L > rem) continue;
        int ok = 1;
        for (int b = 0; b < L; b++) {
          uint8_t c = w[b];
          if (c >= 0xC0) { /* RFC ToUpperCase rewrites rune tails */
            ok = 0;
            break;
          }
          uint8_t up = (uint8_t)(c >= 'a' && c <= 'z' ? c - 32 : c);
          if (p[b] != up) {
            ok = 0;
            break;
          }
        }
        if (!ok) continue;
        DICT_TAKE(L, L * 128 - 170, g_dict.uc_all_id, de->idx, L);
        for (int s = 0; level >= 1 && s < g_dict.nsuf; s++) {
          const AffixTf* a = &g_dict.suf[s];
          if (a->uc != 2) continue;
          int out = L + a->slen;
          if ((size_t)out > rem) continue;
          if (memcmp(p + L, kTransformPool + a->soff, a->slen)) continue;
          DICT_TAKE(out, out * 128 - 190, a->tid, de->idx, L);
        }
        continue;
      }
      size_t cap = rem < (size_t)L ? rem : (size_t)L;
      size_t m = common_len(p, w, cap);
      if ((int)m == L) { /* identity (full word) */
        DICT_TAKE(L, L * 128, 0, de->idx, L);
        /* identity + suffix forms (word followed by " ", " the ",
           ", ", ...) cover MORE input per reference */
        for (int s = 0; level >= 1 && s < g_dict.nsuf; s++) {
          const AffixTf* a = &g_dict.suf[s];
          if (a->uc != 0) continue;
          int out = L + a->slen;
          if ((size_t)out > rem) continue;
          if (memcmp(p + L, kTransformPool + a->soff, a->slen)) continue;
          DICT_TAKE(out, out * 128 - 150, a->tid, de->idx, L);
        }
      } else if ((int)m >= min_out && m >= 6 && L - (int)m <= 9 &&
                 g_dict.omit_last_id[L - (int)m] >= 0) {
        DICT_TAKE((int)m, (int)m * 128 - 160,
                  g_dict.omit_last_id[L - (int)m], de->idx, L);
      }
    }
  }
  /* prefix forms: input must start with the literal prefix; the word
     match begins after it (e.g. " the " + word, " " + word) */
  if (level >= 2) {
    uint32_t ph = 0;
    int ph_plen = -1;
    int s0 = g_dict.pre_start[p[0]];
    int s1 = g_dict.pre_start[(int)p[0] + 1];
    for (int s = s0; s < s1; s++) {
      const AffixTf* a = &g_dict.pre[s];
      size_t need = (size_t)a->plen + 4;
      if (need > rem) continue;
      if (memcmp(p, kTransformPool + a->poff, a->plen)) continue;
      const uint8_t* q = p + a->plen;
      uint8_t key[4];
      if (a->uc == 1) {
        if (q[0] < 'A' || q[0] > 'Z') continue;
        key[0] = (uint8_t)(q[0] | 0x20);
        key[1] = q[1];
        key[2] = q[2];
        key[3] = q[3];
      } else if (a->uc == 2) {
        if (q[0] < 'A' || q[0] > 'Z') continue;
        for (int b = 0; b < 4; b++)
          key[b] = (uint8_t)(q[b] >= 'A' && q[b] <= 'Z' ? q[b] | 0x20
                                                        : q[b]);
      }
      uint32_t h;
      if (!a->uc && a->plen == ph_plen) {
        h = ph;
      } else {
        h = dict_hash4(a->uc ? key : q);
        if (!a->uc) {
          ph = h;
          ph_plen = a->plen;
        }
      }
      size_t qrem = rem - a->plen;
      uint32_t lo = g_dict.start[h], hi = g_dict.start[h + 1];
      for (uint32_t e = lo; e < hi; e++) {
        const DictEntry* de = &g_dict.entries[e];
        const uint8_t* w = g_dict.blob + de->word_off;
        int L = de->len;
        if ((size_t)L + a->slen > qrem) continue;
        if (a->uc == 1) {
          if (w[0] != key[0]) continue;
          size_t m1 = 1 + common_len(q + 1, w + 1, (size_t)L - 1);
          if ((int)m1 != L) continue;
        } else if (a->uc == 2) {
          int ok = 1;
          for (int b = 0; b < L; b++) {
            uint8_t c = w[b];
            if (c >= 0xC0) { /* multi-byte rune: ToUpperCase rewrites */
              ok = 0;
              break;
            }
            uint8_t up = (uint8_t)(c >= 'a' && c <= 'z' ? c - 32 : c);
            if (q[b] != up) {
              ok = 0;
              break;
            }
          }
          if (!ok) continue;
        } else {
          if (common_len(q, w, (size_t)L) != (size_t)L) continue;
        }
        if (a->slen &&
            memcmp(q + L, kTransformPool + a->soff, a->slen))
          continue;
        int out = a->plen + L + a->slen;
        DICT_TAKE(out, out * 128 - 160, a->tid, de->idx, L);
      }
    }
  }
  /* omit-first forms: the input matches a word minus its first k
     bytes (bare transforms only; keyed on the post-omit prefix).
     Reserved for the optimal-parse tier: the DP prices these huge
     distances exactly, while the greedy tiers' acceptance rule
     overpays for them (q9 measured +0.2% with them enabled). */
  if (level >= 3) {
    uint32_t h = dict_hash4(p);
    uint32_t lo = g_dict.of_start[h], hi = g_dict.of_start[h + 1];
    for (uint32_t e = lo; e < hi; e++) {
      const OmitEntry* oe = &g_dict.of_entries[e];
      int out = oe->len - oe->k;
      if ((size_t)out > rem) continue;
      const uint8_t* w = g_dict.blob + oe->word_off + oe->k;
      if (common_len(p, w, (size_t)out) != (size_t)out) continue;
      DICT_TAKE(out, out * 128 - 160, g_dict.omit_first_id[oe->k],
                oe->idx, oe->len);
    }
  }
#undef DICT_TAKE
  if (!best_out) return 0;
  *out_copy = best_copy;
  *out_tid = best_tid;
  *out_idx = best_idx;
  *out_wlen = best_wlen;
  return best_out;
}

/* ---------- LZ match finder ---------- */

typedef struct {
  uint32_t ins;  /* literal count before the copy */
  uint32_t cpy;  /* copy length CODE value (0 = final insert-only) */
  uint32_t dist; /* distance (0 = final insert-only) */
  uint32_t adv;  /* bytes of input consumed by the copy; flag in top bit */
} Cmd;
#define CMD_DICT 0x80000000u /* adv top bit: no ring push */

typedef struct {
  /* bucket-ring hasher (role: c/enc/hash_longest_match_inc.h H5/H6):
     each hash owns a small ring of the last `1<<block_bits` positions,
     stored contiguously -- the candidate walk is a linear scan of one
     or two cache lines instead of dependent loads through a
     window-sized chain table */
  uint32_t* bucket; /* [1<<hbits][1<<block_bits] pos+1 ring */
  uint32_t* num;    /* [1<<hbits] insert counter per bucket */
  int hbits;
  int block_bits;
  int depth;     /* candidate walk budget (<= 1<<block_bits) */
  int lazy;      /* lazy matching on */
  int use_dict;  /* static dictionary probing on */
  int min_len;
  int h4;        /* hash 4-byte prefixes (q10/11 DP: sees len-4 matches) */
  int h8;        /* hash 8-byte prefixes (hash8 role note) */
  /* long-range table (role: the reference's rolling-hash composite
     hashers H35/H55/H65, hash_rolling_inc.h + quality.h:206-222):
     a second sparse table keyed on 16-byte prefixes.
     Window-scale repeats (multi-MB distances) flood the
     primary rings' few slots with near occurrences; a 16-byte key is
     near-unique in text, so a handful of slots per bucket survive a
     whole 4 MB window and one probe hit anywhere inside a long repeat
     recovers the rest via the distance cache. lr_bits == 0 disables. */
  uint32_t* lr_tab;    /* [1<<lr_bits][8]: {count, pos+1 x4, pad x3} --
                          one 32-byte record per bucket so probe and
                          insert each touch ONE cache line */
  int lr_bits;
  int lr_gate;   /* probe the LR table when the local match < this */
  struct BTreeS* bt;   /* non-NULL: binary-tree candidate source for
                          the optimal-parse DP (H10 role; see bt_walk) */
} MatchCfg;

#define LR_RING_BITS 2   /* 4-entry rings */
#define LR_REC_SHIFT 3   /* 8 uint32 per bucket record */
static int g_lr_min = 16; /* accept threshold for long-range matches
                             (the 16-byte key means accepted lengths
                             are >= 16 in practice anyway) */
#define LR_MIN_LEN g_lr_min

static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static inline uint32_t hash5(const uint8_t* p, int hbits) {
  return (uint32_t)(((load64(p) & 0xFFFFFFFFFFull) *
                     0x1FE35A7BD3579BD3ull) >> (64 - hbits));
}

static inline uint32_t hash4n(const uint8_t* p, int hbits) {
  return (uint32_t)(((load64(p) & 0xFFFFFFFFull) *
                     0x1FE35A7BD3579BD3ull) >> (64 - hbits));
}

static inline uint32_t hash8(const uint8_t* p, int hbits) {
  /* 8-byte key (role: the reference's H6 hash_longest_match64, chosen
     by ChooseHasher for q5-9 with a >=1MB size hint, quality.h:183-191):
     common text 4/5-grams flood small rings within KBs, so long keys
     are what lets a small-ring hasher see window-scale distances */
  return (uint32_t)((load64(p) * 0x1FE35A7BD3579BD3ull) >> (64 - hbits));
}

static inline uint32_t hash16(const uint8_t* p, int hbits) {
  uint64_t x = load64(p) * 0x9E3779B185EBCA87ull;
  x ^= load64(p + 8) * 0xC2B2AE3D27D4EB4Full;
  return (uint32_t)((x * 0x165667B19E3779F9ull) >> (64 - hbits));
}

typedef struct {
  size_t len;
  size_t dist;
  int score;
} MatchResult;

static inline int match_score(size_t len, size_t dist, int cache_slot) {
  int bl = 0;
  size_t d = dist;
  while (d) {
    bl++;
    d >>= 1;
  }
  int s = (int)len * 128 - 8 * bl;
  if (cache_slot == 0) s += 120;
  else if (cache_slot > 0) s += 70;
  return s;
}

#define MAX_COPY_LEN ((size_t)1 << 22) /* keeps copy codes + mlen in range */

/* long-range probe gate: probe only when the local match is shorter
   than this (the probe exists to rescue UNDER-matched positions; a
   confident local match already wins on score and the probe's two
   cold cache lines are the single biggest find_match cost) */
static int g_lr_gate = -1; /* <0: use the per-quality cfg->lr_gate */
static void lr_gate_init(void) {
  const char* v = getenv("BTPU_LR_GATE");
  if (v) g_lr_gate = atoi(v);
  v = getenv("BTPU_LR_MIN");
  if (v) g_lr_min = atoi(v);
}

static void find_match(const uint8_t* data, size_t pos, size_t n,
                       size_t maxback, const uint32_t* ring,
                       const MatchCfg* cfg, MatchResult* out) {
  out->len = 0;
  out->dist = 0;
  out->score = 0;
  size_t rem = n - pos;
  if (rem < 4) return;
  size_t maxd = pos < maxback ? pos : maxback;
  const uint8_t* p = data + pos;
  size_t limit = rem < MAX_COPY_LEN ? rem : MAX_COPY_LEN;
  /* distance-cache probe */
  for (int s = 0; s < 4; s++) {
    size_t d = ring[s];
    if (d == 0 || d > maxd) continue;
    if (s > 0 && (d == ring[0] || (s > 1 && d == ring[1]) ||
                  (s > 2 && d == ring[2])))
      continue;
    const uint8_t* q = p - d;
    if (q[0] != p[0]) continue;
    size_t l = common_len(p, q, limit);
    if (l >= 3) {
      int sc = match_score(l, d, s);
      if (sc > out->score) {
        out->score = sc;
        out->len = l;
        out->dist = d;
      }
    }
  }
  /* bucket-ring walk, newest to oldest (positions in a bucket only
     grow, so distances only grow -- the window check is a break).
     (A two-pass prefetch-then-evaluate variant measured SLOWER on
     this host -- 114 -> 77 MB/s q5/16MB -- so the walk stays serial.) */
  uint32_t h = cfg->h4 ? hash4n(p, cfg->hbits)
               : cfg->h8 ? hash8(p, cfg->hbits)
                         : hash5(p, cfg->hbits);
  uint32_t cnt = cfg->num[h];
  uint32_t bmask = (1u << cfg->block_bits) - 1;
  const uint32_t* bk = cfg->bucket + ((size_t)h << cfg->block_bits);
  uint32_t iters = cnt < bmask + 1u ? cnt : bmask + 1u;
  if (iters > (uint32_t)cfg->depth) iters = (uint32_t)cfg->depth;
  size_t best_len = out->len > 4 ? out->len : 3;
  for (uint32_t i = 1; i <= iters; i++) {
    size_t cand = (size_t)bk[(cnt - i) & bmask] - 1;
    size_t d = pos - cand;
    if (d > maxd) break;
    const uint8_t* q = data + cand;
    if (best_len >= limit) break;
    if (q[best_len] == p[best_len]) {
      size_t l = common_len(p, q, limit);
      if (l > best_len) {
        int sc = match_score(l, d, -1);
        if (sc > out->score) {
          out->score = sc;
          out->len = l;
          out->dist = d;
          best_len = l;
        }
      }
    }
  }
  /* long-range probe: 16-byte-keyed ring, newest to oldest (see
     MatchCfg.lr_tab). Only improvements past LR_MIN_LEN count -- a
     short match at multi-MB distance prices worse than literals --
     and a local match >= 32 already wins on score, so the probe is
     skipped there (it exists to rescue UNDER-matched positions). */
  if (cfg->lr_bits && rem >= LR_MIN_LEN &&
      (int)out->len < (g_lr_gate >= 0 ? g_lr_gate : cfg->lr_gate)) {
    uint32_t lh = hash16(p, cfg->lr_bits);
    const uint32_t* lbk = cfg->lr_tab + ((size_t)lh << LR_REC_SHIFT);
    uint32_t lcnt = lbk[0];
    uint32_t lit = lcnt < (1u << LR_RING_BITS) ? lcnt
                                               : (1u << LR_RING_BITS);
    size_t lbest = out->len > LR_MIN_LEN - 1 ? out->len
                                             : LR_MIN_LEN - 1;
    for (uint32_t i = 1; i <= lit; i++) {
      size_t cand = (size_t)lbk[1 + ((lcnt - i) &
                                     ((1u << LR_RING_BITS) - 1))] - 1;
      size_t d = pos - cand;
      if (d > maxd) break;
      const uint8_t* q = data + cand;
      if (lbest >= limit) break;
      if (q[lbest] == p[lbest] && q[0] == p[0]) {
        size_t l = common_len(p, q, limit);
        if (l > lbest) {
          int sc = match_score(l, d, -1);
          if (sc > out->score) {
            out->score = sc;
            out->len = l;
            out->dist = d;
            lbest = l;
          }
        }
      }
    }
  }
  if (out->len < (size_t)cfg->min_len) {
    out->len = 0;
    out->dist = 0;
    out->score = 0;
  }
}

/* lr = 0 skips the long-range insert: inside a committed match's
   interior the 16-gram at pos equals the one at pos-dist, which is
   already in the table -- re-inserting only evicts other entries.
   Front-line positions insert at EVERY position (a strided gate
   couples badly with the miss-run stride: both walk the same residue
   class, so whole inputs could end up with zero long-range entries). */
static inline void lr_insert(const uint8_t* data, size_t pos,
                             const MatchCfg* cfg) {
  uint32_t lh = hash16(data + pos, cfg->lr_bits);
  uint32_t* lbk = cfg->lr_tab + ((size_t)lh << LR_REC_SHIFT);
  uint32_t lcnt = lbk[0];
  lbk[1 + (lcnt & ((1u << LR_RING_BITS) - 1))] = (uint32_t)(pos + 1);
  lbk[0] = lcnt + 1;
}

static inline void insert_hash_ex(const uint8_t* data, size_t pos,
                                  const MatchCfg* cfg, int lr) {
  uint32_t h = cfg->h4 ? hash4n(data + pos, cfg->hbits)
               : cfg->h8 ? hash8(data + pos, cfg->hbits)
                         : hash5(data + pos, cfg->hbits);
  uint32_t cnt = cfg->num[h];
  cfg->bucket[((size_t)h << cfg->block_bits) +
              (cnt & ((1u << cfg->block_bits) - 1))] =
      (uint32_t)(pos + 1);
  cfg->num[h] = cnt + 1;
  /* stride-2 long-range inserts: the insert (hash16 + a record-line
     write) was ~25% of q5 wall. A stride is safe against the
     residue-coupling failure ONLY because probes are per-position:
     a probe at p hits the entry at p-D whenever (p-D) is even --
     half of all probes regardless of p's or D's parity. (The
     original bug was strided inserts x strided probes: both walked
     the same residue class and whole inputs got zero entries.) */
  if (lr && cfg->lr_bits && !(pos & 1)) lr_insert(data, pos, cfg);
}

static inline void insert_hash(const uint8_t* data, size_t pos,
                               const MatchCfg* cfg) {
  insert_hash_ex(data, pos, cfg, 1);
}

/* ---------- binary-tree matcher (q10/11 DP candidate source) ----------
 *
 * Role parity: the reference's H10 hash-to-binary-tree
 * (c/enc/hash_to_binary_tree_inc.h), the hasher ChooseHasher assigns
 * to the zopfli tiers (quality.h:174-175). Design is the classic BT4
 * structure, written from scratch: per 4-byte hash a tree of previous
 * positions ordered by suffix; inserting a position re-roots its
 * bucket and splits the old tree into < / > subtrees while collecting
 * the increasing-length candidate set. A depth-64 descent replaces
 * the 2048-entry ring walk (the q11 profile's top cost) with ~64
 * string compares that START at the accumulated common-prefix bound,
 * so total compare work stays near-linear. */

#define BT_HBITS 17
#define BT_DEPTH 64
/* tree-compare cap: identical strings longer than this collapse into
   one node (the new position adopts the old node's children), which
   keeps the tree healthy on repetitive data -- an uncapped compare
   walked megabyte common prefixes per insert on the 16MB repeat
   corpus (0.06 MB/s). The true length of the longest candidate is
   recovered OUTSIDE the tree by one extension (see opt_parse_block).
   The reference caps H10 compares the same way (max_comp_len,
   hash_to_binary_tree_inc.h). */
#ifndef BT_MAX_CMP
#define BT_MAX_CMP 128
#endif

typedef struct BTreeS {
  uint32_t* head; /* [1<<BT_HBITS] root pos+1 per hash */
  uint32_t* lr;   /* [2 * wsize]: {left, right} child pos+1 per slot */
  size_t wmask;   /* wsize - 1, wsize = pow2 >= min(n, window) */
  int open_end;   /* more input may follow the data compared so far
                     (the stream encoder) */
} BTree;

static int bt_alloc(BTree* bt, size_t n, size_t window) {
  size_t w = n < window ? n : window;
  size_t ws = 1;
  while (ws < w) ws <<= 1;
  if (ws < 256) ws = 256;
  bt->wmask = ws - 1;
  bt->head = (uint32_t*)calloc((size_t)1 << BT_HBITS, sizeof(uint32_t));
  bt->lr = (uint32_t*)calloc(2 * ws, sizeof(uint32_t));
  return (bt->head && bt->lr) ? 0 : EERR_ALLOC;
}

static void bt_free(BTree* bt) {
  if (!bt) return;
  free(bt->head);
  free(bt->lr);
  bt->head = NULL;
  bt->lr = NULL;
}

/* Insert data[pos..] into the tree and collect candidates with
   strictly increasing match length (>= min_len) into out_cand/out_len
   (capacity BT_DEPTH; pass NULL to insert without collecting).
   `limit` caps compared length. Returns the candidate count. */
static inline size_t bt_walk(BTree* bt, const uint8_t* data, size_t pos,
                             size_t maxd, size_t limit, int depth,
                             size_t min_len, uint32_t* out_cand,
                             uint32_t* out_len) {
  uint32_t h = hash4n(data + pos, BT_HBITS);
  size_t cur = (size_t)bt->head[h];
  bt->head[h] = (uint32_t)(pos + 1);
  uint32_t* pl = &bt->lr[2 * (pos & bt->wmask)];
  uint32_t* pr = pl + 1;
  size_t llen = 0, rlen = 0, nout = 0;
  size_t best = min_len - 1;
  for (;;) {
    if (!cur || depth-- <= 0) {
      *pl = 0;
      *pr = 0;
      break;
    }
    size_t cpos = cur - 1;
    if (pos - cpos > maxd) { /* expired (or stale slot reuse) */
      *pl = 0;
      *pr = 0;
      break;
    }
    uint32_t* clr = &bt->lr[2 * (cpos & bt->wmask)];
    size_t l = llen < rlen ? llen : rlen;
    l += common_len(data + pos + l, data + cpos + l, limit - l);
    if (out_cand && l > best) {
      out_cand[nout] = (uint32_t)cpos;
      out_len[nout] = (uint32_t)l;
      nout++;
      best = l;
    }
    if (l >= limit) {
      if (bt->open_end && limit < BT_MAX_CMP) {
        /* equal only up to the end of the input so far: their order
           past it is unknown, and the node's children, placed against
           it, could land on the wrong side of the new node once more
           input arrives (a later walk would then assume a common
           prefix that is not there). Drop the rest of the subtree. */
        *pl = 0;
        *pr = 0;
        break;
      }
      /* full-length duplicate: the new node replaces it entirely */
      *pl = clr[0];
      *pr = clr[1];
      break;
    }
    if (data[cpos + l] < data[pos + l]) {
      *pl = (uint32_t)cur;
      pl = &clr[1];
      cur = clr[1];
      llen = l;
    } else {
      *pr = (uint32_t)cur;
      pr = &clr[0];
      cur = clr[0];
      rlen = l;
    }
  }
  return nout;
}

/* ---------- command planning + emission ---------- */

typedef struct {
  uint16_t cmd_sym;
  uint8_t dcode;
  uint8_t dbits;
  uint32_t dextra;
  uint8_t has_dist;
} Plan;

static inline int value_code(uint32_t v, const int32_t* base, int n) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if ((uint32_t)base[mid] <= v)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

static inline uint16_t combine_cmd(int icode, int ccode, int implicit) {
  static const int cell_starts[3][3] = {
      {128, 192, 384}, {256, 320, 512}, {448, 576, 640}};
  int low = ((icode & 7) << 3) | (ccode & 7);
  if (implicit) return (uint16_t)(((ccode >> 3) == 0 ? 0 : 64) + low);
  return (uint16_t)(cell_starts[icode >> 3][ccode >> 3] + low);
}

/* Plan distance codes + command symbols for one metablock; updates the
   ring in place. */
static void plan_cmds(const Cmd* cmds, size_t ncmd, uint32_t* ring,
                      Plan* plan) {
  for (size_t i = 0; i < ncmd; i++) {
    const Cmd* c = &cmds[i];
    int final_insert = c->cpy == 0 && c->dist == 0;
    int is_dict = (c->adv & CMD_DICT) != 0;
    int icode = value_code(c->ins, kInsertBase, 24);
    int ccode = value_code(final_insert ? 2 : c->cpy, kCopyBase, 24);
    Plan* pl = &plan[i];
    pl->dcode = 0;
    pl->dbits = 0;
    pl->dextra = 0;
    if (final_insert) {
      pl->has_dist = 0;
      pl->cmd_sym =
          combine_cmd(icode, ccode, icode < 8); /* implicit cell if ok */
      continue;
    }
    uint32_t dist = c->dist;
    int dcode = -1;
    if (!is_dict) {
      if (dist == ring[0]) {
        dcode = 0;
      } else if (dist == ring[1]) {
        dcode = 1;
      } else if (dist == ring[2]) {
        dcode = 2;
      } else if (dist == ring[3]) {
        dcode = 3;
      } else {
        long d0 = (long)dist - (long)ring[0];
        long d1 = (long)dist - (long)ring[1];
        if (d0 >= -3 && d0 <= 3 && d0 != 0)
          dcode = d0 < 0 ? (int)(4 + 2 * (-d0 - 1)) : (int)(5 + 2 * (d0 - 1));
        else if (d1 >= -3 && d1 <= 3 && d1 != 0)
          dcode = d1 < 0 ? (int)(10 + 2 * (-d1 - 1))
                         : (int)(11 + 2 * (d1 - 1));
      }
    }
    int implicit = 0;
    if (dcode == 0 && icode < 8 && ccode < 16) implicit = 1;
    if (dcode < 0) {
      /* explicit distance (NPOSTFIX = 0, NDIRECT = 0) */
      uint64_t d = (uint64_t)dist - 1;
      uint64_t t = (d + 4) >> 2;
      int nbits = 0;
      while (t) {
        nbits++;
        t >>= 1;
      }
      uint64_t rest = d + 4 - (1ull << (nbits + 1));
      uint64_t half = rest >> nbits;
      pl->dcode = (uint8_t)(16 + (((nbits - 1) << 1) | (int)half));
      pl->dextra = (uint32_t)(rest - (half << nbits));
      pl->dbits = (uint8_t)nbits;
    } else {
      pl->dcode = (uint8_t)dcode;
    }
    pl->has_dist = (uint8_t)!implicit;
    pl->cmd_sym = combine_cmd(icode, ccode, implicit);
    /* ring push: every non-dict copy whose distance differs from top */
    if (!is_dict && dist != ring[0]) {
      ring[3] = ring[2];
      ring[2] = ring[1];
      ring[1] = ring[0];
      ring[0] = dist;
    }
  }
}

/* varlen uint8 for block-type counts */
static void put_varlen_u8(BW* bw, int value) {
  if (value == 0) {
    bw_put(bw, 0, 1);
    return;
  }
  bw_put(bw, 1, 1);
  int nbits = 0;
  while ((2 << nbits) <= value) nbits++;
  bw_put(bw, (uint64_t)nbits, 3);
  if (nbits) bw_put(bw, (uint64_t)(value - (1 << nbits)), (unsigned)nbits);
}

static void put_mlen_header(BW* bw, size_t mlen, int is_last,
                            int is_uncompressed) {
  bw_put(bw, is_last ? 1 : 0, 1);
  if (is_last) bw_put(bw, 0, 1); /* not empty */
  int nibbles = mlen <= (1 << 16) ? 4 : mlen <= (1 << 20) ? 5 : 6;
  bw_put(bw, (uint64_t)(nibbles - 4), 2);
  uint64_t v = (uint64_t)mlen - 1;
  for (int i = 0; i < nibbles; i++) bw_put(bw, (v >> (4 * i)) & 0xF, 4);
  if (!is_last) bw_put(bw, is_uncompressed ? 1 : 0, 1);
}

/* ---------- block splitting (RFC 6; role: BrotliSplitBlock,
   c/enc/block_splitter.c -- same chunk-clustering redesign as the
   Python enc/block_split.split_symbols) ---------- */

typedef struct {
  double gain;     /* net split gain in bits (0 when no split) */
  int ntypes;      /* 1 = no split (rtype/rlen NULL) */
  uint8_t* rtype;  /* run block types, first-appearance numbered */
  uint32_t* rlen;  /* run lengths in SYMBOLS of the category stream */
  size_t nruns;
} Split;

static void split_free(Split* sp) {
  free(sp->rtype);
  free(sp->rlen);
  sp->rtype = NULL;
  sp->rlen = NULL;
  sp->ntypes = 1;
  sp->nruns = 0;
}

/* Chunk the symbol stream, k-means-refine per-chunk histograms against
   k seed types, smooth single-chunk islands, keep the split only when
   the entropy gain beats the tree/switch overhead. Returns 0 (sp
   filled; ntypes == 1 means "no split") or EERR_ALLOC. */
static int split_symbols_c(const uint16_t* syms, size_t n, int alphabet,
                           int chunk, int max_types, double type_bits,
                           double sw_bits, Split* sp) {
  sp->gain = 0.0;
  sp->ntypes = 1;
  sp->rtype = NULL;
  sp->rlen = NULL;
  sp->nruns = 0;
  size_t nch = n / (size_t)chunk;
  if (nch < 8 || max_types <= 1) return 0;
  ensure_xlogx();
  int k = max_types;
  if ((size_t)k > nch / 4) k = (int)(nch / 4);
  if (k < 2) k = 2;
  int rc = EERR_ALLOC;
  uint16_t* H = (uint16_t*)calloc(nch * (size_t)alphabet, 2);
  double* seeds = (double*)malloc((size_t)k * alphabet * sizeof(double));
  float* logpT = (float*)malloc((size_t)alphabet * k * sizeof(float));
  uint8_t* assign = (uint8_t*)calloc(nch, 1);
  uint32_t* thist = (uint32_t*)calloc((size_t)(k + 1) * alphabet, 4);
  uint8_t* sym_assign = (uint8_t*)malloc(n);
  uint8_t* bp = (uint8_t*)malloc(n * (size_t)k);
  if (!H || !seeds || !logpT || !assign || !thist || !sym_assign ||
      !bp)
    goto done;
  for (size_t c = 0; c < nch; c++) {
    uint16_t* row = H + c * (size_t)alphabet;
    const uint16_t* s = syms + c * (size_t)chunk;
    for (int i = 0; i < chunk; i++) row[s[i]]++;
  }
  for (int t = 0; t < k; t++) {
    size_t c = (size_t)((double)t * (double)(nch - 1) / (double)(k - 1));
    const uint16_t* row = H + c * (size_t)alphabet;
    for (int s = 0; s < alphabet; s++)
      seeds[(size_t)t * alphabet + s] = row[s];
  }
  for (int iter = 0; iter < 4; iter++) {
    for (int t = 0; t < k; t++) {
      double tot = 0;
      for (int s = 0; s < alphabet; s++)
        tot += seeds[(size_t)t * alphabet + s];
      if (tot < 1) tot = 1;
      double lt = log2(tot);
      for (int s = 0; s < alphabet; s++) {
        double v = seeds[(size_t)t * alphabet + s];
        if (v < 0.5) v = 0.5;
        logpT[(size_t)s * k + t] = (float)(log2(v) - lt);
      }
    }
    int changed = 0;
    for (size_t c = 0; c < nch; c++) {
      float acc[16];
      for (int t = 0; t < k; t++) acc[t] = 0.0f;
      const uint16_t* s = syms + c * (size_t)chunk;
      for (int i = 0; i < chunk; i++) {
        const float* lp = logpT + (size_t)s[i] * k;
        for (int t = 0; t < k; t++) acc[t] += lp[t];
      }
      int bt = 0;
      for (int t = 1; t < k; t++)
        if (acc[t] > acc[bt]) bt = t;
      if (assign[c] != (uint8_t)bt) {
        assign[c] = (uint8_t)bt;
        changed = 1;
      }
    }
    if (!changed) break;
    {
      double* prev_seeds =
          (double*)malloc((size_t)k * alphabet * sizeof(double));
      uint32_t tcnt[16];
      memset(tcnt, 0, sizeof(tcnt));
      if (prev_seeds)
        memcpy(prev_seeds, seeds,
               (size_t)k * alphabet * sizeof(double));
      memset(seeds, 0, (size_t)k * alphabet * sizeof(double));
      for (size_t c = 0; c < nch; c++) {
        double* dst = seeds + (size_t)assign[c] * alphabet;
        const uint16_t* row = H + c * (size_t)alphabet;
        for (int s = 0; s < alphabet; s++) dst[s] += row[s];
        tcnt[assign[c]]++;
      }
      for (int t = 0; t < k; t++) {
        if (tcnt[t] == 0 && prev_seeds) {
          /* empty cluster: keep its old seed (a zeroed row clamps to
             a flat ~1 bit/symbol and would attract every chunk) */
          memcpy(seeds + (size_t)t * alphabet,
                 prev_seeds + (size_t)t * alphabet,
                 (size_t)alphabet * sizeof(double));
        } else {
          seeds[(size_t)t * alphabet] += 1e-3;
        }
      }
      free(prev_seeds);
    }
  }
  /* --- symbol-level refinement (the reference FindBlocks role,
     block_splitter_inc.h): the chunk k-means above provides type
     seeds; a Viterbi pass over the raw symbol stream then places
     switches optimally (ANY position, not chunk boundaries), the
     type histograms are rebuilt from the new segmentation, and the
     pass repeats. Switch cost `sw_bits` prices a block-switch
     command (type code + block-count code). --- */
  {
    double sw_eff = sw_bits;
    size_t nswitches = 0;
    for (int attempt = 0; attempt < 3; attempt++) {
      for (int vit = 0; vit < 2; vit++) {
        /* -log2 p(sym | type) table from current seeds */
        for (int t = 0; t < k; t++) {
          double tot = 0;
          for (int s = 0; s < alphabet; s++)
            tot += seeds[(size_t)t * alphabet + s];
          if (tot < 1) tot = 1;
          double lt = log2(tot);
          for (int s = 0; s < alphabet; s++) {
            double v = seeds[(size_t)t * alphabet + s];
            if (v < 0.5) v = 0.5;
            logpT[(size_t)s * k + t] = (float)(lt - log2(v));
          }
        }
        float dp[16];
        for (int t = 0; t < k; t++) dp[t] = 0.0f;
        for (size_t i = 0; i < n; i++) {
          int best = 0;
          for (int t = 1; t < k; t++)
            if (dp[t] < dp[best]) best = t;
          float swv = dp[best] + (float)sw_eff;
          uint8_t* bpi = bp + i * (size_t)k;
          const float* lp = logpT + (size_t)syms[i] * k;
          for (int t = 0; t < k; t++) {
            if (swv < dp[t]) {
              dp[t] = swv;
              bpi[t] = (uint8_t)best;
            } else {
              bpi[t] = (uint8_t)t;
            }
            dp[t] += lp[t];
          }
          if ((i & 8191) == 8191) { /* renormalize (float headroom) */
            float mn = dp[0];
            for (int t = 1; t < k; t++)
              if (dp[t] < mn) mn = dp[t];
            for (int t = 0; t < k; t++) dp[t] -= mn;
          }
        }
        int cur = 0;
        for (int t = 1; t < k; t++)
          if (dp[t] < dp[cur]) cur = t;
        for (size_t i = n; i-- > 0;) {
          sym_assign[i] = (uint8_t)cur;
          cur = bp[i * (size_t)k + cur];
        }
        /* rebuild seeds from the refined segmentation */
        memset(seeds, 0, (size_t)k * alphabet * sizeof(double));
        for (size_t i = 0; i < n; i++)
          seeds[(size_t)sym_assign[i] * alphabet + syms[i]] += 1.0;
      }
      nswitches = 0;
      for (size_t i = 1; i < n; i++)
        if (sym_assign[i] != sym_assign[i - 1]) nswitches++;
      if (nswitches < 32000) break; /* SwitchPlan run capacity */
      sw_eff *= 2.0;
    }
    if (nswitches >= 32000) {
      rc = 0; /* pathological: keep the unsplit stream */
      goto done;
    }
    /* entropy-gain check: per-type histograms + the whole-stream row */
    uint32_t* whole = thist + (size_t)k * alphabet;
    memset(thist, 0, (size_t)(k + 1) * alphabet * sizeof(uint32_t));
    for (size_t i = 0; i < n; i++) {
      thist[(size_t)sym_assign[i] * alphabet + syms[i]]++;
      whole[syms[i]]++;
    }
    double base_cost = hist_cost(whole, alphabet);
    double split_cost = 0.0;
    int npresent = 0;
    int seen[16];
    memset(seen, 0, sizeof(seen));
    for (size_t i = 0; i < n; i++) {
      if (!seen[sym_assign[i]]) {
        seen[sym_assign[i]] = 1;
        npresent++;
        split_cost += hist_cost(
            thist + (size_t)sym_assign[i] * alphabet, alphabet);
      }
    }
    double overhead = type_bits * npresent +
                      sw_eff * (double)nswitches + 100.0;
    if (npresent <= 1 || base_cost - split_cost < overhead) {
      rc = 0;
      goto done;
    }
    sp->gain = base_cost - split_cost - overhead;
    /* renumber in first-appearance order and build runs */
    int remap[16];
    for (int t = 0; t < k; t++) remap[t] = -1;
    int ntypes = 0;
    size_t nruns = nswitches + 1;
    for (size_t i = 0; i < n; i++)
      if (remap[sym_assign[i]] < 0) remap[sym_assign[i]] = ntypes++;
    sp->rtype = (uint8_t*)malloc(nruns);
    sp->rlen = (uint32_t*)malloc(nruns * 4);
    if (!sp->rtype || !sp->rlen) {
      split_free(sp);
      goto done;
    }
    size_t r = 0;
    sp->rtype[0] = (uint8_t)remap[sym_assign[0]];
    sp->rlen[0] = 1;
    for (size_t i = 1; i < n; i++) {
      if (sym_assign[i] != sym_assign[i - 1]) {
        r++;
        sp->rtype[r] = (uint8_t)remap[sym_assign[i]];
        sp->rlen[r] = 0;
      }
      sp->rlen[r]++;
    }
    sp->nruns = nruns;
    sp->ntypes = ntypes;
  }
  rc = 0;
done:
  free(H);
  free(seeds);
  free(logpT);
  free(assign);
  free(thist);
  free(sym_assign);
  free(bp);
  return rc;
}

/* Block-switch plan for one category: type-code symbols (2-entry ring
   rule, RFC 6), block-count codes, and the two prefix trees. */
typedef struct {
  uint8_t tsyms[32768];  /* type codes for runs[1:] (4MB mb / 128 chunk) */
  uint8_t ccode[32768];  /* count codes for ALL runs */
  uint8_t type_lens[16 + 2];
  uint16_t type_codes[16 + 2];
  uint8_t cnt_lens[26];
  uint16_t cnt_codes[26];
  int type_emit, cnt_emit;
} SwitchPlan;

static int plan_switches_c(const Split* sp, PmScratch* pm,
                           SwitchPlan* sw) {
  size_t nruns = sp->nruns;
  int ntypes = sp->ntypes;
  if (nruns > 32768) return EERR_PARAM;
  uint32_t tfreq[18];
  uint32_t cfreq[26];
  memset(tfreq, 0, sizeof(tfreq));
  memset(cfreq, 0, sizeof(cfreq));
  int rb0 = 1, rb1 = 0;
  for (size_t r = 1; r < nruns; r++) {
    int t = sp->rtype[r];
    int sym;
    if (t == rb0) {
      sym = 0;
    } else if (t == (rb1 + 1) % ntypes) {
      sym = 1;
    } else {
      sym = t + 2;
    }
    sw->tsyms[r - 1] = (uint8_t)sym;
    tfreq[sym]++;
    rb0 = rb1;
    rb1 = t;
  }
  for (size_t r = 0; r < nruns; r++) {
    int code = value_code(sp->rlen[r], kBlockCountBase, 26);
    sw->ccode[r] = (uint8_t)code;
    cfreq[code]++;
  }
  pm_lengths(tfreq, ntypes + 2, MAX_HUFF_LEN, sw->type_lens, pm);
  pm_lengths(cfreq, 26, MAX_HUFF_LEN, sw->cnt_lens, pm);
  lengths_to_codes_c(sw->type_lens, ntypes + 2, sw->type_codes);
  lengths_to_codes_c(sw->cnt_lens, 26, sw->cnt_codes);
  int used = 0;
  for (int s = 0; s < ntypes + 2; s++)
    if (sw->type_lens[s]) used++;
  sw->type_emit = used > 1;
  used = 0;
  for (int s = 0; s < 26; s++)
    if (sw->cnt_lens[s]) used++;
  sw->cnt_emit = used > 1;
  return 0;
}

/* block-type + block-count trees and the first block length (RFC 9.2) */
static int write_switch_header_c(BW* bw, const Split* sp, SwitchPlan* sw,
                                 PmScratch* pm) {
  int rc = write_huffman_code_c(bw, sw->type_lens, sp->ntypes + 2,
                                sp->ntypes + 2, pm);
  if (rc) return rc;
  rc = write_huffman_code_c(bw, sw->cnt_lens, 26, 26, pm);
  if (rc) return rc;
  int c0 = sw->ccode[0];
  if (sw->cnt_emit) bw_put(bw, sw->cnt_codes[c0], sw->cnt_lens[c0]);
  if (kBlockCountExtra[c0])
    bw_put(bw, sp->rlen[0] - (uint32_t)kBlockCountBase[c0],
           (unsigned)kBlockCountExtra[c0]);
  return 0;
}

/* emit one block switch: type code then count code (+ extra bits) */
static inline void emit_switch_c(BW* bw, const Split* sp, SwitchPlan* sw,
                                 size_t run) {
  int ts = sw->tsyms[run - 1];
  if (sw->type_emit) bw_put(bw, sw->type_codes[ts], sw->type_lens[ts]);
  int c = sw->ccode[run];
  if (sw->cnt_emit) bw_put(bw, sw->cnt_codes[c], sw->cnt_lens[c]);
  if (kBlockCountExtra[c])
    bw_put(bw, sp->rlen[run] - (uint32_t)kBlockCountBase[c],
           (unsigned)kBlockCountExtra[c]);
}

/* ---------- literal-split refinement against clustered-tree costs --
   The chunk-k-means/Viterbi splitter above optimizes PLAIN per-type
   literal entropy, but the emitted cost of a literal is its code
   length under the CLUSTERED (type x context) -> tree mapping, plus
   context-map / tree / block-switch overhead. On context-heavy inputs
   the two objectives diverge (mapsdatazrh: the reference lands ~12
   literal types; an entropy-only gain check rejects rich splits
   because it cannot see context sharing). This q11 pass re-optimizes
   the split against the real downstream cost: cluster -> per-tree
   code lengths -> Viterbi reassignment -> exact re-score (body bits
   + switch stream + serialized switch header / context map / trees
   measured through the real serializers), keeping the best candidate.
   Role: c/enc/block_splitter_inc.h FindBlocks/RefineEntropyCodes
   iteration + ClusterBlocks, redesigned around clustered context
   modeling. ---------- */

#define LIT_REFINE_KMAX 16

/* swept at q11: 180 beats 60 on small files (fewer, denser trees),
   neutral on the 16MB corpus (the 48-tree cap binds there) */
static const double kLitTableCost = 180.0;

/* Two-level literal-row clustering: per-type pre-merge of the 64
   context rows, then a global cluster of the group representatives.
   Cuts the O(rows^2) pair-gain fill ~8x on rich splits (16 types x 64
   ctx = 1024 rows -> ~16x2016 + ~200^2/2 pairs) at negligible quality
   cost (within-type merges are re-examined globally). hist is mutated;
   tree t's histogram ends in hist[reps[t]*NUM_LIT], as cluster_hists. */
static int cluster_lit_rows(uint32_t* hist, int ntypes, int max_trees,
                            int* assign, int* reps) {
  const int K = ntypes * NUM_LIT_CTX;
  if (ntypes <= 2)
    return cluster_hists(hist, K, NUM_LIT, max_trees, kLitTableCost,
                         1.5, assign, reps);
  int ga[NUM_LIT_CTX], gr[NUM_LIT_CTX];
  int* gidx = (int*)malloc(sizeof(int) * (size_t)K);
  int* row_group = (int*)malloc(sizeof(int) * (size_t)K);
  if (!gidx || !row_group) {
    free(gidx);
    free(row_group);
    return -1;
  }
  int ng = 0;
  for (int t = 0; t < ntypes; t++) {
    int g = cluster_hists(hist + (size_t)t * NUM_LIT_CTX * NUM_LIT,
                          NUM_LIT_CTX, NUM_LIT, NUM_LIT_CTX,
                          kLitTableCost, 1.5, ga, gr);
    if (g < 0) {
      free(gidx);
      free(row_group);
      return -1;
    }
    for (int c = 0; c < NUM_LIT_CTX; c++)
      row_group[t * NUM_LIT_CTX + c] = ng + ga[c];
    for (int j = 0; j < g; j++)
      gidx[ng + j] = t * NUM_LIT_CTX + gr[j];
    ng += g;
  }
  uint32_t* gh = (uint32_t*)malloc((size_t)ng * NUM_LIT * 4);
  int* ga2 = (int*)malloc(sizeof(int) * (size_t)ng);
  int* gr2 = (int*)malloc(sizeof(int) * (size_t)ng);
  int ntr = -1;
  if (gh && ga2 && gr2) {
    for (int j = 0; j < ng; j++)
      memcpy(gh + (size_t)j * NUM_LIT,
             hist + (size_t)gidx[j] * NUM_LIT, NUM_LIT * 4);
    ntr = cluster_hists(gh, ng, NUM_LIT, max_trees, kLitTableCost, 1.5,
                        ga2, gr2);
    if (ntr > 0) {
      for (int t = 0; t < ntr; t++) {
        int orig = gidx[gr2[t]];
        memcpy(hist + (size_t)orig * NUM_LIT,
               gh + (size_t)gr2[t] * NUM_LIT, NUM_LIT * 4);
        reps[t] = orig;
      }
      for (int r = 0; r < K; r++) assign[r] = ga2[row_group[r]];
    }
  }
  free(gh);
  free(ga2);
  free(gr2);
  free(gidx);
  free(row_group);
  return ntr;
}

/* first-appearance renumber of a per-literal type array; returns the
   compacted type count */
static int compact_types(uint8_t* lt, size_t n) {
  int remap[LIT_REFINE_KMAX];
  for (int t = 0; t < LIT_REFINE_KMAX; t++) remap[t] = -1;
  int k = 0;
  for (size_t i = 0; i < n; i++) {
    if (remap[lt[i]] < 0) remap[lt[i]] = k++;
    lt[i] = (uint8_t)remap[lt[i]];
  }
  return k ? k : 1;
}

/* build run list from a per-literal type array (lt must be compact) */
static int split_from_assign(const uint8_t* lt, size_t n, int k,
                             Split* sp) {
  split_free(sp);
  sp->ntypes = k;
  if (k <= 1 || n == 0) return 0;
  size_t nruns = 1;
  for (size_t i = 1; i < n; i++) nruns += lt[i] != lt[i - 1];
  sp->rtype = (uint8_t*)malloc(nruns);
  sp->rlen = (uint32_t*)malloc(nruns * 4);
  if (!sp->rtype || !sp->rlen) {
    split_free(sp);
    return EERR_ALLOC;
  }
  size_t r = 0;
  sp->rtype[0] = lt[0];
  sp->rlen[0] = 1;
  for (size_t i = 1; i < n; i++) {
    if (lt[i] != lt[i - 1]) {
      r++;
      sp->rtype[r] = lt[i];
      sp->rlen[r] = 0;
    }
    sp->rlen[r]++;
  }
  sp->nruns = nruns;
  return 0;
}

typedef struct {
  uint32_t* hist;  /* KMAX*64 x NUM_LIT, mutated by clustering */
  int* assign;     /* KMAX*64 */
  int* reps;       /* KMAX*64 */
  uint8_t (*lens)[NUM_LIT]; /* MAX_LIT_TREES */
  SwitchPlan* swp;
  uint8_t* bp;     /* nlit * KMAX Viterbi backpointers */
  uint8_t *lt_cur, *lt_try, *lt_best; /* nlit each */
} LitRefine;

/* Exact literal-channel cost (bits) of a compact split candidate.
   Fills sc->hist/assign/lens for the Viterbi step; *out_ntr gets the
   clustered tree count, *out_swcost the measured mean emitted
   block-switch cost (Viterbi switch price). */
static double lit_split_score(const uint8_t* lt, int k, size_t nlit,
                              const uint8_t* lbytes, const uint8_t* lctx,
                              PmScratch* pm, LitRefine* sc,
                              int* out_ntr, double* out_swcost) {
  memset(sc->hist, 0, (size_t)k * NUM_LIT_CTX * NUM_LIT * 4);
  for (size_t i = 0; i < nlit; i++)
    sc->hist[(((size_t)lt[i] << 6) + lctx[i]) * NUM_LIT + lbytes[i]]++;
  int ntr = cluster_lit_rows(sc->hist, k, MAX_LIT_TREES, sc->assign,
                             sc->reps);
  if (ntr < 0) return HUGE_VAL;
  *out_ntr = ntr;
  for (int t = 0; t < ntr; t++)
    pm_lengths_rle(sc->hist + (size_t)sc->reps[t] * NUM_LIT, NUM_LIT,
                   NUM_LIT, sc->lens[t], pm);
  double bits = 0.0;
  for (size_t i = 0; i < nlit; i++) {
    uint8_t l = sc->lens[sc->assign[((size_t)lt[i] << 6) + lctx[i]]]
                        [lbytes[i]];
    bits += l ? l : 20; /* absent from merged row: heavy penalty */
  }
  *out_swcost = 14.0;
  BW tmp = {0};
  if (k > 1) {
    Split tsp = {.gain = 0.0, .ntypes = 1};
    if (split_from_assign(lt, nlit, k, &tsp)) return HUGE_VAL;
    if (tsp.nruns > 32768) {
      split_free(&tsp);
      return HUGE_VAL; /* beyond SwitchPlan capacity: reject */
    }
    if (plan_switches_c(&tsp, pm, sc->swp)) {
      split_free(&tsp);
      return HUGE_VAL;
    }
    double swbits = 0.0;
    for (size_t r = 1; r < tsp.nruns; r++) {
      if (sc->swp->type_emit)
        swbits += sc->swp->type_lens[sc->swp->tsyms[r - 1]];
      int c = sc->swp->ccode[r];
      if (sc->swp->cnt_emit) swbits += sc->swp->cnt_lens[c];
      swbits += kBlockCountExtra[c];
    }
    if (tsp.nruns > 1)
      *out_swcost = swbits / (double)(tsp.nruns - 1);
    bits += swbits;
    if (write_switch_header_c(&tmp, &tsp, sc->swp, pm)) {
      split_free(&tsp);
      free(tmp.buf);
      return HUGE_VAL;
    }
    split_free(&tsp);
  }
  /* context map + serialized trees + NBLTYPESL + ctx-mode bits */
  if (k > 1 || ntr > 1) {
    if (write_context_map_c(&tmp, sc->assign, k * NUM_LIT_CTX, ntr,
                            pm)) {
      free(tmp.buf);
      return HUGE_VAL;
    }
  } else {
    bits += 1.0; /* IMTF bit of the trivial map */
  }
  for (int t = 0; t < ntr; t++)
    write_huffman_code_c(&tmp, sc->lens[t], NUM_LIT, NUM_LIT, pm);
  bits += (double)bw_bitlen(&tmp);
  free(tmp.buf);
  bits += (k >= 9 ? 7 : (k >= 5 ? 6 : (k >= 3 ? 5 : (k == 2 ? 4 : 1)))); /* NBLTYPESL varlen */
  bits += 2.0 * k; /* per-type context-mode field */
  return bits;
}

/* One Viterbi reassignment of every literal over k types, priced by
   the clustered trees' code lengths (sc->lens/assign from the last
   score) and the measured switch cost. */
static void lit_viterbi_refine(const uint8_t* lbytes, const uint8_t* lctx,
                               size_t nlit, int k, float sw_cost,
                               LitRefine* sc, uint8_t* lt_out) {
  float dp[LIT_REFINE_KMAX];
  for (int t = 0; t < k; t++) dp[t] = 0.0f;
  for (size_t i = 0; i < nlit; i++) {
    int best = 0;
    for (int t = 1; t < k; t++)
      if (dp[t] < dp[best]) best = t;
    float swv = dp[best] + sw_cost;
    uint8_t* bpi = sc->bp + i * (size_t)k;
    for (int t = 0; t < k; t++) {
      if (swv < dp[t]) {
        dp[t] = swv;
        bpi[t] = (uint8_t)best;
      } else {
        bpi[t] = (uint8_t)t;
      }
      uint8_t l = sc->lens[sc->assign[((size_t)t << 6) + lctx[i]]]
                          [lbytes[i]];
      dp[t] += l ? l : 20;
    }
    if ((i & 8191) == 8191) {
      float mn = dp[0];
      for (int t = 1; t < k; t++)
        if (dp[t] < mn) mn = dp[t];
      for (int t = 0; t < k; t++) dp[t] -= mn;
    }
  }
  int cur = 0;
  for (int t = 1; t < k; t++)
    if (dp[t] < dp[cur]) cur = t;
  for (size_t i = nlit; i-- > 0;) {
    lt_out[i] = (uint8_t)cur;
    cur = sc->bp[i * (size_t)k + cur];
  }
}

/* Refinement driver: try the current split and (when it is coarse) a
   rich 16-type chunk-k-means seed; iterate cluster -> Viterbi ->
   re-score, keep the best-scoring assignment, and rebuild the run
   list / histograms / clustering when it beats the incumbent. */
static int refine_lit_split(PmScratch* pm, size_t nlit,
                            const uint8_t* lbytes, const uint8_t* lctx,
                            Split* lsp, uint32_t** plit_hist,
                            int** plit_assign, int** plit_reps,
                            int* pn_lit_trees) {
  int rc = EERR_ALLOC;
  LitRefine sc = {0};
  uint16_t* s16 = NULL;
  size_t rows = (size_t)LIT_REFINE_KMAX * NUM_LIT_CTX;
  sc.hist = (uint32_t*)malloc(rows * NUM_LIT * 4);
  sc.assign = (int*)malloc(rows * sizeof(int));
  sc.reps = (int*)malloc(rows * sizeof(int));
  sc.lens = (uint8_t(*)[NUM_LIT])malloc((size_t)MAX_LIT_TREES * NUM_LIT);
  sc.swp = (SwitchPlan*)malloc(sizeof(SwitchPlan));
  sc.bp = (uint8_t*)malloc(nlit * LIT_REFINE_KMAX);
  sc.lt_cur = (uint8_t*)malloc(nlit);
  sc.lt_try = (uint8_t*)malloc(nlit);
  sc.lt_best = (uint8_t*)malloc(nlit);
  if (!sc.hist || !sc.assign || !sc.reps || !sc.lens || !sc.swp ||
      !sc.bp || !sc.lt_cur || !sc.lt_try || !sc.lt_best)
    goto out;
  /* expand the incumbent run list to a per-literal assignment */
  if (lsp->ntypes > 1) {
    size_t w = 0;
    for (size_t r = 0; r < lsp->nruns && w < nlit; r++)
      for (uint32_t j = 0; j < lsp->rlen[r] && w < nlit; j++)
        sc.lt_cur[w++] = lsp->rtype[r];
  } else {
    memset(sc.lt_cur, 0, nlit);
  }
  {
    const int dbg = getenv("BTPU_REFINE_DEBUG") != NULL;
    struct timespec t0, t1;
    if (dbg) clock_gettime(CLOCK_MONOTONIC, &t0);
#define DBG_MARK(tag_)                                                \
    do {                                                              \
      if (dbg) {                                                      \
        clock_gettime(CLOCK_MONOTONIC, &t1);                          \
        fprintf(stderr, "refine %s: %.0f ms\n", tag_,                 \
                (t1.tv_sec - t0.tv_sec) * 1e3 +                       \
                    (t1.tv_nsec - t0.tv_nsec) / 1e6);                 \
        t0 = t1;                                                      \
      }                                                               \
    } while (0)
    int k0 = lsp->ntypes;
    int ntr;
    double swc;
    double orig = lit_split_score(sc.lt_cur, k0, nlit, lbytes, lctx,
                                  pm, &sc, &ntr, &swc);
    DBG_MARK("score0");
    double best = orig;
    memcpy(sc.lt_best, sc.lt_cur, nlit);
    int kbest = k0;
    if (orig == HUGE_VAL) {
      rc = 0; /* capacity-limited: keep the incumbent untouched */
      goto out;
    }
    for (int s = 0; s < 2; s++) {
      uint8_t* lt = sc.lt_cur;
      uint8_t* prev = sc.lt_try;
      int k;
      double cur;
      if (s == 0) {
        k = k0;
        cur = orig; /* lens/assign already filled for lt_cur */
        if (k <= 1) continue; /* nothing to re-walk; rich start only */
      } else {
        if (kbest >= 12) break; /* already rich */
        Split rich = {.gain = 0.0, .ntypes = 1};
        if (!s16) {
          s16 = (uint16_t*)malloc(nlit * 2);
          if (!s16) goto out;
          for (size_t i = 0; i < nlit; i++) s16[i] = lbytes[i];
        }
        /* type_bits 0: emit the rich split even where the entropy
           gain check would reject it -- the refinement's real-cost
           score is the arbiter */
        if (split_symbols_c(s16, nlit, NUM_LIT, 128, LIT_REFINE_KMAX,
                            0.0, 14.0, &rich))
          goto out;
        DBG_MARK("rich-split");
        if (rich.ntypes <= 1) {
          split_free(&rich);
          break;
        }
        size_t w = 0;
        for (size_t r = 0; r < rich.nruns && w < nlit; r++)
          for (uint32_t j = 0; j < rich.rlen[r] && w < nlit; j++)
            lt[w++] = rich.rtype[r];
        split_free(&rich);
        k = compact_types(lt, nlit);
        cur = lit_split_score(lt, k, nlit, lbytes, lctx, pm, &sc,
                              &ntr, &swc);
        DBG_MARK("rich-score");
        if (cur == HUGE_VAL) continue;
        if (cur < best - 4.0) {
          best = cur;
          memcpy(sc.lt_best, lt, nlit);
          kbest = k;
        }
      }
      for (int it = 0; it < 2 && k > 1; it++) {
        memcpy(prev, lt, nlit);
        lit_viterbi_refine(lbytes, lctx, nlit, k, (float)swc, &sc, lt);
        DBG_MARK("viterbi");
        k = compact_types(lt, nlit);
        if (!memcmp(prev, lt, nlit)) break;
        cur = lit_split_score(lt, k, nlit, lbytes, lctx, pm, &sc,
                              &ntr, &swc);
        DBG_MARK("iter-score");
        if (cur == HUGE_VAL) break;
        if (cur < best - 4.0) {
          best = cur;
          memcpy(sc.lt_best, lt, nlit);
          kbest = k;
        }
      }
    }
#undef DBG_MARK
    if (best < orig - 4.0) {
      rc = split_from_assign(sc.lt_best, nlit, kbest, lsp);
      if (rc) goto out;
      uint32_t* nh = (uint32_t*)calloc(
          (size_t)kbest * NUM_LIT_CTX * NUM_LIT, 4);
      int* na = (int*)malloc((size_t)kbest * NUM_LIT_CTX * sizeof(int));
      int* nr = (int*)malloc((size_t)kbest * NUM_LIT_CTX * sizeof(int));
      if (!nh || !na || !nr) {
        free(nh);
        free(na);
        free(nr);
        rc = EERR_ALLOC;
        goto out;
      }
      for (size_t i = 0; i < nlit; i++)
        nh[(((size_t)sc.lt_best[i] << 6) + lctx[i]) * NUM_LIT +
           lbytes[i]]++;
      int nt = cluster_lit_rows(nh, kbest, MAX_LIT_TREES, na, nr);
      if (nt < 0) {
        free(nh);
        free(na);
        free(nr);
        rc = EERR_ALLOC;
        goto out;
      }
      free(*plit_hist);
      free(*plit_assign);
      free(*plit_reps);
      *plit_hist = nh;
      *plit_assign = na;
      *plit_reps = nr;
      *pn_lit_trees = nt;
    }
  }
  rc = 0;
out:
  free(sc.hist);
  free(sc.assign);
  free(sc.reps);
  free(sc.lens);
  free(sc.swp);
  free(sc.bp);
  free(sc.lt_cur);
  free(sc.lt_try);
  free(sc.lt_best);
  free(s16);
  return rc;
}

/* choose the literal context mode for a metablock (UTF8 vs LSB6) */
static int choose_ctx_mode(const uint8_t* data, size_t lo, size_t hi) {
  size_t n = hi - lo;
  if (n > 65536) n = 65536;
  size_t ok = 0;
  for (size_t i = 0; i < n; i++) {
    uint8_t b = data[lo + i];
    if (b < 128 || b >= 0xC2) ok++;
  }
  return (double)ok > 0.75 * (double)n ? 2 /* UTF8 */ : 3 /* SIGNED */;
}

typedef struct {
  const uint8_t* data;
  size_t n;
  int quality;
  int lgwin;
  int ctx_mode;    /* forced literal context mode (-1 = sniff);
                      BrotliEncoderMode TEXT/FONT hint */
  int dist_alpha;  /* 64, or 140 for large-window streams */
  size_t maxback;
  size_t ctx_start; /* literal context p1/p2 are zero before this
                       position (dictionary-preloaded streams: the
                       decoder's output starts empty) */
  BW bw;
  PmScratch pm;
  uint32_t ring[4];
  /* per-metablock scratch, grown on demand */
  Plan* plan;
  size_t plan_cap;
} Enc;

/* Serialize one metablock from the command array. Commands must consume
   exactly [lo, hi) of the input. q >= 10 adds literal/command/distance
   block splitting (BrotliStoreMetaBlock + BrotliSplitBlock roles). */
static int emit_metablock(Enc* e, const Cmd* cmds, size_t ncmd, size_t lo,
                          size_t hi, int is_last) {
  size_t mlen = hi - lo;
  const uint8_t* data = e->data;
  BW* bw = &e->bw;
  int q = e->quality;
  int rc = 0;
  if (ncmd > e->plan_cap) {
    free(e->plan);
    e->plan_cap = ncmd + 64;
    e->plan = (Plan*)malloc(sizeof(Plan) * e->plan_cap);
    if (!e->plan) return EERR_ALLOC;
  }
  Plan* plan = e->plan;
  int dalpha = e->dist_alpha ? e->dist_alpha : NUM_DIST;
  plan_cmds(cmds, ncmd, e->ring, plan);

  size_t nlit = 0, ndist_syms = 0;
  for (size_t i = 0; i < ncmd; i++) {
    nlit += cmds[i].ins;
    ndist_syms += plan[i].has_dist;
  }

  /* ---- block splitting (q >= 10) ---- */
  Split lsp = {.gain = 0.0, .ntypes = 1};
  Split csp = {.gain = 0.0, .ntypes = 1};
  Split dsp = {.gain = 0.0, .ntypes = 1};
  uint32_t* lit_hist = NULL;
  uint32_t* cmd_hist = NULL;
  uint32_t* dist_hist = NULL;
  int* lit_assign = NULL;
  int* lit_reps = NULL;
  uint8_t* lref_bytes = NULL; /* literal stream capture (q11 refine) */
  uint8_t* lref_ctx = NULL;
  SwitchPlan *lsw = NULL, *csw = NULL, *dsw = NULL;
  if (q >= 10) {
    uint16_t* s16 = NULL;
    size_t cap = nlit > ncmd ? nlit : ncmd;
    if (cap < ndist_syms) cap = ndist_syms;
    s16 = (uint16_t*)malloc(cap * 2 + 2);
    if (!s16) {
      rc = EERR_ALLOC;
      goto done;
    }
    if (nlit >= 4096) {
      size_t w = 0, pos = lo;
      for (size_t i = 0; i < ncmd; i++) {
        for (uint32_t k = 0; k < cmds[i].ins; k++)
          s16[w++] = data[pos + k];
        pos += cmds[i].ins + (cmds[i].adv & ~CMD_DICT);
      }
      /* literal chunk swept on the 16MB corpus: 128 > 96/192/256.
         Type budget 8 also swept best: 16 types (map buffers now hold
         16 * 64 entries) lose ~0.2% to context-map + tree overhead. */
      {
        /* With context modeling on, every literal type multiplies 64
           context-map rows and the clustered tree set; the gain check
           must price that (swept: homogeneous text collapses to 1-2
           types, the mixed 16MB corpus keeps its splits). Sweep
           knobs: BTPU_LIT_TYPES / BTPU_LIT_TYPE_BITS. */
        double tbits = 2048.0;
        /* Viterbi switch price swept on mapsdatazrh: 14 bits (the
           emitted block-count codes amortize well below the 28.1-bit
           splitter estimate; text files are insensitive) */
        double lsw = 14.0;
        int lchunk = 128;
        const char* v = getenv("BTPU_LIT_TYPE_BITS");
        if (v) tbits = atof(v);
        v = getenv("BTPU_LIT_SW_BITS");
        if (v) lsw = atof(v);
        v = getenv("BTPU_LIT_CHUNK");
        if (v) lchunk = atoi(v);
        v = getenv("BTPU_LIT_TYPES");
        if (v) {
          int lt = atoi(v) > 16 ? 16 : atoi(v);
          rc = split_symbols_c(s16, nlit, NUM_LIT, lchunk, lt, tbits,
                               lsw, &lsp);
        } else {
          /* the k-means is cheap next to the DP: try the budget
             ladder and keep the best net gain (homogeneous text
             settles at 1-2 types, mixed corpora keep richer splits) */
          static const int kLitK[4] = {2, 4, 8, 16};
          rc = 0;
          for (int t = 0; t < 4 && rc == 0; t++) {
            Split cand;
            rc = split_symbols_c(s16, nlit, NUM_LIT, lchunk, kLitK[t],
                                 tbits, lsw, &cand);
            if (rc == 0 && cand.ntypes > 1 && cand.gain > lsp.gain) {
              split_free(&lsp);
              lsp = cand;
            } else {
              split_free(&cand);
            }
          }
        }
      }
      if (rc) {
        free(s16);
        goto done;
      }
    }
    if (ncmd >= 2048) {
      for (size_t i = 0; i < ncmd; i++) s16[i] = plan[i].cmd_sym;
      rc = split_symbols_c(s16, ncmd, NUM_CMD, 256, 6, 256.0, 13.5,
                           &csp);
      if (rc) {
        free(s16);
        goto done;
      }
    }
    if (ndist_syms >= 2048) {
      size_t w = 0;
      for (size_t i = 0; i < ncmd; i++)
        if (plan[i].has_dist) s16[w++] = plan[i].dcode;
      rc = split_symbols_c(s16, ndist_syms, dalpha, 256, 4, 256.0,
                           14.6, &dsp);
      if (rc) {
        free(s16);
        goto done;
      }
    }
    free(s16);
  }
  int ntypes = lsp.ntypes;
  int ntypes_i = csp.ntypes;
  int ntypes_d = dsp.ntypes;

  /* ---- histograms (keyed by block type x context) ---- */
  int mode = 0;
  int use_ctx = 0;
  /* swept at q11: 180 beats 60 on small files (fewer, denser trees),
     neutral on the 16MB corpus (the 48-tree cap binds there) */
  static const double kTableCost = 180.0;
  int n_lit_trees = 1;
  if ((q >= 5 && nlit >= (size_t)(q >= 10 ? 256 : 1024)) ||
      ntypes > 1) {
    use_ctx = 1;
    mode = e->ctx_mode >= 0 ? e->ctx_mode
                             : choose_ctx_mode(data, lo, hi);
  }
  int nlit_rows = use_ctx ? ntypes * NUM_LIT_CTX : 1;
  lit_assign = (int*)malloc(sizeof(int) * (size_t)(ntypes * NUM_LIT_CTX));
  lit_reps = (int*)malloc(sizeof(int) * (size_t)(ntypes * NUM_LIT_CTX));
  lit_hist = (uint32_t*)calloc((size_t)nlit_rows * NUM_LIT,
                               sizeof(uint32_t));
  cmd_hist = (uint32_t*)calloc((size_t)ntypes_i * NUM_CMD,
                               sizeof(uint32_t));
  dist_hist = (uint32_t*)calloc((size_t)ntypes_d * 4 * dalpha,
                                sizeof(uint32_t));
  if (!lit_hist || !cmd_hist || !dist_hist || !lit_assign || !lit_reps) {
    rc = EERR_ALLOC;
    goto done;
  }
  const uint8_t* lut0 = kContextLut[use_ctx ? mode : 0];
  const uint8_t* lut1 = lut0 + 256;
  /* literal stream capture for the q11 split refinement */
  if (q >= 11 && use_ctx && nlit >= 4096 && nlit <= (64u << 20)) {
    lref_bytes = (uint8_t*)malloc(nlit);
    lref_ctx = (uint8_t*)malloc(nlit);
    if (!lref_bytes || !lref_ctx) {
      rc = EERR_ALLOC;
      goto done;
    }
  }
  {
    size_t lw = 0;
    size_t pos = lo;
    size_t lrun = 0, crun = 0, drun = 0;
    uint32_t lrem = ntypes > 1 ? lsp.rlen[0] : 0;
    uint32_t crem = ntypes_i > 1 ? csp.rlen[0] : 0;
    uint32_t drem = ntypes_d > 1 ? dsp.rlen[0] : 0;
    int ltype = 0, ctype = 0, dtype = 0;
    for (size_t i = 0; i < ncmd; i++) {
      const Cmd* c = &cmds[i];
      if (ntypes_i > 1) {
        if (crem == 0) {
          crun++;
          ctype = csp.rtype[crun];
          crem = csp.rlen[crun];
        }
        crem--;
      }
      cmd_hist[(size_t)ctype * NUM_CMD + plan[i].cmd_sym]++;
      for (uint32_t k = 0; k < c->ins; k++) {
        size_t pp = pos + k;
        if (ntypes > 1) {
          if (lrem == 0) {
            lrun++;
            ltype = lsp.rtype[lrun];
            lrem = lsp.rlen[lrun];
          }
          lrem--;
        }
        int row = 0;
        if (use_ctx) {
          uint8_t p1 = pp >= e->ctx_start + 1 ? data[pp - 1] : 0;
          uint8_t p2 = pp >= e->ctx_start + 2 ? data[pp - 2] : 0;
          row = (ltype << 6) | (lut0[p1] | lut1[p2]);
        }
        if (lref_bytes) {
          lref_bytes[lw] = data[pp];
          lref_ctx[lw] = (uint8_t)(row & 63);
          lw++;
        }
        lit_hist[(size_t)row * NUM_LIT + data[pp]]++;
      }
      pos += c->ins + (c->adv & ~CMD_DICT);
      if (plan[i].has_dist) {
        if (ntypes_d > 1) {
          if (drem == 0) {
            drun++;
            dtype = dsp.rtype[drun];
            drem = dsp.rlen[drun];
          }
          drem--;
        }
        int dctx = kCmdDistCtx[plan[i].cmd_sym];
        dist_hist[((size_t)dtype * 4 + dctx) * dalpha + plan[i].dcode]++;
      }
    }
  }

  /* ---- cluster literal (type, context) rows ---- */
  if (use_ctx) {
    int max_trees = q >= 10 ? MAX_LIT_TREES : (q >= 9 ? 16 : 12);
    /* swept: 1.5 bits/used-symbol recovers ~1% on dense binary
       histograms (mapsdatazrh: 48 -> ~20 trees) without hurting text */
    n_lit_trees = cluster_lit_rows(lit_hist, ntypes, max_trees,
                                   lit_assign, lit_reps);
    if (n_lit_trees < 0) {
      rc = EERR_ALLOC;
      goto done;
    }
    if (n_lit_trees == 1 && ntypes == 1) use_ctx = 0;
  }
  if (!use_ctx) {
    /* single tree: if clustering ran, lit_hist[lit_reps[0]] already
       holds the merged histogram; otherwise row 0 is the histogram */
    lit_assign[0] = 0;
    if (nlit_rows == 1) lit_reps[0] = 0;
    n_lit_trees = 1;
  }
  /* ---- q11 literal-split refinement against the clustered cost ---- */
  if (lref_bytes && use_ctx) {
    rc = refine_lit_split(&e->pm, nlit, lref_bytes, lref_ctx, &lsp,
                          &lit_hist, &lit_assign, &lit_reps,
                          &n_lit_trees);
    if (rc) goto done;
    ntypes = lsp.ntypes;
  }
  int multi = use_ctx || ntypes > 1;

  /* ---- cluster distance (type, context) rows ---- */
  int dist_assign[4 * MAX_DIST_TYPES];
  int dist_reps[4 * MAX_DIST_TYPES] = {0};
  int n_dist_trees = 1;
  if ((q >= 5 && ndist_syms >= 512) || ntypes_d > 1) {
    n_dist_trees = cluster_hists(dist_hist, ntypes_d * 4, dalpha,
                                 MAX_DIST_TREES, 30.0, 1.5, dist_assign,
                                 dist_reps);
    if (n_dist_trees < 0) {
      rc = EERR_ALLOC;
      goto done;
    }
  } else {
    for (int c = 1; c < 4; c++)
      for (int s = 0; s < dalpha; s++)
        dist_hist[s] += dist_hist[(size_t)c * dalpha + s];
    dist_reps[0] = 0;
    for (int c = 0; c < 4; c++) dist_assign[c] = 0;
  }

  /* ---- merge command block types whose trees don't pay ----
     RFC 7932 ties NTREESI to NBLTYPESI (commands have no context
     map), so every extra command type costs a full serialized tree
     (~600 bits measured); the k-means split prices a type at only
     its entropy gain. Re-cluster the per-type command histograms
     with tree-description pricing and fold merged types back into
     the run list (the reference bounds NBLTYPESI through the same
     histogram-clustering step, cluster.h role). */
  if (ntypes_i > 1) {
    int casgn[MAX_CMD_TYPES], creps[MAX_CMD_TYPES];
    /* swept on the ref-parse replay harness: 450 (vs 180/300/600)
       closes plrabn12 to ref-parity and trims lcet10/maps */
    double cmb = 450.0;
    {
      const char* v = getenv("BTPU_CMD_MERGE_BITS");
      if (v) cmb = atof(v);
    }
    int nt = cluster_hists(cmd_hist, ntypes_i, NUM_CMD, ntypes_i,
                           cmb, 1.5, casgn, creps);
    if (nt < 0) {
      rc = EERR_ALLOC;
      goto done;
    }
    if (nt < ntypes_i) {
      /* remap run types, coalesce adjacent equal runs, renumber in
         first-appearance order (run 0 must be type 0) */
      int fa[MAX_CMD_TYPES];
      for (int t = 0; t < nt; t++) fa[t] = -1;
      int nfa = 0;
      size_t w = 0;
      for (size_t r = 0; r < csp.nruns; r++) {
        int traw = casgn[csp.rtype[r]];
        if (fa[traw] < 0) fa[traw] = nfa++;
        uint8_t tnew = (uint8_t)fa[traw];
        if (w > 0 && csp.rtype[w - 1] == tnew) {
          csp.rlen[w - 1] += csp.rlen[r];
        } else {
          csp.rtype[w] = tnew;
          csp.rlen[w] = csp.rlen[r];
          w++;
        }
      }
      csp.nruns = w;
      /* reorder merged histogram rows into first-appearance slots */
      {
        uint32_t* tmp =
            (uint32_t*)malloc((size_t)nt * NUM_CMD * sizeof(uint32_t));
        if (!tmp) {
          rc = EERR_ALLOC;
          goto done;
        }
        for (int t = 0; t < nt; t++)
          memcpy(tmp + (size_t)fa[t] * NUM_CMD,
                 cmd_hist + (size_t)creps[t] * NUM_CMD,
                 NUM_CMD * sizeof(uint32_t));
        memcpy(cmd_hist, tmp, (size_t)nt * NUM_CMD * sizeof(uint32_t));
        free(tmp);
      }
      ntypes_i = nt;
      csp.ntypes = nt;
      if (nt == 1) split_free(&csp);
    }
  }

  /* ---- block-switch plans ---- */
  if (ntypes > 1 || ntypes_i > 1 || ntypes_d > 1) {
    lsw = (SwitchPlan*)malloc(sizeof(SwitchPlan) * 3);
    if (!lsw) {
      rc = EERR_ALLOC;
      goto done;
    }
    csw = lsw + 1;
    dsw = lsw + 2;
    if (ntypes > 1 && (rc = plan_switches_c(&lsp, &e->pm, lsw)) != 0)
      goto done;
    if (ntypes_i > 1 && (rc = plan_switches_c(&csp, &e->pm, csw)) != 0)
      goto done;
    if (ntypes_d > 1 && (rc = plan_switches_c(&dsp, &e->pm, dsw)) != 0)
      goto done;
  }

  /* ---- code lengths ---- */
  uint8_t lit_lens[MAX_LIT_TREES][NUM_LIT];
  uint16_t lit_codes[MAX_LIT_TREES][NUM_LIT];
  uint8_t lit_emit[MAX_LIT_TREES]; /* 0 => single-symbol, emit 0 bits */
  for (int t = 0; t < n_lit_trees; t++) {
    pm_lengths_rle(lit_hist + (size_t)lit_reps[t] * NUM_LIT, NUM_LIT,
                   NUM_LIT, lit_lens[t], &e->pm);
    int used = 0;
    for (int s = 0; s < NUM_LIT; s++)
      if (lit_lens[t][s]) used++;
    lit_emit[t] = used > 1;
    lengths_to_codes_c(lit_lens[t], NUM_LIT, lit_codes[t]);
  }
  uint8_t cmd_lens[MAX_CMD_TYPES][NUM_CMD];
  uint16_t cmd_codes[MAX_CMD_TYPES][NUM_CMD];
  uint8_t cmd_emit[MAX_CMD_TYPES];
  for (int t = 0; t < ntypes_i; t++) {
    pm_lengths_rle(cmd_hist + (size_t)t * NUM_CMD, NUM_CMD, NUM_CMD,
                   cmd_lens[t], &e->pm);
    int used = 0;
    for (int s = 0; s < NUM_CMD; s++)
      if (cmd_lens[t][s]) used++;
    cmd_emit[t] = used > 1;
    lengths_to_codes_c(cmd_lens[t], NUM_CMD, cmd_codes[t]);
  }
  uint8_t dist_lens[MAX_DIST_TREES][NUM_DIST_LW];
  uint16_t dist_codes[MAX_DIST_TREES][NUM_DIST_LW];
  uint8_t dist_emit[MAX_DIST_TREES];
  for (int t = 0; t < n_dist_trees; t++) {
    pm_lengths_rle(dist_hist + (size_t)dist_reps[t] * dalpha, dalpha,
                   dalpha, dist_lens[t], &e->pm);
    int used = 0;
    for (int s = 0; s < dalpha; s++)
      if (dist_lens[t][s]) used++;
    dist_emit[t] = used > 1;
    lengths_to_codes_c(dist_lens[t], dalpha, dist_codes[t]);
  }

  /* ---- header ---- */
  put_mlen_header(bw, mlen, is_last, 0);
  put_varlen_u8(bw, ntypes - 1); /* NBLTYPESL - 1 */
  if (ntypes > 1 && (rc = write_switch_header_c(bw, &lsp, lsw,
                                                &e->pm)) != 0)
    goto done;
  put_varlen_u8(bw, ntypes_i - 1); /* NBLTYPESI - 1 */
  if (ntypes_i > 1 && (rc = write_switch_header_c(bw, &csp, csw,
                                                  &e->pm)) != 0)
    goto done;
  put_varlen_u8(bw, ntypes_d - 1); /* NBLTYPESD - 1 */
  if (ntypes_d > 1 && (rc = write_switch_header_c(bw, &dsp, dsw,
                                                  &e->pm)) != 0)
    goto done;
  bw_put(bw, 0, 2);     /* NPOSTFIX */
  bw_put(bw, 0, 4);     /* NDIRECT >> NPOSTFIX */
  for (int t = 0; t < ntypes; t++)
    bw_put(bw, (uint64_t)(use_ctx ? mode : 0), 2); /* ctx mode per type */
  if (multi) {
    rc = write_context_map_c(bw, lit_assign, ntypes * NUM_LIT_CTX,
                             n_lit_trees, &e->pm);
    if (rc) goto done;
  } else {
    put_varlen_u8(bw, 0);
  }
  if (n_dist_trees > 1 || ntypes_d > 1) {
    rc = write_context_map_c(bw, dist_assign, ntypes_d * 4,
                             n_dist_trees, &e->pm);
    if (rc) goto done;
  } else {
    put_varlen_u8(bw, 0);
  }
  for (int t = 0; t < n_lit_trees; t++)
    write_huffman_code_c(bw, lit_lens[t], NUM_LIT, NUM_LIT, &e->pm);
  for (int t = 0; t < ntypes_i; t++)
    write_huffman_code_c(bw, cmd_lens[t], NUM_CMD, NUM_CMD, &e->pm);
  for (int t = 0; t < n_dist_trees; t++)
    write_huffman_code_c(bw, dist_lens[t], dalpha, dalpha, &e->pm);

  /* ---- body ---- */
  {
    size_t pos = lo;
    size_t lrun = 0, crun = 0, drun = 0;
    uint32_t lrem = ntypes > 1 ? lsp.rlen[0] : 0;
    uint32_t crem = ntypes_i > 1 ? csp.rlen[0] : 0;
    uint32_t drem = ntypes_d > 1 ? dsp.rlen[0] : 0;
    int ltype = 0, ctype = 0, dtype = 0;
    for (size_t i = 0; i < ncmd; i++) {
      const Cmd* c = &cmds[i];
      const Plan* pl = &plan[i];
      int sym = pl->cmd_sym;
      if (ntypes_i > 1) {
        if (crem == 0) {
          crun++;
          ctype = csp.rtype[crun];
          crem = csp.rlen[crun];
          emit_switch_c(bw, &csp, csw, crun);
        }
        crem--;
      }
      if (cmd_emit[ctype])
        bw_put(bw, cmd_codes[ctype][sym], cmd_lens[ctype][sym]);
      /* insert / copy extra bits */
      uint32_t ib = kCmdInsertExtra[sym];
      if (ib) bw_put(bw, c->ins - (uint32_t)kCmdInsertBase[sym], ib);
      uint32_t cb = kCmdCopyExtra[sym];
      if (cb) {
        uint32_t cval = c->cpy == 0 && c->dist == 0 ? 2 : c->cpy;
        bw_put(bw, cval - (uint32_t)kCmdCopyBase[sym], cb);
      }
      for (uint32_t k = 0; k < c->ins; k++) {
        size_t pp = pos + k;
        uint8_t lit = data[pp];
        if (ntypes > 1) {
          if (lrem == 0) {
            lrun++;
            ltype = lsp.rtype[lrun];
            lrem = lsp.rlen[lrun];
            emit_switch_c(bw, &lsp, lsw, lrun);
          }
          lrem--;
        }
        int t = 0;
        if (use_ctx) {
          uint8_t p1 = pp >= e->ctx_start + 1 ? data[pp - 1] : 0;
          uint8_t p2 = pp >= e->ctx_start + 2 ? data[pp - 2] : 0;
          t = lit_assign[(ltype << 6) | (lut0[p1] | lut1[p2])];
        }
        if (lit_emit[t]) bw_put(bw, lit_codes[t][lit], lit_lens[t][lit]);
      }
      pos += c->ins + (c->adv & ~CMD_DICT);
      if (pl->has_dist) {
        if (ntypes_d > 1) {
          if (drem == 0) {
            drun++;
            dtype = dsp.rtype[drun];
            drem = dsp.rlen[drun];
            emit_switch_c(bw, &dsp, dsw, drun);
          }
          drem--;
        }
        int dt = dist_assign[(dtype << 2) | kCmdDistCtx[sym]];
        if (dist_emit[dt])
          bw_put(bw, dist_codes[dt][pl->dcode], dist_lens[dt][pl->dcode]);
        if (pl->dbits) bw_put(bw, pl->dextra, pl->dbits);
      }
    }
  }
done:
  split_free(&lsp);
  split_free(&csp);
  split_free(&dsp);
  free(lsw);
  free(lit_hist);
  free(cmd_hist);
  free(dist_hist);
  free(lit_assign);
  free(lit_reps);
  free(lref_bytes);
  free(lref_ctx);
  return rc;
}

/* uncompressed metablock (byte-aligned raw copy) */
static int emit_uncompressed(Enc* e, size_t lo, size_t hi) {
  BW* bw = &e->bw;
  put_mlen_header(bw, hi - lo, 0, 1);
  if (bw_flush_align(bw)) return EERR_ALLOC;
  if (bw_reserve(bw, hi - lo)) return EERR_ALLOC;
  memcpy(bw->buf + bw->len, e->data + lo, hi - lo);
  bw->len += hi - lo;
  return 0;
}

static void put_stream_header(BW* bw, int wbits) {
  if (wbits > 24) { /* large-window extension (dec: DecodeWindowBits) */
    bw_put(bw, 1, 1);
    bw_put(bw, 0, 3);
    bw_put(bw, 1, 3);
    bw_put(bw, 0, 1);
    bw_put(bw, (uint64_t)wbits, 6);
    return;
  }
  if (wbits == 16) {
    bw_put(bw, 0, 1);
  } else if (wbits >= 18 && wbits <= 24) {
    bw_put(bw, 1, 1);
    bw_put(bw, (uint64_t)(wbits - 17), 3);
  } else if (wbits == 17) {
    bw_put(bw, 1, 1);
    bw_put(bw, 0, 3);
    bw_put(bw, 0, 3);
  } else { /* 10..15 */
    bw_put(bw, 1, 1);
    bw_put(bw, 0, 3);
    bw_put(bw, (uint64_t)(wbits - 8), 3);
  }
}

static void opt_cover_init(void);

/* quality -> matcher parameters */
static void cfg_for_quality(MatchCfg* cfg, int q) {
  /* hash width swept on the 16MB corpus: the 15-bit tables keep the
     whole bucket array cache-resident (q5: 207 vs 144 MB/s for +0.5%
     size; q6-7's deeper walk prefers 16 bits */
  cfg->hbits = q <= 1 ? 15 : q <= 4 ? 16 : q <= 5 ? 15 : q <= 7 ? 16
                                                            : 15;
  /* round-5 re-sweep vs the reference file-mode bar (ref picks
     block_bits = q-1, quality.h:188): q5 16-deep / q9 48-deep rings
     put the 16MB corpus BELOW ref file-mode size at each tier
     (570,592 vs 575,664 q5; 563,642 vs 564,293 q9) */
  cfg->depth = q <= 1 ? 1 : q <= 3 ? 4 : q <= 5 ? 16 : q <= 7 ? 32 : 48;
  cfg->block_bits = q <= 1 ? 0 : q <= 3 ? 2 : q <= 5 ? 4 : q <= 7 ? 5
                                                              : 6;
  cfg->lazy = q >= 2;
  cfg->use_dict = q >= 5;
  cfg->min_len = 4;
  cfg->h4 = 0;
  cfg->bt = NULL;
  /* 8-byte keys for the mid tiers on big inputs (the reference's
     file-mode H6 choice, quality.h:183-191); swept OFF: losing dense
     4-7 byte matches cost far more than the reach bought (16MB q5
     578 -> 643 KB) -- the long-range table supplies the reach instead */
  cfg->h8 = 0;
  /* long-range table (multi-MB repeat discovery): q2+; the q0/q1
     fast tiers have their own window-wide discovery. 15 bits keeps
     the table LLC-resident: swept 14/15/16/18 on the 16MB corpus,
     sizes within 0.06% but 127 vs 91 MB/s at q5 */
  cfg->lr_bits = q >= 2 ? 15 : 0;
  /* probe budget by tier: the fast-mid tiers only use the table as a
     repeat-onset safety net (probe at miss positions), the slow tiers
     probe any under-matched position. Interleaved A/B on the 16MB
     corpus: q5 probes at gate 32 cost ~22% wall for 1K of output. */
  cfg->lr_gate = q <= 5 ? 4 : 32;
  {
    const char* v = getenv("BTPU_LR");
    if (v && atoi(v) == 0) cfg->lr_bits = 0;
    v = getenv("BTPU_LR_BITS");
    if (v && cfg->lr_bits) cfg->lr_bits = atoi(v);
    v = getenv("BTPU_BB");
    if (v) cfg->block_bits = atoi(v);
    v = getenv("BTPU_HBITS");
    if (v) cfg->hbits = atoi(v);
    v = getenv("BTPU_DEPTH");
    if (v) cfg->depth = atoi(v);
    v = getenv("BTPU_H8");
    if (v) cfg->h8 = atoi(v);
    lr_gate_init();
    opt_cover_init();
  }
  cfg->lr_tab = NULL;
}

/* Allocate the hash tables a config calls for; input_hint (0 = not
   known, e.g. streaming) drops the long-range table for inputs too
   small for it to ever fire. */
static int cfg_alloc_tables(MatchCfg* cfg, size_t input_hint) {
  size_t hsize = (size_t)1 << cfg->hbits;
  cfg->bucket = (uint32_t*)calloc(hsize << cfg->block_bits,
                                  sizeof(uint32_t));
  cfg->num = (uint32_t*)calloc(hsize, sizeof(uint32_t));
  if (!cfg->bucket || !cfg->num) return EERR_ALLOC;
  if (cfg->lr_bits && input_hint && input_hint < ((size_t)1 << 19))
    cfg->lr_bits = 0;
  if (cfg->h8 && (!input_hint || input_hint < ((size_t)1 << 20)))
    cfg->h8 = 0;
  if (cfg->lr_bits) {
    size_t bytes = ((size_t)1 << (cfg->lr_bits + LR_REC_SHIFT)) *
                   sizeof(uint32_t);
    cfg->lr_tab = (uint32_t*)aligned_alloc(64, bytes);
    if (!cfg->lr_tab) return EERR_ALLOC;
    memset(cfg->lr_tab, 0, bytes);
  }
  return 0;
}

static void cfg_free_tables(MatchCfg* cfg) {
  free(cfg->bucket);
  free(cfg->num);
  free(cfg->lr_tab);
  cfg->bucket = cfg->num = cfg->lr_tab = NULL;
}

/* incompressibility estimate: sampled literal entropy */
static int looks_incompressible(const uint8_t* data, size_t lo, size_t hi,
                                size_t copy_bytes) {
  size_t mlen = hi - lo;
  if (copy_bytes * 50 > mlen) return 0;
  uint32_t h[256] = {0};
  size_t stride = mlen > (1 << 16) ? mlen / (1 << 16) : 1;
  size_t cnt = 0;
  for (size_t p = lo; p < hi; p += stride) {
    h[data[p]]++;
    cnt++;
  }
  double bits = hist_entropy(h, 256);
  return bits > 7.8 * (double)cnt;
}

/* ---------- native optimal parse (q10/q11) ----------
 *
 * Role parity: the reference zopfli tier (c/enc/backward_references_hq.c
 * ZopfliComputeShortestPath / ZopfliCostModel). Per ~4MB metablock:
 * a greedy seed pass calibrates the cost model (context-modeled literal
 * bits, copy/dist symbol bits from the seed's ACTUAL emission plan,
 * ring codes included), then a forward shortest-path DP relaxes
 * increasing-length hasher candidates, distance-cache probes against
 * the seed parse's ring timeline, and atomic dictionary edges. The
 * device DP (ops/optimal_jax.py) remains the large-input path; this
 * tier serves small inputs and CPU-only hosts at reference-like speed.
 */

/* cost-calibration defaults swept on the Canterbury texts +
   mapsdatazrh (realized-size optimum, not entropy-ideal: the emitter's
   clustering and block splits reward slightly literal-averse parses) */
static double opt_lit_scale(int ctx_mode) {
  const char* v = getenv("BTPU_OPT_LIT_SCALE");
  /* realized-size optimum is input-type dependent: the emitter's
     literal clustering/context-mapping recovers MORE than the proxy
     predicts on non-text inputs, so binary inputs want a parse closer
     to the entropy-ideal trade (swept: mapsdatazrh 159,629 -> 159,368
     at 1.1 while 1.3 stays best on every UTF8 Canterbury text) */
  return v ? atof(v) : (ctx_mode == 2 ? 1.3 : 1.1);
}
static double opt_ins_scale(void) {
  const char* v = getenv("BTPU_OPT_INS_SCALE");
  return v ? atof(v) : 0.7;
}
static double opt_dist_scale(void) {
  const char* v = getenv("BTPU_OPT_DIST_SCALE");
  return v ? atof(v) : 0.9;
}

/* copy-length stops relaxed per candidate besides the full length (the
   host DP's _TRUNC_STOPS role: landing exactly on a later match start) */
/* matches at least this long are committed greedily and their
   interior skipped (BROTLI_LONG_COPY_QUICK_STEP, quality.h:14) */
#define OPT_LONG_SKIP 16384

/* Position insertion for the optimal-parse DP: binary tree when
   attached (depth-16 insert-only descent; interior positions carry
   no long-range insert -- their 16-grams duplicate the match source,
   see insert_hash_ex), bucket rings otherwise. */
static inline void opt_insert_pos(const uint8_t* data, size_t n,
                                  size_t i, size_t maxback,
                                  MatchCfg* cfg, int interior) {
  if (cfg->bt) {
    /* interior positions are NOT indexed in the tree (the reference's
       H10 skip behavior: sources inside a committed long copy
       duplicate the first occurrence, which IS indexed; the 64 live
       positions before each skip end cover the seams) */
    size_t rem = n - i;
    if (!interior && rem >= 4) {
      size_t maxd = i < maxback ? i : maxback;
      size_t limit = rem < BT_MAX_CMP ? rem : BT_MAX_CMP;
      bt_walk(cfg->bt, data, i, maxd, limit, 16, 4, NULL, NULL);
    }
    if (!interior && cfg->lr_bits) lr_insert(data, i, cfg);
  } else {
    insert_hash_ex(data, i, cfg, !interior);
  }
}

/* seed-covered walk budget (see opt_parse_block): inside a seed match
   with >= g_opt_cover_gate bytes remaining, the candidate walk drops
   to g_opt_cover_depth entries */
/* defaults swept on Canterbury-4+maps: gate/depth 64 halves q11 wall
   (11.0 -> 5.3 s) for +5 B; 32/32 starts costing size (+93 B) */
static int g_opt_cover_gate = 64;
static int g_opt_cover_depth = 64;
static int g_opt_no_ring = 0; /* diagnostic: drop distance-cache edges */
static int g_opt_dict_gate = 16;  /* probe dict when best_len < this */
/* affix level 2 (no prefix pass): the DP probes the dictionary at
   ~70% of positions, and level 3's prefix probing was 22% of the
   whole q11 wall for 328 B on Canterbury-5 (2.72 -> 2.11 s; 16MB
   529,145 -> 529,565 B at 4.4 -> 5.4 MB/s) */
static int g_opt_dict_level = 2;
static void opt_cover_init(void) {
  const char* v = getenv("BTPU_OPT_COVER_GATE");
  if (v) g_opt_cover_gate = atoi(v);
  v = getenv("BTPU_OPT_COVER_DEPTH");
  if (v) g_opt_cover_depth = atoi(v);
  v = getenv("BTPU_OPT_NO_RING");
  g_opt_no_ring = v ? atoi(v) : 0;
  v = getenv("BTPU_OPT_DICT_GATE");
  if (v) g_opt_dict_gate = atoi(v);
  v = getenv("BTPU_OPT_DICT_LEVEL");
  if (v) g_opt_dict_level = atoi(v);
}

/* dense short stops: the reference zopfli relaxes EVERY length of a
   candidate (UpdateNodes), so truncations land exactly on later match
   starts; geometric-only stops missed those landings for short copies
   (lcet10/plrabn12 literalized ~3-8 KB more than the reference).
   Dense to 33, geometric beyond. */
static const int kOptStops[] = {4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                                15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                                25, 26, 27, 28, 29, 30, 31, 32, 33, 42,
                                54, 70, 86, 110, 136, 176, 217, 280,
                                346, 552, 881, 1406, 2245};
#define N_OPT_STOPS (int)(sizeof(kOptStops) / sizeof(kOptStops[0]))
/* copy codes of the fixed stop lengths (value_code is a binary search;
   the DP's hot loop looks these up instead), plus direct-lookup code
   tables for small insert/copy values */
static int kOptStopCode[N_OPT_STOPS];
static uint8_t kCpyCodeLut[2048];
static volatile int g_opt_stop_ready = 0;

static inline int cpy_code_fast(uint32_t v) {
  return v < 2048 ? kCpyCodeLut[v] : value_code(v, kCopyBase, 24);
}

typedef struct {
  float litc_base;     /* flat literal cost when no context model */
  float* litc;         /* per-position literal bits (metablock) */
  int dalpha;          /* distance symbol alphabet (64 / 140) */
  int ctx_mode_force;  /* forced literal context mode (-1 = sniff) */
  float ccost[24];     /* copy-code bits incl. insert share + cmd base */
  float dsym[NUM_DIST_LW]; /* distance symbol bits */
  float stopcost[N_OPT_STOPS];  /* ccost at the fixed stop lengths */
  /* short-code distance bits for seed-ring hits (dcode 0-3, no extra
     bits): the reference ZopfliCostModel prices distance-cache reuse
     through the distance histogram (backward_references_hq.c:83-105);
     pricing ring probes at the explicit-symbol cost overcharges them
     by the extra-bit count and suppresses distance reuse */
  float dring[16];
  /* joint implicit-cell pricing for dist-code-0 copies <= 69 bytes:
     cmd cells 0-127 carry insert length, copy code AND the implied
     distance in ONE symbol (RFC 7932 5.), so a cached-distance short
     copy costs icell[ccode] TOTAL -- the separable model
     (ccost + dring[0]) overprices it and suppresses the reference's
     implicit-dist0 basin (it emits 3-10x more such commands) */
  float icell[16];
} OptCost;

static inline float opt_dist_cost(const OptCost* oc, uint32_t dist) {
  uint64_t d = (uint64_t)dist - 1;
  uint64_t t = (d + 4) >> 2;
  int nbits = 64 - __builtin_clzll(t | 1); /* bit_length(t) */
  uint64_t rest = d + 4 - (1ull << (nbits + 1));
  int half = (int)(rest >> nbits);
  int sym = 16 + (((nbits - 1) << 1) | half);
  if (sym >= oc->dalpha) sym = oc->dalpha - 1;
  return oc->dsym[sym] + (float)nbits;
}


static int utf8_window_cost(const uint8_t* data, size_t lo, size_t hi,
                            float* ucost);

/* Build the cost model from a seed command array (costs mirror
   ops/optimal_jax._cost_tables: +1 smoothing, 1.1 literal surcharge,
   measured insert share, 1-bit command floor). */
static void opt_costs_from_seed(const uint8_t* data, size_t lo, size_t hi,
                                const Cmd* cmds, size_t ncmd,
                                const uint32_t* ring_in, Plan* plan,
                                OptCost* oc) {
  int dalpha = oc->dalpha ? oc->dalpha : NUM_DIST;
  uint32_t ring[4];
  memcpy(ring, ring_in, sizeof(ring));
  plan_cmds(cmds, ncmd, ring, plan);
  int mode = oc->ctx_mode_force >= 0 ? oc->ctx_mode_force
                                     : choose_ctx_mode(data, lo, hi);
  const uint8_t* lut0 = kContextLut[mode];
  const uint8_t* lut1 = lut0 + 256;
  uint32_t* lh = (uint32_t*)calloc((size_t)NUM_LIT_CTX * 256,
                                   sizeof(uint32_t));
  uint32_t ch[24];
  uint32_t dh[NUM_DIST_LW];
  uint32_t jh[704];
  memset(ch, 0, sizeof(ch));
  memset(dh, 0, sizeof(dh));
  memset(jh, 0, sizeof(jh));
  size_t pos = lo;
  for (size_t i = 0; i < ncmd; i++) {
    const Cmd* c = &cmds[i];
    if (lh) {
      for (uint32_t k = 0; k < c->ins; k++) {
        size_t pp = pos + k;
        uint8_t p1 = pp >= 1 ? data[pp - 1] : 0;
        uint8_t p2 = pp >= 2 ? data[pp - 2] : 0;
        lh[(size_t)(lut0[p1] | lut1[p2]) * 256 + data[pp]]++;
      }
    }
    pos += c->ins + (c->adv & ~CMD_DICT);
    if (c->cpy || c->dist) {
      ch[value_code(c->cpy, kCopyBase, 24)]++;
      jh[plan[i].cmd_sym]++;
      if (plan[i].has_dist) dh[plan[i].dcode]++;
    }
  }
  /* literal bits per position (context-modeled, +1 smoothing, 1.1
     surcharge, capped): one 64x256 bits table, then a gather -- the
     per-position -log2 was a 4M-transcendental hot spot */
  {
    double lscale = opt_lit_scale(mode);
    float* bits_tab = (float*)malloc((size_t)NUM_LIT_CTX * 256 *
                                     sizeof(float));
    if (!bits_tab) { /* OOM: flat literal costs still yield a valid
                        (just less optimal) parse */
      for (size_t pp = lo; pp < hi; pp++) oc->litc[pp - lo] = 8.0f;
    } else {
    for (int cx = 0; cx < NUM_LIT_CTX; cx++) {
      uint64_t t = 0;
      for (int b = 0; b < 256; b++) t += lh[(size_t)cx * 256 + b];
      double row_tot = (double)t + 256.0;
      double lt = log2(row_tot);
      for (int b = 0; b < 256; b++) {
        double bits = (lt - log2((double)(lh[(size_t)cx * 256 + b] + 1)))
                      * lscale;
        bits_tab[(size_t)cx * 256 + b] = (float)(bits > 24.0 ? 24.0
                                                             : bits);
      }
    }
    for (size_t pp = lo; pp < hi; pp++) {
      uint8_t p1 = pp >= 1 ? data[pp - 1] : 0;
      uint8_t p2 = pp >= 2 ? data[pp - 2] : 0;
      int cx = lut0[p1] | lut1[p2];
      oc->litc[pp - lo] = bits_tab[(size_t)cx * 256 + data[pp]];
    }
    free(bits_tab);
    }
    /* literal-model mode (BTPU_OPT_LIT_MODE): ctx (default) prices
       literals by the seed parse's 2nd-order context histogram; win
       swaps in the reference's UTF8 sliding-window model
       (literal_cost.c); blend averages the two (the device DP's
       exact-lit blend) */
    const char* lm = getenv("BTPU_OPT_LIT_MODE");
    if (lm && (lm[0] == 'w' || lm[0] == 'b')) {
      float* uc = (float*)malloc((hi - lo) * sizeof(float));
      if (uc && utf8_window_cost(data, lo, hi, uc) == 0) {
        double ls = opt_lit_scale(mode);
        for (size_t pp = lo; pp < hi; pp++) {
          float w = (float)(uc[pp - lo] * ls);
          oc->litc[pp - lo] = lm[0] == 'w'
              ? w : 0.5f * (oc->litc[pp - lo] + w);
        }
      }
      free(uc);
    }
  }
  free(lh);
  /* copy-code bits + measured insert share + 1-bit command floor */
  double ctot = 0, jtot = 0;
  for (int i = 0; i < 24; i++) ctot += ch[i] + 0.2;
  for (int i = 0; i < 704; i++) jtot += jh[i];
  double copy_avg = 0, joint_avg = 0;
  for (int i = 0; i < 24; i++) {
    double p = (ch[i] + 0.2) / ctot;
    copy_avg += -p * log2(p);
  }
  if (jtot > 16) {
    for (int i = 0; i < 704; i++) {
      if (!jh[i]) continue;
      double p = jh[i] / jtot;
      joint_avg += -p * log2(p);
    }
  }
  double ins_share = joint_avg - copy_avg;
  if (jtot <= 16 || ins_share < 0.5) ins_share = jtot <= 16 ? 3.0 : 0.5;
  ins_share *= opt_ins_scale();
  for (int i = 0; i < 24; i++) {
    double p = (ch[i] + 0.2) / ctot;
    oc->ccost[i] = (float)(-log2(p) + kCopyExtra[i] + ins_share + 1.0);
  }
  double dtot = 0;
  for (int i = 0; i < dalpha; i++) dtot += dh[i] + 0.2;
  for (int i = 0; i < dalpha; i++)
    oc->dsym[i] = (float)(-log2((dh[i] + 0.2) / dtot) *
                          opt_dist_scale());
  pthread_mutex_lock(&g_init_lock);
  if (!g_opt_stop_ready) {
    for (int i = 0; i < N_OPT_STOPS; i++)
      kOptStopCode[i] = value_code((uint32_t)kOptStops[i], kCopyBase,
                                   24);
    for (uint32_t v = 0; v < 2048; v++)
      kCpyCodeLut[v] = (uint8_t)value_code(v, kCopyBase, 24);
    g_opt_stop_ready = 1;
  }
  pthread_mutex_unlock(&g_init_lock);
  for (int i = 0; i < N_OPT_STOPS; i++)
    oc->stopcost[i] = oc->ccost[kOptStopCode[i]];
  for (int s = 0; s < 16; s++) oc->dring[s] = oc->dsym[s];
  {
    /* pad 0 re-swept with the dense short stops (round-4): the old
       2.0-bit pad countered phantom-landing optimism that the dense
       stops eliminated; 0 is now best on every Canterbury text AND
       mapsdatazrh (total -293 bytes vs pad=2) */
    const char* v = getenv("BTPU_OPT_ICELL_PAD");
    double pad = v ? atof(v) : 0.0;
    for (int cc = 0; cc < 16; cc++) {
      if (jtot > 16) {
        double f = 0.2;
        for (int ic = 0; ic < 8; ic++)
          f += jh[(cc >= 8 ? 64 : 0) + (ic << 3) + (cc & 7)];
        oc->icell[cc] = (float)(-log2(f / jtot) + kCopyExtra[cc] + pad);
      } else {
        oc->icell[cc] = oc->ccost[cc] + oc->dsym[0];
      }
    }
  }
}

/* Forward shortest-path over [lo, hi): backptr arrays encode each
   position's best incoming edge (blen 0 = literal). Candidates walk
   the bucket ring nearest-to-farthest, so only length-extending
   entries matter; distance-cache probes reconstruct the ring at each
   node from the best path's own backpointers. */
static int opt_parse_block(const uint8_t* data, size_t n, size_t lo,
                           size_t hi, size_t maxback, MatchCfg* cfg,
                           const Cmd* seed, size_t nseed,
                           const uint32_t* ring_in, const OptCost* oc,
                           float* dp, uint32_t* blen, uint32_t* bcpy,
                           uint32_t* bdist, uint32_t* lastm,
                           Cmd** out_cmds, size_t* out_ncmd) {
  size_t m = hi - lo;
  for (size_t i = 0; i <= m; i++) {
    dp[i] = 1e30f;
    blen[i] = 0;
  }
  dp[0] = 0.0f;
  lastm[0] = 0;
  size_t si = 0;        /* next seed cmd */
  size_t spos = lo;     /* input consumed by seed cmds < si */
  /* positions below skip_until ride a committed long copy (the
     reference's BROTLI_LONG_COPY_QUICK_STEP role,
     backward_references_hq.c:660-668): candidate discovery inside a
     megabyte-scale repeat would run a megabyte common_len per
     position (quadratic); the interior keeps only the literal chain
     and sparse hash inserts */
  size_t skip_until = lo;
  for (size_t i = lo; i < hi; i++) {
    size_t ii = i - lo;
    /* advance past seed commands ending at or before i */
    while (si < nseed) {
      const Cmd* sc = &seed[si];
      size_t end = spos + sc->ins + (sc->adv & ~CMD_DICT);
      if (end > i) break;
      spos = end;
      si++;
    }
    if (dp[ii] >= 1e29f) { /* unreachable (skipped-span interior) */
      if ((i & 7) == 0) opt_insert_pos(data, n, i, maxback, cfg, 1);
      continue;
    }
    /* literal edge */
    {
      float c = dp[ii] + oc->litc[ii];
      if (c < dp[ii + 1]) {
        dp[ii + 1] = c;
        blen[ii + 1] = 0;
        lastm[ii + 1] = lastm[ii];
      }
    }
    if (i < skip_until) {
      if ((i & 7) == 0) opt_insert_pos(data, n, i, maxback, cfg, 1);
      continue;
    }
    size_t rem = n - i;
    size_t limit = rem < MAX_COPY_LEN ? rem : MAX_COPY_LEN;
    if (hi - i < limit) limit = hi - i; /* commands stay in-block */
    size_t maxd = i < maxback ? i : maxback;
    const uint8_t* p = data + i;
    size_t best_len = 3;  /* longest seen (any source): dict gate */
    /* relax one candidate (len L at dist d) over stops above lo_ + L
       (stops <= lo_ are dominated by a NEARER candidate already
       relaxed at those lengths) */
    #define OPT_RELAX(L_, d_, lo_, dbits_)                             \
      do {                                                             \
        size_t L__ = (L_);                                             \
        size_t lo__ = (lo_);                                           \
        uint32_t d__ = (uint32_t)(d_);                                 \
        float dc__ = dp[ii] + (dbits_);                                \
        for (int s_ = 0; s_ < N_OPT_STOPS; s_++) {                    \
          size_t l_ = (size_t)kOptStops[s_];                           \
          if (l_ >= L__) break; /* stops are sorted */                 \
          if (l_ <= lo__) continue;                                    \
          float c_ = dc__ + oc->stopcost[s_];                          \
          if (c_ < dp[ii + l_]) {                                      \
            dp[ii + l_] = c_;                                          \
            blen[ii + l_] = (uint32_t)l_;                              \
            bcpy[ii + l_] = (uint32_t)l_;                              \
            bdist[ii + l_] = d__;                                      \
            lastm[ii + l_] = (uint32_t)(ii + l_);                      \
          }                                                            \
        }                                                              \
        {                                                              \
          float c_ = dc__ + oc->ccost[cpy_code_fast((uint32_t)L__)];   \
          if (c_ < dp[ii + L__]) {                                     \
            dp[ii + L__] = c_;                                         \
            blen[ii + L__] = (uint32_t)L__;                            \
            bcpy[ii + L__] = (uint32_t)L__;                            \
            bdist[ii + L__] = d__;                                     \
            lastm[ii + L__] = (uint32_t)(ii + L__);                    \
          }                                                            \
        }                                                              \
      } while (0)
    /* seed continuation edge: positions covered by a seed match get
       that match's remaining span at its distance (the host DP's
       SLOT_SEED / the device DP's continuation edges -- the bucket
       ring forgets far sources long before the window does, so long
       seed matches are pool candidates the walk cannot reproduce) */
    size_t cover_rem = 0; /* remaining span of the covering seed match */
    if (si < nseed && rem >= 4) {
      const Cmd* sc = &seed[si];
      if (sc->cpy && !(sc->adv & CMD_DICT)) {
        size_t ms = spos + sc->ins;
        size_t me = ms + (sc->adv & ~CMD_DICT);
        if (i >= ms && i < me && (size_t)sc->dist <= maxd) {
          size_t l = me - i;
          if (l > limit) l = limit;
          if (l >= 4) {
            OPT_RELAX(l, sc->dist, (size_t)0,
                      opt_dist_cost(oc, (uint32_t)sc->dist));
            if (l > best_len) best_len = l;
            cover_rem = l;
          }
        }
      }
    }
    /* distance-cache probes: reconstruct the ring at THIS node from
       the best path's backpointers (ComputeDistanceCache role,
       backward_references_hq.c) so short-code pricing matches what
       emission replay will actually see; relax every stop -- ring
       distances are not ordered vs the bucket walk's */
    if (rem >= 4 && g_opt_no_ring != 1) {
      uint32_t nring[4];
      {
        int nf = 0;
        size_t j = lastm[ii];
        while (j > 0 && nf < 4) {
          uint32_t bl = blen[j];
          if (!(bl & CMD_DICT)) {
            uint32_t d_ = bdist[j];
            if (nf == 0 || nring[nf - 1] != d_) nring[nf++] = d_;
          }
          j = lastm[j - (bl & ~CMD_DICT)];
        }
        for (int t = 0; nf < 4; t++, nf++) nring[nf] = ring_in[t];
      }
      if (g_opt_no_ring == 3 || g_opt_no_ring == 4) {
        /* diagnostic: SEED-timeline ring (what a device-side slot can
           know without path state) instead of the path ring. Mode 3:
           ring[0] only; mode 4: the last 4 DISTINCT seed distances. */
        uint32_t sr_[4] = {0, 0, 0, 0};
        int nf_ = 0;
        if (si < nseed) {
          const Cmd* sc = &seed[si];
          size_t ms = spos + sc->ins;
          if (sc->cpy && !(sc->adv & CMD_DICT) && i >= ms)
            sr_[nf_++] = sc->dist;
        }
        int want_ = g_opt_no_ring == 3 ? 1 : 4;
        for (size_t t = si; t-- > 0 && nf_ < want_;) {
          if (seed[t].cpy && !(seed[t].adv & CMD_DICT)) {
            uint32_t d_ = seed[t].dist;
            int dup_ = 0;
            for (int u = 0; u < nf_; u++) dup_ |= sr_[u] == d_;
            if (!dup_) sr_[nf_++] = d_;
          }
        }
        for (int u = 0; u < 4; u++)
          nring[u] = u < nf_ ? sr_[u] : 0;
      }
      /* 16 short-code probes: the 4 exact slots plus ring[0]+-1..3
         and ring[1]+-1..3 (dcodes 4-15), each priced at its
         short-code symbol cost (kDistanceCacheIndex/-Offset role) */
      static const int8_t kRingIdx[16] = {0, 1, 2, 3, 0, 0, 0, 0,
                                          0, 0, 1, 1, 1, 1, 1, 1};
      static const int8_t kRingOff[16] = {0, 0, 0, 0, -1, 1, -2, 2,
                                          -3, 3, -1, 1, -2, 2, -3, 3};
      int nprobe = g_opt_no_ring < 0 ? -g_opt_no_ring
                   : g_opt_no_ring == 7 ? 0 : 16;
      for (int s = 0; s < nprobe; s++) {
        long ds = (long)nring[kRingIdx[s]] + kRingOff[s];
        if (ds <= 0 || (size_t)ds > maxd) continue;
        size_t d = (size_t)ds;
        if (s > 0 && (d == nring[0] || (s > 1 && d == nring[1]) ||
                      (s > 2 && d == nring[2])))
          continue;
        const uint8_t* q = p - d;
        if (q[0] != p[0]) continue;
        size_t lim_ = limit;
        if (g_opt_no_ring == 5 && lim_ > 16) lim_ = 16;  /* diag */
        if (g_opt_no_ring == 6 && lim_ > 32) lim_ = 32;  /* diag */
        size_t l = common_len(p, q, lim_);
        /* len-2 copies are in the command alphabet and pay no match
           discovery: on cached distances they beat two literals
           whenever the short code is cheap (the reference zopfli
           allows len 2 for distance-cache matches too,
           backward_references_hq.c); gate len >= 3 only for the
           offset probes (s >= 4), whose extra rarely amortizes */
        if (l >= (size_t)(s < 4 ? 2 : 3)) {
          OPT_RELAX(l, d, (size_t)0, oc->dring[s]);
          if (l > best_len) best_len = l;
        }
        if (s == 0 && l >= 2 && g_opt_no_ring != 2) {
          /* re-relax short lengths at the joint implicit-cell price */
          size_t lcap = l <= 69 ? l : 69;
          size_t lset[4] = {lcap, 2, 3, 0};
          int nls = lcap > 3 ? 3 : (lcap == 3 ? 2 : 1);
          for (int t = 0; t < nls; t++) {
            size_t l2 = lset[t];
            float c_ = dp[ii] + oc->icell[cpy_code_fast((uint32_t)l2)];
            if (c_ < dp[ii + l2]) {
              dp[ii + l2] = c_;
              blen[ii + l2] = (uint32_t)l2;
              bcpy[ii + l2] = (uint32_t)l2;
              bdist[ii + l2] = (uint32_t)d;
              lastm[ii + l2] = (uint32_t)(ii + l2);
            }
          }
          for (int t = 0; t < N_OPT_STOPS; t++) {
            size_t l2 = (size_t)kOptStops[t];
            if (l2 >= lcap) break;
            float c_ = dp[ii] + oc->icell[kOptStopCode[t]];
            if (c_ < dp[ii + l2]) {
              dp[ii + l2] = c_;
              blen[ii + l2] = (uint32_t)l2;
              bcpy[ii + l2] = (uint32_t)l2;
              bdist[ii + l2] = (uint32_t)d;
              lastm[ii + l2] = (uint32_t)(ii + l2);
            }
          }
        }
      }
      size_t walk_best = 3;
      if (cfg->bt) {
        /* binary-tree candidate walk (H10 role, see bt_walk): the
           descent yields a strictly-increasing-length candidate set
           and inserts the position as a side effect. Covered
           positions keep a shallow descent (the continuation edge is
           already the high-value candidate there). */
        int bdep = cover_rem >= (size_t)g_opt_cover_gate
                       ? (g_opt_cover_depth < BT_DEPTH
                              ? g_opt_cover_depth : BT_DEPTH)
                       : BT_DEPTH;
        uint32_t bc[BT_DEPTH], bln[BT_DEPTH];
        size_t cap = limit < BT_MAX_CMP ? limit : BT_MAX_CMP;
        size_t nb = bt_walk(cfg->bt, data, i, maxd, cap, bdep, 4,
                            bc, bln);
        if (nb && bln[nb - 1] == cap && cap < limit) {
          /* longest candidate hit the tree-compare cap: recover its
             true length with one extension outside the tree */
          size_t cpos = bc[nb - 1];
          bln[nb - 1] = (uint32_t)(cap + common_len(
              p + cap, data + cpos + cap, limit - cap));
        }
        for (size_t t = 0; t < nb; t++) {
          size_t l = bln[t];
          size_t d = i - (size_t)bc[t];
          OPT_RELAX(l, d, walk_best, opt_dist_cost(oc, (uint32_t)d));
          walk_best = l;
          if (l > best_len) best_len = l;
        }
      } else {
      /* bucket-ring walk, nearest to farthest: within the walk, a
         candidate matters only above the best NEARER length */
      uint32_t h = cfg->h4 ? hash4n(p, cfg->hbits)
                   : cfg->h8 ? hash8(p, cfg->hbits)
                             : hash5(p, cfg->hbits);
      uint32_t cnt = cfg->num[h];
      uint32_t bmask = (1u << cfg->block_bits) - 1;
      const uint32_t* bk = cfg->bucket + ((size_t)h << cfg->block_bits);
      uint32_t iters = cnt < bmask + 1u ? cnt : bmask + 1u;
      {
        /* walk budget: a position the seed already covers with a
           long match keeps only a shallow walk -- the continuation
           edge IS the high-value candidate there, and the deep walk
           is the q11 hot cost (80% of wall in opt_parse_block) */
        uint32_t dcap = cover_rem >= (size_t)g_opt_cover_gate
                            ? (uint32_t)g_opt_cover_depth
                            : (uint32_t)cfg->depth;
        if (iters > dcap) iters = dcap;
      }
      for (uint32_t t = 1; t <= iters; t++) {
        size_t cand = (size_t)bk[(cnt - t) & bmask] - 1;
        size_t d = i - cand;
        if (d > maxd) break;
        if (walk_best >= limit) break;
        const uint8_t* q = data + cand;
        if (q[walk_best] != p[walk_best]) continue;
        size_t l = common_len(p, q, limit);
        if (l >= 4 && l > walk_best) {
          OPT_RELAX(l, d, walk_best, opt_dist_cost(oc, (uint32_t)d));
          walk_best = l;
          if (l > best_len) best_len = l;
        }
      }
      }
      /* long-range probe: window-scale repeats the primary rings
         forget (see MatchCfg.lr_tab) */
      if (cfg->lr_bits && rem >= LR_MIN_LEN) {
        uint32_t lh = hash16(p, cfg->lr_bits);
        const uint32_t* lbk = cfg->lr_tab +
                              ((size_t)lh << LR_REC_SHIFT);
        uint32_t lcnt = lbk[0];
        uint32_t lit_ = lcnt < (1u << LR_RING_BITS)
                            ? lcnt : (1u << LR_RING_BITS);
        size_t lbest = walk_best > LR_MIN_LEN - 1 ? walk_best
                                                  : LR_MIN_LEN - 1;
        for (uint32_t t = 1; t <= lit_; t++) {
          size_t cand =
              (size_t)lbk[1 + ((lcnt - t) &
                              ((1u << LR_RING_BITS) - 1))] - 1;
          size_t d = i - cand;
          if (d > maxd) break;
          if (lbest >= limit) break;
          const uint8_t* q = data + cand;
          if (q[lbest] != p[lbest] || q[0] != p[0]) continue;
          size_t l = common_len(p, q, limit);
          if (l > lbest) {
            OPT_RELAX(l, d, lbest, opt_dist_cost(oc, (uint32_t)d));
            lbest = l;
            if (l > best_len) best_len = l;
          }
        }
      }
      /* dictionary edge (atomic: relax the exact output length) */
      if (cfg->use_dict && best_len < (size_t)g_opt_dict_gate) {
        int dcopy = 0, dtid = 0, dwlen = 0;
        uint32_t didx = 0;
        int dout = dict_probe(data, i, n, 4, g_opt_dict_level, &dcopy,
                              &dtid, &didx, &dwlen);
        if (dout >= 4 && (size_t)dout <= hi - i) {
          uint32_t dist = (uint32_t)(maxd + 1 +
                                     ((uint32_t)dtid
                                      << kDictSizeBits[dwlen]) + didx);
          float c = dp[ii] + opt_dist_cost(oc, dist) +
                    oc->ccost[cpy_code_fast((uint32_t)dcopy)];
          if (c < dp[ii + dout]) {
            dp[ii + dout] = c;
            blen[ii + dout] = (uint32_t)dout | CMD_DICT;
            bcpy[ii + dout] = (uint32_t)dcopy;
            bdist[ii + dout] = dist;
            lastm[ii + dout] = (uint32_t)(ii + dout);
          }
        }
      }
    }
    #undef OPT_RELAX
    /* commit very long copies greedily: their interior is skipped
       (tail positions stay live so the parse blends into what
       follows) */
    if (best_len >= OPT_LONG_SKIP) {
      size_t su = i + best_len - 64;
      if (su > skip_until) skip_until = su;
    }
    if (cfg->bt) { /* bt_walk already inserted at the candidate stage */
      if (cfg->lr_bits) lr_insert(data, i, cfg);
    } else {
      insert_hash(data, i, cfg);
    }
  }
  /* backtrack into commands */
  size_t ncmd = 0, j = m;
  while (j > 0) { /* count edges (matches only) */
    if (blen[j] == 0) {
      j--;
    } else {
      j -= blen[j] & ~CMD_DICT;
      ncmd++;
    }
  }
  Cmd* cmds = (Cmd*)malloc(sizeof(Cmd) * (ncmd + 1));
  if (!cmds) return EERR_ALLOC;
  size_t k = ncmd;
  size_t lit_end = m;
  j = m;
  size_t trail_lit = 0;
  while (j > 0) {
    if (blen[j] == 0) {
      j--;
      continue;
    }
    size_t adv = blen[j] & ~CMD_DICT;
    size_t start = j - adv;
    k--;
    cmds[k].cpy = bcpy[j];
    cmds[k].dist = bdist[j];
    cmds[k].adv = blen[j];
    /* literals between this match's end and the next match's start
       belong to the NEXT command's ins; compute on the forward fixup */
    cmds[k].ins = (uint32_t)start; /* temp: match start */
    lit_end = start;
    j = start;
  }
  (void)lit_end;
  /* forward fixup: ins = gap between previous command's end and the
     match start stored above */
  size_t pos = 0;
  for (size_t t = 0; t < ncmd; t++) {
    size_t start = cmds[t].ins;
    cmds[t].ins = (uint32_t)(start - pos);
    pos = start + (cmds[t].adv & ~CMD_DICT);
  }
  trail_lit = m - pos;
  if (trail_lit > 0 || ncmd == 0) {
    cmds[ncmd].ins = (uint32_t)trail_lit;
    cmds[ncmd].cpy = 0;
    cmds[ncmd].dist = 0;
    cmds[ncmd].adv = 0;
    ncmd++;
  }
  *out_cmds = cmds;
  *out_ncmd = ncmd;
  return 0;
}

/* Greedy/lazy seed pass over [lo, hi): Cmds for the cost model (LZ
   only; matches clamp at hi). Inserts into cfg's hash state, which
   persists across metablocks for window continuity. */
static int opt_seed_pass(const uint8_t* data, size_t n, size_t lo,
                         size_t hi, size_t maxback, MatchCfg* cfg,
                         uint32_t* sim_ring, Cmd** out, size_t* oncmd) {
  size_t cap = (hi - lo) / 4 + 16;
  Cmd* cmds = (Cmd*)malloc(sizeof(Cmd) * cap);
  if (!cmds) return EERR_ALLOC;
  size_t ncmd = 0;
  size_t pos = lo, lit_start = lo, miss_run = 0;
  while (pos < hi) {
    MatchResult mr;
    find_match(data, pos, n, maxback, sim_ring, cfg, &mr);
    if (mr.len > hi - pos) mr.len = hi - pos;
    if (mr.len >= 4) {
      int pos_inserted = 0;
      if (cfg->lazy && mr.len < 160) {
        int defer = 0;
        while (defer < 4 && pos + 1 < hi) {
          MatchResult m2;
          insert_hash(data, pos, cfg);
          pos_inserted = 1;
          find_match(data, pos + 1, n, maxback, sim_ring, cfg, &m2);
          if (m2.len > hi - (pos + 1)) m2.len = hi - (pos + 1);
          if (m2.len >= 4 && m2.score > mr.score + 130) {
            pos += 1;
            mr = m2;
            pos_inserted = 0;
            defer++;
          } else {
            break;
          }
        }
      }
      if (mr.len < 4) { /* lazy clamp shrank it */
        insert_hash(data, pos, cfg);
        pos++;
        continue;
      }
      cmds[ncmd].ins = (uint32_t)(pos - lit_start);
      cmds[ncmd].cpy = (uint32_t)mr.len;
      cmds[ncmd].dist = (uint32_t)mr.dist;
      cmds[ncmd].adv = (uint32_t)mr.len;
      ncmd++;
      if (ncmd + 2 > cap) {
        cap *= 2;
        Cmd* nc = (Cmd*)realloc(cmds, sizeof(Cmd) * cap);
        if (!nc) {
          free(cmds);
          return EERR_ALLOC;
        }
        cmds = nc;
      }
      if (mr.dist != sim_ring[0]) {
        sim_ring[3] = sim_ring[2];
        sim_ring[2] = sim_ring[1];
        sim_ring[1] = sim_ring[0];
        sim_ring[0] = (uint32_t)mr.dist;
      }
      size_t end = pos + mr.len;
      size_t step = mr.len > 256 ? 4 : 1;
      if (!pos_inserted) insert_hash(data, pos, cfg);
      for (size_t p2 = pos + 1; p2 < end; p2 += step)
        insert_hash_ex(data, p2, cfg, 0);
      pos = end;
      lit_start = pos;
      miss_run = 0;
    } else {
      insert_hash(data, pos, cfg);
      miss_run++;
      size_t step = miss_run > 512 ? 4 : miss_run > 128 ? 2 : 1;
      pos += step;
      if (pos > hi) pos = hi;
    }
  }
  if (lit_start < hi || ncmd == 0) {
    cmds[ncmd].ins = (uint32_t)(hi - lit_start);
    cmds[ncmd].cpy = 0;
    cmds[ncmd].dist = 0;
    cmds[ncmd].adv = 0;
    ncmd++;
  }
  *out = cmds;
  *oncmd = ncmd;
  return 0;
}

/* Shared q10/11 driver: seed -> cost model -> DP per ~4MB metablock.
   With `mo` set, serializes metablocks (the all-native tier); with
   `po` set, appends the parse as (pos, len, dist, flag) match arrays
   (flag = 2000 + word length for static-dict edges) for the Python
   emitter -- the full serializer (block splits, context maps,
   NPOSTFIX search) squeezes several % more than the native one. */
typedef struct {
  uint32_t *pos, *len, *dist, *flag;
  size_t cap, cnt;
} OptParseOut;

static int btpu_encode_opt_impl(const uint8_t* raw, size_t n,
                                int quality, int lgwin, int ctx_force,
                                const uint8_t* dict_blob,
                                uint8_t** out, size_t* out_len,
                                OptParseOut* po) {
  uint8_t* data = (uint8_t*)malloc(n + 16);
  if (!data) return EERR_ALLOC;
  memcpy(data, raw, n);
  memset(data + n, 0, 16);
  Enc e;
  memset(&e, 0, sizeof(e));
  e.data = data;
  e.n = n;
  e.quality = quality;
  e.lgwin = lgwin;
  e.ctx_mode = ctx_force;
  e.dist_alpha = lgwin > 24 ? NUM_DIST_LW : NUM_DIST;
  e.maxback = ((size_t)1 << lgwin) - 16;
  for (int i = 0; i < 4; i++) e.ring[i] = kInitialRing[3 - i];
  e.pm.w = (uint64_t*)malloc(sizeof(uint64_t) * 16 * 2 * 1200);
  e.pm.leaf = (uint8_t*)malloc(16 * 2 * 1200);
  MatchCfg cfg_seed, cfg_dp, cfg_dp2;
  cfg_for_quality(&cfg_seed, 7);
  cfg_seed.use_dict = 0;
  memset(&cfg_dp, 0, sizeof(cfg_dp));
  cfg_dp.hbits = 16;
  /* q11: 2048-entry rings (block_bits 11). The reference's H10
     binary tree remembers window-wide sources; 128-entry rings forgot
     far occurrences of common 4-grams and lost ~1,300 long matches at
     median distance ~150 KB on plrabn12 alone (round-3 sweep:
     Canterbury-4+maps 529,345 -> 527,314, +0.8 s on 1.6 MB). RSS
     stays modest: calloc maps lazily, so pages materialize only for
     touched ring slots (~bytes inserted). q10 keeps the fast
     64-entry config (reference-q10 size parity at higher speed). */
  cfg_dp.block_bits = quality >= 11 ? 11 : 6;
  cfg_dp.depth = quality >= 11 ? 2048 : 64;
  cfg_dp.lazy = 0;
  cfg_dp.min_len = 4;
  cfg_dp.use_dict = 1;
  cfg_dp.h4 = 1;  /* 4-byte hash: the DP must see len-4 matches */
  if (getenv("BTPU_OPT_NO_DICT")) cfg_dp.use_dict = 0;
  {
    const char* v = getenv("BTPU_OPT_DEPTH");
    if (v) cfg_dp.depth = atoi(v);
    v = getenv("BTPU_OPT_HBITS");
    if (v) cfg_dp.hbits = atoi(v);
    v = getenv("BTPU_OPT_BLOCK_BITS");
    if (v) cfg_dp.block_bits = atoi(v);
  }
  if (dict_blob) {
    if (dict_index_init(dict_blob)) cfg_dp.use_dict = 0;
  } else if (!g_dict.ready) {
    cfg_dp.use_dict = 0;
  }
  cfg_dp2 = cfg_dp;
  cfg_dp2.depth = 256; /* recost iteration: the costs drive the gain,
                          but a 256-entry walk still recovers matches
                          the new costs re-rank (swept 32/256/2048:
                          256 is -206 B on Canterbury-4+maps, +8%
                          time) */
  {
    const char* v = getenv("BTPU_OPT_DEPTH2");
    if (v) cfg_dp2.depth = atoi(v);
  }
  /* the DP walks candidates itself; the long-range table rides the
     seed cfg (its matches reach the DP as continuation edges) AND
     the DP cfg (probed per relax position) */
  /* 15-bit LR table for the DP too: the 18-bit table's probe was
     ~15%% of opt_parse_block (line profile; LLC misses), and the q9
     seed's own long-range table already feeds the DP the multi-MB
     repeats as continuation edges */
  cfg_dp.lr_bits = 15;
  cfg_dp2.lr_bits = quality >= 11 ? 15 : 0;
  /* binary-tree candidate source (bt_walk): when it allocates, the
     DP's deep rings shrink to a vestigial fallback footprint */
  BTree bt_dp, bt_dp2;
  memset(&bt_dp, 0, sizeof(bt_dp));
  memset(&bt_dp2, 0, sizeof(bt_dp2));
  if (!getenv("BTPU_OPT_NO_BT")) {
    if (bt_alloc(&bt_dp, n, e.maxback) == 0) {
      cfg_dp.bt = &bt_dp;
      cfg_dp.block_bits = 0;
      if (quality >= 11 && bt_alloc(&bt_dp2, n, e.maxback) == 0) {
        cfg_dp2.bt = &bt_dp2;
        cfg_dp2.block_bits = 0;
      }
    }
  }
  int alloc_rc = cfg_alloc_tables(&cfg_seed, n) ||
                 cfg_alloc_tables(&cfg_dp, n);
  if (quality >= 11) alloc_rc = alloc_rc || cfg_alloc_tables(&cfg_dp2, n);
  size_t mb_target = (size_t)1 << 22;
  size_t mb_max = n < mb_target ? n : mb_target;
  float* dp = (float*)malloc(sizeof(float) * (mb_max + 1));
  uint32_t* blen = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
  uint32_t* bcpy = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
  uint32_t* bdist = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
  uint32_t* lastm = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
  OptCost oc;
  memset(&oc, 0, sizeof(oc));
  oc.dalpha = e.dist_alpha;
  oc.ctx_mode_force = ctx_force;
  oc.litc = (float*)malloc(sizeof(float) * mb_max);
  uint32_t sim_ring[4];
  for (int i = 0; i < 4; i++) sim_ring[i] = kInitialRing[3 - i];
  int rc = 0;
  if (!e.pm.w || !e.pm.leaf || alloc_rc || !dp || !blen || !bcpy ||
      !bdist || !lastm || !oc.litc) {
    rc = EERR_ALLOC;
    goto done;
  }
  put_stream_header(&e.bw, lgwin);
  for (size_t lo = 0; lo < n && rc == 0; lo += mb_target) {
    size_t hi = lo + mb_target < n ? lo + mb_target : n;
    Cmd* seed = NULL;
    size_t nseed = 0;
    rc = opt_seed_pass(data, n, lo, hi, e.maxback, &cfg_seed, sim_ring,
                       &seed, &nseed);
    if (rc) break;
    if (nseed > e.plan_cap) {
      free(e.plan);
      e.plan_cap = nseed + 64;
      e.plan = (Plan*)malloc(sizeof(Plan) * e.plan_cap);
      if (!e.plan) {
        free(seed);
        rc = EERR_ALLOC;
        break;
      }
    }
    opt_costs_from_seed(data, lo, hi, seed, nseed, e.ring, e.plan, &oc);
    Cmd* cmds = NULL;
    size_t ncmd = 0;
    rc = opt_parse_block(data, n, lo, hi, e.maxback, &cfg_dp, seed,
                         nseed, e.ring, &oc, dp, blen, bcpy, bdist,
                         lastm, &cmds, &ncmd);
    free(seed);
    if (rc) break;
    int n_iters = 2;
    {
      const char* v = getenv("BTPU_OPT_ITERS");
      if (v) n_iters = atoi(v);
      if (getenv("BTPU_OPT_ONE_ITER")) n_iters = 1;
      if (n_iters > 8) n_iters = 8;
    }
    for (int it = 1; it < n_iters && quality >= 11; it++) {
      /* recost iterations from the DP's own parse (the reference
         zopfli's ZopfliIterate passes). Each iteration gets FRESH
         hash state: reusing cfg_dp2's rings across walks re-inserts
         every position, halving effective depth and (round-3) was
         misattributed as parse corruption. */
      if (it >= 2) {
        memset(cfg_dp2.bucket, 0,
               ((size_t)4 << (cfg_dp2.hbits + cfg_dp2.block_bits)));
        memset(cfg_dp2.num, 0, (size_t)4 << cfg_dp2.hbits);
      }
      if (ncmd > e.plan_cap) {
        free(e.plan);
        e.plan_cap = ncmd + 64;
        e.plan = (Plan*)malloc(sizeof(Plan) * e.plan_cap);
        if (!e.plan) {
          free(cmds);
          cmds = NULL;
          rc = EERR_ALLOC;
          break;
        }
      }
      opt_costs_from_seed(data, lo, hi, cmds, ncmd, e.ring, e.plan,
                          &oc);
      Cmd* cmds2 = NULL;
      size_t ncmd2 = 0;
      rc = opt_parse_block(data, n, lo, hi, e.maxback, &cfg_dp2, cmds,
                           ncmd, e.ring, &oc, dp, blen, bcpy, bdist,
                           lastm, &cmds2, &ncmd2);
      if (rc) {
        free(cmds);
        cmds = NULL;
        break;
      }
      free(cmds);
      cmds = cmds2;
      ncmd = ncmd2;
    }
    if (rc) break;
    if (po) {
      /* collect matches; advance the emission ring exactly as the
         serializer would (plan_cmds mutates the ring in place) */
      size_t pos = lo;
      for (size_t t = 0; t < ncmd; t++) {
        const Cmd* c = &cmds[t];
        pos += c->ins;
        if (c->cpy || c->dist) {
          if (po->cnt >= po->cap) {
            free(cmds);
            rc = EERR_PARAM;
            break;
          }
          int isd = (c->adv & CMD_DICT) != 0;
          po->pos[po->cnt] = (uint32_t)pos;
          po->len[po->cnt] = c->adv & ~CMD_DICT;
          po->dist[po->cnt] = c->dist;
          po->flag[po->cnt] = isd ? 2000u + c->cpy : 0u;
          po->cnt++;
        }
        pos += c->adv & ~CMD_DICT;
      }
      if (rc) break;
      if (ncmd > e.plan_cap) {
        free(e.plan);
        e.plan_cap = ncmd + 64;
        e.plan = (Plan*)malloc(sizeof(Plan) * e.plan_cap);
        if (!e.plan) {
          free(cmds);
          rc = EERR_ALLOC;
          break;
        }
      }
      plan_cmds(cmds, ncmd, e.ring, e.plan);
      free(cmds);
      continue;
    }
    rc = emit_metablock(&e, cmds, ncmd, lo, hi, hi >= n);
    free(cmds);
  }
  if (po) goto done;
  if (rc == 0) rc = bw_flush_align(&e.bw);
  /* whole-stream fallback: never exceed raw + framing */
  if (rc == 0 && e.bw.len >= n + 4) {
    BW fb;
    memset(&fb, 0, sizeof(fb));
    put_stream_header(&fb, lgwin);
    size_t p2 = 0;
    while (p2 < n && rc == 0) {
      size_t ch = n - p2;
      if (ch > ((size_t)1 << 24) - 16) ch = ((size_t)1 << 24) - 16;
      put_mlen_header(&fb, ch, 0, 1);
      rc = bw_flush_align(&fb);
      if (rc == 0) {
        rc = bw_reserve(&fb, ch);
        if (rc == 0) {
          memcpy(fb.buf + fb.len, data + p2, ch);
          fb.len += ch;
        }
      }
      p2 += ch;
    }
    bw_put(&fb, 1, 1);
    bw_put(&fb, 1, 1);
    if (rc == 0) rc = bw_flush_align(&fb);
    if (rc == 0 && fb.len < e.bw.len) {
      free(e.bw.buf);
      e.bw = fb;
    } else {
      free(fb.buf);
    }
  }
done:
  cfg_free_tables(&cfg_seed);
  cfg_free_tables(&cfg_dp);
  cfg_free_tables(&cfg_dp2);
  bt_free(&bt_dp);
  bt_free(&bt_dp2);
  free(dp);
  free(blen);
  free(bcpy);
  free(bdist);
  free(lastm);
  free(oc.litc);
  free(e.plan);
  free(e.pm.w);
  free(e.pm.leaf);
  free(data);
  if (rc || po) {
    free(e.bw.buf);
    return rc;
  }
  *out = e.bw.buf;
  *out_len = e.bw.len;
  return 0;
}

static int btpu_encode_opt(const uint8_t* raw, size_t n, int quality,
                           int lgwin, int ctx_force,
                           const uint8_t* dict_blob, uint8_t** out,
                           size_t* out_len) {
  return btpu_encode_opt_impl(raw, n, quality, lgwin, ctx_force,
                              dict_blob, out, out_len, NULL);
}

/* ctypes export: the q10/11 optimal PARSE alone, for the Python
   serializer (see btpu_encode_opt_impl). out arrays need n/4 + 16
   entries. */
int btpu_opt_parse(const uint8_t* raw, size_t n, int quality, int lgwin,
                   const uint8_t* dict_blob, uint32_t* out_pos,
                   uint32_t* out_len_a, uint32_t* out_dist,
                   uint32_t* out_flag, size_t cap, size_t* out_cnt) {
  if (quality < 10 || quality > 11 || lgwin < 10 || lgwin > 30 ||
      n == 0)
    return EERR_PARAM;
  if (n > ((size_t)1 << 32) - 32) return EERR_PARAM;
  OptParseOut po;
  po.pos = out_pos;
  po.len = out_len_a;
  po.dist = out_dist;
  po.flag = out_flag;
  po.cap = cap;
  po.cnt = 0;
  int rc = btpu_encode_opt_impl(raw, n, quality, lgwin, -1, dict_blob,
                                NULL, NULL, &po);
  if (rc) return rc;
  *out_cnt = po.cnt;
  return 0;
}

/* Serialize a parsed region [lo, hi) of `data_full` from match arrays
   (the host stage of the device / sharded pipelines; role parity:
   BrotliStoreMetaBlock driven by an external backward-reference pass).
   Matches must be sorted and non-overlapping. Flag semantics follow
   enc/bitstream.plan_commands: 0 = LZ copy, 2..999 = builtin omit-last
   cutoff (copy code = len + flag - 2), >= 2000 = builtin static-dict
   word (copy code = flag - 2000). Compound (1) and custom shared-dict
   (1000..1999) flags are unsupported here -> EERR_PARAM (callers fall
   back to the Python serializer). Matches straddling the internal 4MB
   metablock grid split (LZ, pieces >= 2 survive) or drop (dict).
   ring_in: entry distance ring, newest first (NULL = stream start);
   write_header / is_last / align_end control shard stitching;
   ring_out (optional) receives the exit ring. */
int btpu_serialize(const uint8_t* data_full, size_t n, size_t lo,
                   size_t hi, int quality, int lgwin,
                   const uint32_t* mpos, const uint32_t* mlen,
                   const uint32_t* mdist, const uint32_t* mflag,
                   size_t nmatch, const uint32_t* ring_in,
                   int write_header, int is_last, int align_end,
                   uint8_t** out, size_t* out_len, uint32_t* ring_out) {
  if (lo >= hi || hi > n || lgwin < 10 || lgwin > 30 || quality < 0 ||
      quality > 11)
    return EERR_PARAM;
  Enc e;
  memset(&e, 0, sizeof(e));
  e.data = data_full;
  e.n = n;
  e.quality = quality;
  e.lgwin = lgwin;
  e.ctx_mode = -1;
  e.dist_alpha = lgwin > 24 ? NUM_DIST_LW : NUM_DIST;
  e.maxback = ((size_t)1 << lgwin) - 16;
  for (int i = 0; i < 4; i++)
    e.ring[i] = ring_in ? ring_in[i] : kInitialRing[3 - i];
  e.pm.w = (uint64_t*)malloc(sizeof(uint64_t) * 16 * 2 * 1200);
  e.pm.leaf = (uint8_t*)malloc(16 * 2 * 1200);
  size_t cmd_cap = 1 << 14;
  Cmd* cmds = (Cmd*)malloc(sizeof(Cmd) * cmd_cap);
  int rc = 0;
  if (!e.pm.w || !e.pm.leaf || !cmds) {
    rc = EERR_ALLOC;
    goto done;
  }
  if (write_header) put_stream_header(&e.bw, lgwin);
  {
    size_t mb_target = (size_t)1 << 22;
    size_t mi = 0;
    uint32_t carry_len = 0, carry_dist = 0; /* split tail piece */
    size_t blo = lo;
    while (blo < hi) {
      size_t bhi = blo + mb_target < hi ? blo + mb_target : hi;
      size_t ncmd = 0;
      size_t prev_end = blo;
#define SER_PUSH(ins_, cpy_, dist_, adv_)                              \
      do {                                                             \
        if (ncmd == cmd_cap) {                                         \
          cmd_cap *= 2;                                                \
          Cmd* nc_ = (Cmd*)realloc(cmds, sizeof(Cmd) * cmd_cap);       \
          if (!nc_) {                                                  \
            rc = EERR_ALLOC;                                           \
            goto done;                                                 \
          }                                                            \
          cmds = nc_;                                                  \
        }                                                              \
        cmds[ncmd].ins = (uint32_t)(ins_);                             \
        cmds[ncmd].cpy = (uint32_t)(cpy_);                             \
        cmds[ncmd].dist = (uint32_t)(dist_);                           \
        cmds[ncmd].adv = (uint32_t)(adv_);                             \
        ncmd++;                                                        \
      } while (0)
      if (carry_len) { /* right piece of a boundary-split LZ match;
                          pieces longer than the metablock re-split */
        uint32_t take = carry_len;
        if ((size_t)take > bhi - blo) take = (uint32_t)(bhi - blo);
        SER_PUSH(0, take, carry_dist, take);
        prev_end = blo + take;
        carry_len -= take;
        if (carry_len && carry_len < 2) carry_len = 0; /* tail < 2 */
      }
      while (mi < nmatch) {
        size_t mp = mpos[mi];
        if (mp < prev_end) {
          mi++;
          continue;
        }
        if (mp >= bhi) break;
        uint32_t L = mlen[mi];
        uint32_t D = mdist[mi];
        uint32_t F = mflag[mi];
        if (F == 1 || (F >= 1000 && F < 2000)) {
          rc = EERR_PARAM;
          goto done;
        }
        size_t mend = mp + L;
        if (mend > hi) { /* clamp at the region end */
          if (F != 0 || hi - mp < 2) {
            mi++;
            continue;
          }
          L = (uint32_t)(hi - mp);
          mend = hi;
        }
        if (mend > bhi) { /* straddles the metablock grid */
          mi++;
          if (F != 0) continue; /* dict refs are atomic: drop */
          uint32_t left = (uint32_t)(bhi - mp);
          if (left >= 2) {
            SER_PUSH(mp - prev_end, left, D, left);
            prev_end = bhi;
          }
          if (mend - bhi >= 2) {
            carry_len = (uint32_t)(mend - bhi);
            carry_dist = D;
          }
          break;
        }
        if (F == 0) {
          SER_PUSH(mp - prev_end, L, D, L);
        } else if (F >= 2000) {
          SER_PUSH(mp - prev_end, F - 2000, D, L | CMD_DICT);
        } else { /* 2..999: omit-last cutoff */
          SER_PUSH(mp - prev_end, L + (F - 2), D, L | CMD_DICT);
        }
        prev_end = mend;
        mi++;
      }
      if (bhi > prev_end || ncmd == 0)
        SER_PUSH(bhi - prev_end, 0, 0, 0);
#undef SER_PUSH
      int last = is_last && bhi == hi;
      rc = emit_metablock(&e, cmds, ncmd, blo, bhi, last);
      if (rc) goto done;
      blo = bhi;
    }
  }
  if (align_end && !is_last) {
    /* empty metadata block: byte-aligned stitch point */
    bw_put(&e.bw, 0, 1);
    bw_put(&e.bw, 3, 2);
    bw_put(&e.bw, 0, 1);
    bw_put(&e.bw, 0, 2);
  }
  if (bw_flush_align(&e.bw)) { /* output is whole bytes */
    rc = EERR_ALLOC;
    goto done;
  }
  if (ring_out)
    for (int i = 0; i < 4; i++) ring_out[i] = e.ring[i];
done:
  free(cmds);
  free(e.plan);
  free(e.pm.w);
  free(e.pm.leaf);
  if (rc) {
    free(e.bw.buf);
    return rc;
  }
  *out = e.bw.buf;
  *out_len = e.bw.len;
  return 0;
}

int btpu_encode2(const uint8_t* raw, size_t n, int quality, int lgwin,
                 int mode, const uint8_t* dict_blob, uint8_t** out,
                 size_t* out_len) {
  if (quality < 0 || quality > 11 || lgwin < 10 || lgwin > 30 || n == 0)
    return EERR_PARAM;
  if (n > ((size_t)1 << 32) - 32) return EERR_PARAM;
  /* BrotliEncoderMode hint: TEXT forces the UTF8 context model, FONT
     the signed-byte model (ChooseContextMode role) */
  int ctx_force = mode == 1 ? 2 : mode == 2 ? 3 : -1;
  if (quality >= 10)
    return btpu_encode_opt(raw, n, quality, lgwin, ctx_force, dict_blob,
                           out, out_len);
  /* padded input copy: match finding may read up to 8 bytes past the
     end (zero padding keeps the reads in-bounds and harmless) */
  uint8_t* data = (uint8_t*)malloc(n + 16);
  if (!data) return EERR_ALLOC;
  memcpy(data, raw, n);
  memset(data + n, 0, 16);

  Enc e;
  memset(&e, 0, sizeof(e));
  e.data = data;
  e.n = n;
  e.quality = quality;
  e.lgwin = lgwin;
  e.ctx_mode = ctx_force;
  e.dist_alpha = lgwin > 24 ? NUM_DIST_LW : NUM_DIST;
  e.maxback = ((size_t)1 << lgwin) - 16;
  for (int i = 0; i < 4; i++) e.ring[i] = kInitialRing[3 - i];
  e.pm.w = (uint64_t*)malloc(sizeof(uint64_t) * 16 * 2 * 1200);
  e.pm.leaf = (uint8_t*)malloc(16 * 2 * 1200);
  MatchCfg cfg;
  cfg_for_quality(&cfg, quality);
  if (cfg.use_dict && dict_blob) {
    if (dict_index_init(dict_blob)) cfg.use_dict = 0;
  } else if (cfg.use_dict && !g_dict.ready) {
    cfg.use_dict = 0;
  }
  int cfg_rc = cfg_alloc_tables(&cfg, n);
  size_t cmd_cap = 1 << 16;
  Cmd* cmds = (Cmd*)malloc(sizeof(Cmd) * cmd_cap);
  int rc = 0;
  if (cfg_rc || !cmds || !e.pm.w || !e.pm.leaf) {
    rc = EERR_ALLOC;
    goto done;
  }

  put_stream_header(&e.bw, lgwin);

  {
    /* 128 KB metablocks at the greedy tiers (reference lgblock role,
       quality.h:76-92 picks 64-256 KB): one 4 MB metablock over
       heterogeneous input cost +16 KB vs per-type-adaptive trees on
       the 16 MB corpus (swept 64K-4M; 128K best, and per-file
       Canterbury is neutral-to-better too) */
    size_t mb_target = (size_t)1 << 17;
    {
      const char* v = getenv("BTPU_MB_TARGET");
      if (v && atoi(v) >= 16) mb_target = (size_t)atoi(v);
    }
    size_t pos = 0;       /* next input byte to consume */
    size_t mb_lo = 0;     /* metablock start */
    size_t lit_start = 0; /* first unconsumed literal */
    size_t ncmd = 0;
    size_t copy_bytes = 0; /* bytes covered by copies in this block */
    size_t miss_run = 0;   /* consecutive positions without a match */

    uint32_t sim_ring[4]; /* matcher's view of the distance cache */
    memcpy(sim_ring, e.ring, sizeof(sim_ring));

#define FLUSH_BLOCK(hi_, last_)                                         \
  do {                                                                  \
    if (looks_incompressible(data, mb_lo, (hi_), copy_bytes)) {         \
      size_t p_ = mb_lo;                                                \
      while (p_ < (hi_)) {                                              \
        size_t ch_ = (hi_) - p_;                                        \
        if (ch_ > ((size_t)1 << 24) - 16) ch_ = ((size_t)1 << 24) - 16; \
        rc = emit_uncompressed(&e, p_, p_ + ch_);                       \
        if (rc) goto done;                                              \
        p_ += ch_;                                                      \
      }                                                                 \
      if (last_) {                                                      \
        bw_put(&e.bw, 1, 1); /* ISLAST */                               \
        bw_put(&e.bw, 1, 1); /* ISLASTEMPTY */                          \
      }                                                                  \
      /* uncompressed blocks leave the decoder ring untouched */        \
      memcpy(sim_ring, e.ring, sizeof(sim_ring));                       \
    } else {                                                            \
      rc = emit_metablock(&e, cmds, ncmd, mb_lo, (hi_), (last_));       \
      if (rc) goto done;                                                \
      memcpy(sim_ring, e.ring, sizeof(sim_ring));                       \
    }                                                                   \
    ncmd = 0;                                                           \
    copy_bytes = 0;                                                     \
    mb_lo = (hi_);                                                      \
  } while (0)

#define PUSH_CMD(ins_, cpy_, dist_, adv_)                   \
  do {                                                      \
    if (ncmd == cmd_cap) {                                  \
      cmd_cap *= 2;                                         \
      Cmd* nc_ = (Cmd*)realloc(cmds, sizeof(Cmd) * cmd_cap); \
      if (!nc_) {                                           \
        rc = EERR_ALLOC;                                    \
        goto done;                                          \
      }                                                     \
      cmds = nc_;                                           \
    }                                                       \
    cmds[ncmd].ins = (uint32_t)(ins_);                      \
    cmds[ncmd].cpy = (uint32_t)(cpy_);                      \
    cmds[ncmd].dist = (uint32_t)(dist_);                    \
    cmds[ncmd].adv = (uint32_t)(adv_);                      \
    ncmd++;                                                 \
  } while (0)

    /* affix richness by tier: suffix forms are near-free (checked
       only on full-word matches); the prefix pass costs a probe per
       miss position and is reserved for the slower tiers */
    int dict_level = quality >= 7 ? 2 : 1;
    while (pos < n) {
      MatchResult m;
      find_match(data, pos, n, e.maxback, sim_ring, &cfg, &m);
      int dcopy = 0, dtid = 0, dwlen = 0;
      uint32_t didx = 0;
      int dout = 0;
      if (cfg.use_dict && m.len < 12) {
        int min_out = m.len >= 4 ? (int)m.len + 1 : 4;
        dout = dict_probe(data, pos, n, min_out, dict_level, &dcopy,
                          &dtid, &didx,
                          &dwlen);
      }
      if (dout > (int)m.len) {
        /* dictionary reference (never pushes the distance ring) */
        size_t maxd = pos < e.maxback ? pos : e.maxback;
        uint32_t dist =
            (uint32_t)(maxd + 1 +
                       ((uint32_t)dtid << kDictSizeBits[dwlen]) + didx);
        PUSH_CMD(pos - lit_start, dcopy, dist, (uint32_t)dout | CMD_DICT);
        copy_bytes += (size_t)dout;
        size_t end = pos + (size_t)dout;
        for (size_t p2 = pos; p2 < end; p2++) insert_hash(data, p2, &cfg);
        pos = end;
        lit_start = pos;
        miss_run = 0;
      } else if (m.len >= 4) {
        int pos_inserted = 0;
        if (cfg.lazy && m.len < 160) {
          int defer = 0;
          while (defer < 4 && pos + 1 < n) {
            MatchResult m2;
            insert_hash(data, pos, &cfg);
            pos_inserted = 1;
            find_match(data, pos + 1, n, e.maxback, sim_ring, &cfg, &m2);
            if (m2.score > m.score + 130) {
              pos += 1;
              m = m2;
              pos_inserted = 0;
              defer++;
            } else {
              break;
            }
          }
        }
        PUSH_CMD(pos - lit_start, m.len, m.dist, m.len);
        copy_bytes += m.len;
        if (m.dist != sim_ring[0]) {
          sim_ring[3] = sim_ring[2];
          sim_ring[2] = sim_ring[1];
          sim_ring[1] = sim_ring[0];
          sim_ring[0] = (uint32_t)m.dist;
        }
        /* insert hashes across the match (sparser for long matches) */
        size_t end = pos + m.len;
        size_t step = m.len > 256 ? 4 : 1;
        if (!pos_inserted) insert_hash(data, pos, &cfg);
        for (size_t p2 = pos + 1; p2 < end; p2 += step)
          insert_hash_ex(data, p2, &cfg, 0);
        pos = end;
        lit_start = pos;
        miss_run = 0;
      } else {
        insert_hash(data, pos, &cfg);
        miss_run++;
        /* sparse probing over incompressible spans */
        size_t step = 1;
        if (miss_run > 512)
          step = 4;
        else if (miss_run > 128)
          step = 2;
        pos += step;
        if (pos > n) pos = n;
      }
      /* close the metablock at a command boundary */
      if (pos - mb_lo >= mb_target && pos < n) {
        size_t hi;
        if (lit_start > mb_lo) {
          hi = lit_start; /* pending literals roll into the next block */
        } else {
          /* all-literal block: close with an insert-only command */
          PUSH_CMD(pos - lit_start, 0, 0, 0);
          lit_start = pos;
          hi = pos;
        }
        FLUSH_BLOCK(hi, 0);
      }
    }
    /* final block: trailing literals as a final insert-only command */
    if (lit_start < n) PUSH_CMD(n - lit_start, 0, 0, 0);
    FLUSH_BLOCK(n, 1);
    rc = bw_flush_align(&e.bw);

    /* whole-stream fallback: never exceed raw size by more than the
       uncompressed-stream framing */
    if (rc == 0 && e.bw.len >= n + 4) {
      BW fb;
      memset(&fb, 0, sizeof(fb));
      put_stream_header(&fb, lgwin);
      size_t p2 = 0;
      while (p2 < n && rc == 0) {
        size_t ch = n - p2;
        if (ch > ((size_t)1 << 24) - 16) ch = ((size_t)1 << 24) - 16;
        put_mlen_header(&fb, ch, 0, 1);
        rc = bw_flush_align(&fb);
        if (rc == 0) {
          rc = bw_reserve(&fb, ch);
          if (rc == 0) {
            memcpy(fb.buf + fb.len, data + p2, ch);
            fb.len += ch;
          }
        }
        p2 += ch;
      }
      bw_put(&fb, 1, 1);
      bw_put(&fb, 1, 1);
      if (rc == 0) rc = bw_flush_align(&fb);
      if (rc == 0 && fb.len < e.bw.len) {
        free(e.bw.buf);
        e.bw = fb;
      } else {
        free(fb.buf);
      }
    }
  }

done:
  cfg_free_tables(&cfg);
  free(cmds);
  free(e.plan);
  free(e.pm.w);
  free(e.pm.leaf);
  free(data);
  if (rc) {
    free(e.bw.buf);
    return rc;
  }
  *out = e.bw.buf;
  *out_len = e.bw.len;
  return 0;
}

int btpu_encode(const uint8_t* raw, size_t n, int quality, int lgwin,
                const uint8_t* dict_blob, uint8_t** out,
                size_t* out_len) {
  return btpu_encode2(raw, n, quality, lgwin, 0, dict_blob, out,
                      out_len);
}

/* ctypes export: the match finder alone -- the device optimal-parse
   pipeline (ops/optimal_jax.py) seeds its DP with a fast greedy/lazy
   parse; running that seed here instead of on the accelerator frees
   the chip for the DP itself (role: the ZopfliIterate seed parse,
   reference backward_references_hq.c). No dictionary probing: seeds
   only guide the DP, and the DP's own post-pass handles words.
   out_* arrays must hold at least n/4 + 16 entries (a match advances
   >= 4 bytes, literal runs emit nothing). */
int btpu_find_matches(const uint8_t* raw, size_t n, int quality,
                      int lgwin, uint32_t* out_pos, uint32_t* out_len,
                      uint32_t* out_dist, size_t cap, size_t* out_cnt) {
  if (quality < 0 || quality > 9 || lgwin < 10 || lgwin > 24 || n == 0)
    return EERR_PARAM;
  if (n > ((size_t)1 << 32) - 32) return EERR_PARAM;
  uint8_t* data = (uint8_t*)malloc(n + 16);
  if (!data) return EERR_ALLOC;
  memcpy(data, raw, n);
  memset(data + n, 0, 16);
  MatchCfg cfg;
  cfg_for_quality(&cfg, quality);
  cfg.use_dict = 0;
  if (cfg_alloc_tables(&cfg, n)) {
    cfg_free_tables(&cfg);
    free(data);
    return EERR_ALLOC;
  }
  size_t maxback = ((size_t)1 << lgwin) - 16;
  uint32_t sim_ring[4];
  for (int i = 0; i < 4; i++) sim_ring[i] = kInitialRing[3 - i];
  size_t pos = 0, cnt = 0, miss_run = 0;
  int rc = 0;
  while (pos < n) {
    MatchResult m;
    find_match(data, pos, n, maxback, sim_ring, &cfg, &m);
    if (m.len >= 4) {
      int pos_inserted = 0;
      if (cfg.lazy && m.len < 160) {
        int defer = 0;
        while (defer < 4 && pos + 1 < n) {
          MatchResult m2;
          insert_hash(data, pos, &cfg);
          pos_inserted = 1;
          find_match(data, pos + 1, n, maxback, sim_ring, &cfg, &m2);
          if (m2.score > m.score + 130) {
            pos += 1;
            m = m2;
            pos_inserted = 0;
            defer++;
          } else {
            break;
          }
        }
      }
      if (cnt >= cap) {
        rc = EERR_PARAM;
        break;
      }
      out_pos[cnt] = (uint32_t)pos;
      out_len[cnt] = (uint32_t)m.len;
      out_dist[cnt] = (uint32_t)m.dist;
      cnt++;
      if (m.dist != sim_ring[0]) {
        sim_ring[3] = sim_ring[2];
        sim_ring[2] = sim_ring[1];
        sim_ring[1] = sim_ring[0];
        sim_ring[0] = (uint32_t)m.dist;
      }
      size_t end = pos + m.len;
      size_t step = m.len > 256 ? 4 : 1;
      if (!pos_inserted) insert_hash(data, pos, &cfg);
      for (size_t p2 = pos + 1; p2 < end; p2 += step)
        insert_hash_ex(data, p2, &cfg, 0);
      pos = end;
      miss_run = 0;
    } else {
      insert_hash(data, pos, &cfg);
      miss_run++;
      size_t step = 1;
      if (miss_run > 512)
        step = 4;
      else if (miss_run > 128)
        step = 2;
      pos += step;
      if (pos > n) pos = n;
    }
  }
  cfg_free_tables(&cfg);
  free(data);
  if (rc) return rc;
  *out_cnt = cnt;
  return 0;
}

/* ctypes export: optimal depth-limited code lengths for the Python
   serialization path (same package-merge engine the native encoder
   uses; brotli_tpu/enc/entropy.py calls this when the lib is built). */
int btpu_pm_lengths(const uint32_t* freq, int n, int maxlen,
                    uint8_t* out) {
  if (n <= 0 || n > 1200 || maxlen <= 0 || maxlen > 15) return -20;
  PmScratch s;
  memset(&s, 0, sizeof(s));
  s.w = (uint64_t*)malloc(sizeof(uint64_t) * 16 * 2 * (size_t)n);
  s.leaf = (uint8_t*)malloc((size_t)16 * 2 * (size_t)n);
  if (!s.w || !s.leaf) {
    free(s.w);
    free(s.leaf);
    return -3;
  }
  pm_lengths(freq, n, maxlen, out, &s);
  free(s.w);
  free(s.leaf);
  return 0;
}

/* ---------- streaming encoder ----------
 *
 * Role parity: BrotliEncoderCompressStream PROCESS/FLUSH/FINISH
 * (c/enc/encode.c:1634). Persistent hash-chain state carries across
 * chunks (no re-finding over history); the input window slides in a
 * buffer trimmed to ~2x the LZ window. Each FLUSH closes the pending
 * metablock and byte-aligns with an empty metadata block, so every
 * flushed prefix is independently decodable.
 */

typedef struct {
  Enc e;
  MatchCfg cfg;
  uint8_t* buf;
  size_t cap;
  size_t len;    /* bytes buffered; absolute stream length = base+len */
  size_t base;   /* absolute position of buf[0] */
  size_t pos;    /* absolute next-unconsumed position */
  size_t lit_start;
  size_t mb_lo;
  size_t copy_bytes;
  size_t miss_run;
  uint32_t sim_ring[4];
  Cmd* cmds;
  size_t ncmd, cmd_cap;
  int started, finished;
  /* q10/11 opt-tier streaming (NULL below q10): persistent DP hash
     states + scratch so every flush runs seed -> cost model -> DP
     only over the NEW bytes (O(chunk) flushes at the default
     quality; parity contract: encode.h:100-116) */
  MatchCfg cfg_dp, cfg_dp2;
  BTree bt_dp, bt_dp2; /* binary-tree candidate source (bt_walk) */
  float* odp;
  uint32_t *oblen, *obcpy, *obdist, *olastm;
  OptCost oc;
  size_t dict_len; /* raw compound dictionary preloaded as history */
} EncStream;

#define SPAD 16 /* zero slack past the buffered end for 64-bit loads */

/* Remap a concat-space distance (source may lie in the preloaded
   dictionary) into the decoder's compound address space. */
static inline uint32_t stream_map_dist(EncStream* S, size_t pos,
                                       size_t dist) {
  size_t cand = pos - dist;
  if (cand >= S->dict_len) return (uint32_t)dist;
  size_t q = pos - S->dict_len; /* decoder output position */
  size_t maxd = q < S->e.maxback ? q : S->e.maxback;
  return (uint32_t)(maxd + (S->dict_len - cand));
}

/* Bytes of a copy from concat position `cand` that lie in the
   preloaded dictionary, when the copy runs on past its end (0 when it
   does not cross). The decoder refuses a compound reference that runs
   past the dictionary (decode.c InitializeCompoundDictionaryCopy), so
   such a copy is split at the dictionary's end. */
static inline size_t stream_dict_head(const EncStream* S, size_t cand,
                                      size_t len) {
  return cand < S->dict_len && cand + len > S->dict_len
      ? S->dict_len - cand : 0;
}

/* Split every copy that crosses the dictionary's end (concat space,
   before stream_remap_cmds): a head of 2+ bytes stays a compound
   reference and the rest of 2+ bytes follows at the same distance, out
   of the output; a head of 1 byte, or a rest of 1 byte, becomes a
   literal. *cmds may be reallocated. */
static int stream_split_cmds(EncStream* S, Cmd** cmds, size_t* ncmd,
                             size_t lo) {
  if (!S->dict_len) return 0;
  size_t pos = lo, extra = 0;
  for (size_t i = 0; i < *ncmd; i++) {
    Cmd* c = &(*cmds)[i];
    pos += c->ins;
    if (!(c->adv & CMD_DICT) && c->dist && c->dist <= pos &&
        stream_dict_head(S, pos - c->dist, c->adv))
      extra++;
    pos += c->adv & ~CMD_DICT;
  }
  if (!extra) return 0;
  Cmd* out = (Cmd*)malloc(sizeof(Cmd) * (*ncmd + 2 * extra));
  if (!out) return EERR_ALLOC;
  size_t k = 0;
  uint32_t carry = 0; /* a split's last byte, now a literal */
  pos = lo;
  for (size_t i = 0; i < *ncmd; i++) {
    Cmd c = (*cmds)[i];
    pos += c.ins; /* the copy's position as parsed */
    c.ins += carry;
    carry = 0;
    size_t adv = c.adv & ~CMD_DICT;
    size_t head = (!(c.adv & CMD_DICT) && c.dist && c.dist <= pos)
        ? stream_dict_head(S, pos - c.dist, adv) : 0;
    if (!head) {
      out[k++] = c;
    } else if (head == 1) {
      c.ins += 1;
      c.cpy = c.adv = (uint32_t)(adv - 1);
      out[k++] = c;
    } else if (adv - head == 1) {
      c.cpy = c.adv = (uint32_t)head;
      out[k++] = c;
      carry = 1;
    } else {
      Cmd tail = {0, (uint32_t)(adv - head), c.dist,
                  (uint32_t)(adv - head)};
      c.cpy = c.adv = (uint32_t)head;
      out[k++] = c;
      out[k++] = tail;
    }
    pos += adv;
  }
  if (carry) {
    Cmd last = {carry, 0, 0, 0};
    out[k++] = last;
  }
  free(*cmds);
  *cmds = out;
  *ncmd = k;
  return 0;
}

/* Remap every command's distance in a parsed region (opt tier path:
   commands come back from the DP in concat space). */
static void stream_remap_cmds(EncStream* S, Cmd* cmds, size_t ncmd,
                              size_t lo) {
  if (!S->dict_len) return;
  size_t D = S->dict_len;
  size_t pos = lo;
  for (size_t i = 0; i < ncmd; i++) {
    Cmd* c = &cmds[i];
    pos += c->ins;
    if (c->cpy || c->dist) {
      size_t q = pos - D;
      size_t maxd_out = q < S->e.maxback ? q : S->e.maxback;
      if (c->adv & CMD_DICT) {
        /* static-dict edge: its synthetic distance was built from the
           concat-space max; rebase onto the decoder's max AND shift
           past the compound region (decode address space order:
           window, compound, static words) */
        size_t maxd_in = pos < S->e.maxback ? pos : S->e.maxback;
        size_t off = (size_t)c->dist - maxd_in - 1;
        c->dist = (uint32_t)(maxd_out + 1 + D + off);
      } else if ((size_t)c->dist <= pos) {
        size_t cand = pos - c->dist;
        if (cand < D) c->dist = (uint32_t)(maxd_out + (D - cand));
      }
    }
    pos += c->adv & ~CMD_DICT;
  }
}


void* btpu_enc_new(int quality, int lgwin, const uint8_t* dict_blob) {
  if (quality < 0 || quality > 11 || lgwin < 10 || lgwin > 30)
    return NULL;
  EncStream* S = (EncStream*)calloc(1, sizeof(EncStream));
  if (!S) return NULL;
  S->e.quality = quality;
  S->e.lgwin = lgwin;
  S->e.ctx_mode = -1;
  S->e.dist_alpha = lgwin > 24 ? NUM_DIST_LW : NUM_DIST;
  S->e.maxback = ((size_t)1 << lgwin) - 16;
  for (int i = 0; i < 4; i++) S->e.ring[i] = kInitialRing[3 - i];
  memcpy(S->sim_ring, S->e.ring, sizeof(S->sim_ring));
  S->e.pm.w = (uint64_t*)malloc(sizeof(uint64_t) * 16 * 2 * 1200);
  S->e.pm.leaf = (uint8_t*)malloc(16 * 2 * 1200);
  /* q10/11: S->cfg is the q7-grade SEED matcher; the DP walks its own
     deep rings (mirrors btpu_encode_opt_impl) */
  cfg_for_quality(&S->cfg, quality >= 10 ? 7 : quality);
  if (quality >= 10) S->cfg.use_dict = 0;
  if (S->cfg.use_dict && dict_blob) {
    if (dict_index_init(dict_blob)) S->cfg.use_dict = 0;
  } else if (S->cfg.use_dict && !g_dict.ready) {
    S->cfg.use_dict = 0;
  }
  int cfg_rc = cfg_alloc_tables(&S->cfg, 0);
  S->cmd_cap = 1 << 12;
  S->cmds = (Cmd*)malloc(sizeof(Cmd) * S->cmd_cap);
  int ok = S->e.pm.w && S->e.pm.leaf && !cfg_rc && S->cmds;
  if (ok && quality >= 10) {
    size_t mb_max = (size_t)1 << 22;
    memset(&S->cfg_dp, 0, sizeof(S->cfg_dp));
    S->cfg_dp.hbits = 16;
    S->cfg_dp.block_bits = quality >= 11 ? 11 : 6;
    S->cfg_dp.depth = quality >= 11 ? 2048 : 64;
    S->cfg_dp.lazy = 0;
    S->cfg_dp.min_len = 4;
    S->cfg_dp.use_dict = 1;
    S->cfg_dp.h4 = 1;
    if (dict_blob) {
      if (dict_index_init(dict_blob)) S->cfg_dp.use_dict = 0;
    } else if (!g_dict.ready) {
      S->cfg_dp.use_dict = 0;
    }
    S->cfg_dp.lr_bits = 15;
    if (!getenv("BTPU_OPT_NO_BT") &&
        bt_alloc(&S->bt_dp, S->e.maxback, S->e.maxback) == 0) {
      S->bt_dp.open_end = 1;
      S->cfg_dp.bt = &S->bt_dp;
      S->cfg_dp.block_bits = 0;
    }
    int dp_rc = cfg_alloc_tables(&S->cfg_dp, 0);
    S->cfg_dp2 = S->cfg_dp;
    S->cfg_dp2.depth = 32;
    S->cfg_dp2.bucket = NULL;
    S->cfg_dp2.num = NULL;
    S->cfg_dp2.lr_tab = NULL;
    S->cfg_dp2.bt = NULL;
    if (quality >= 11) {
      if (S->cfg_dp.bt &&
          bt_alloc(&S->bt_dp2, S->e.maxback, S->e.maxback) == 0) {
        S->bt_dp2.open_end = 1;
        S->cfg_dp2.bt = &S->bt_dp2;
      }
      dp_rc = dp_rc || cfg_alloc_tables(&S->cfg_dp2, 0);
    } else {
      S->cfg_dp2.lr_bits = 0;
    }
    S->odp = (float*)malloc(sizeof(float) * (mb_max + 1));
    S->oblen = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
    S->obcpy = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
    S->obdist = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
    S->olastm = (uint32_t*)malloc(sizeof(uint32_t) * (mb_max + 1));
    S->oc.dalpha = S->e.dist_alpha;
    S->oc.ctx_mode_force = -1;
    S->oc.litc = (float*)malloc(sizeof(float) * mb_max);
    ok = !dp_rc && S->odp && S->oblen &&
         S->obcpy && S->obdist && S->olastm && S->oc.litc;
  }
  if (!ok) {
    free(S->e.pm.w); free(S->e.pm.leaf);
    cfg_free_tables(&S->cfg); free(S->cmds);
    cfg_free_tables(&S->cfg_dp); cfg_free_tables(&S->cfg_dp2);
    bt_free(&S->bt_dp); bt_free(&S->bt_dp2);
    free(S->odp); free(S->oblen); free(S->obcpy); free(S->obdist);
    free(S->olastm); free(S->oc.litc); free(S);
    return NULL;
  }
  return S;
}

void btpu_enc_free_stream(void* p) {
  EncStream* S = (EncStream*)p;
  if (!S) return;
  free(S->e.pm.w); free(S->e.pm.leaf); free(S->e.plan);
  cfg_free_tables(&S->cfg);
  free(S->cmds); free(S->buf); free(S->e.bw.buf);
  cfg_free_tables(&S->cfg_dp); cfg_free_tables(&S->cfg_dp2);
  bt_free(&S->bt_dp); bt_free(&S->bt_dp2);
  free(S->odp); free(S->oblen); free(S->obcpy); free(S->obdist);
  free(S->olastm); free(S->oc.litc);
  free(S);
}

static int stream_push_cmd(EncStream* S, uint32_t ins, uint32_t cpy,
                           uint32_t dist, uint32_t adv) {
  if (S->ncmd == S->cmd_cap) {
    size_t nc = S->cmd_cap * 2;
    Cmd* p = (Cmd*)realloc(S->cmds, sizeof(Cmd) * nc);
    if (!p) return EERR_ALLOC;
    S->cmds = p;
    S->cmd_cap = nc;
  }
  Cmd* c = &S->cmds[S->ncmd++];
  c->ins = ins; c->cpy = cpy; c->dist = dist; c->adv = adv;
  return 0;
}

/* Consume input up to absolute position `until`; close metablocks as
   they fill. Mirrors the one-shot loop (btpu_encode) with persistent
   state. */
static int stream_consume(EncStream* S, size_t until) {
  const uint8_t* data = S->buf - S->base; /* absolute indexing */
  size_t n = S->base + S->len;            /* match-extension horizon */
  const size_t mb_target = (size_t)1 << 22;
  int rc;
  int dict_level = S->e.quality >= 7 ? 2 : 1;
  while (S->pos < until) {
    size_t pos = S->pos;
    MatchResult m;
    find_match(data, pos, n, S->e.maxback, S->sim_ring, &S->cfg, &m);
    int dcopy = 0, dtid = 0, dwlen = 0;
    uint32_t didx = 0;
    int dout = 0;
    if (S->cfg.use_dict && m.len < 12) {
      int min_out = m.len >= 4 ? (int)m.len + 1 : 4;
      dout = dict_probe(data, pos, n, min_out, dict_level, &dcopy,
                        &dtid, &didx,
                        &dwlen);
    }
    if (dout > (int)m.len) {
      size_t q = pos - S->dict_len;
      size_t maxd = q < S->e.maxback ? q : S->e.maxback;
      uint32_t dist = (uint32_t)(maxd + 1 + S->dict_len +
          ((uint32_t)dtid << kDictSizeBits[dwlen]) + didx);
      if ((rc = stream_push_cmd(S, (uint32_t)(pos - S->lit_start), dcopy,
                                dist, (uint32_t)dout | CMD_DICT)))
        return rc;
      S->copy_bytes += (size_t)dout;
      size_t end = pos + (size_t)dout;
      for (size_t p2 = pos; p2 < end; p2++)
        insert_hash(data, p2, &S->cfg);
      S->pos = end;
      S->lit_start = S->pos;
      S->miss_run = 0;
    } else if (m.len >= 4) {
      int pos_inserted = 0;
      if (S->cfg.lazy && m.len < 160) {
        int defer = 0;
        while (defer < 4 && pos + 1 < n) {
          MatchResult m2;
          insert_hash(data, pos, &S->cfg);
          pos_inserted = 1;
          find_match(data, pos + 1, n, S->e.maxback, S->sim_ring,
                     &S->cfg, &m2);
          if (m2.score > m.score + 130) {
            pos += 1;
            m = m2;
            pos_inserted = 0;
            defer++;
          } else {
            break;
          }
        }
      }
      size_t end = pos + m.len;
      /* the copies [at[j], at[j] + len[j]) for j in [first, ncp): a
         copy crossing the dictionary's end splits there, as in
         stream_split_cmds (a 1-byte head or rest stays a literal) */
      size_t head = stream_dict_head(S, pos - m.dist, m.len);
      size_t at[2] = {pos, pos + head};
      size_t len[2] = {head ? head : m.len, m.len - head};
      int first = head == 1, ncp = head && m.len - head > 1 ? 2 : 1;
      for (int j = first; j < ncp; j++) {
        uint32_t emit_dist = S->dict_len
            ? stream_map_dist(S, at[j], m.dist) : (uint32_t)m.dist;
        if ((rc = stream_push_cmd(S, (uint32_t)(at[j] - S->lit_start),
                                  (uint32_t)len[j], emit_dist,
                                  (uint32_t)len[j])))
          return rc;
        S->copy_bytes += len[j];
        if (emit_dist != S->sim_ring[0]) {
          S->sim_ring[3] = S->sim_ring[2];
          S->sim_ring[2] = S->sim_ring[1];
          S->sim_ring[1] = S->sim_ring[0];
          S->sim_ring[0] = emit_dist;
        }
        S->lit_start = at[j] + len[j];
      }
      size_t step = m.len > 256 ? 4 : 1;
      if (!pos_inserted) insert_hash(data, pos, &S->cfg);
      for (size_t p2 = pos + 1; p2 < end; p2 += step)
        insert_hash_ex(data, p2, &S->cfg, 0);
      S->pos = end;
      S->miss_run = 0;
    } else {
      insert_hash(data, pos, &S->cfg);
      S->miss_run++;
      size_t step = S->miss_run > 512 ? 4 : S->miss_run > 128 ? 2 : 1;
      S->pos = pos + step;
      if (S->pos > n) S->pos = n;
    }
    /* close a full metablock at a command boundary */
    if (S->pos - S->mb_lo >= mb_target && S->pos < n) {
      size_t hi;
      if (S->lit_start > S->mb_lo) {
        hi = S->lit_start; /* pending literals roll forward */
      } else {
        if ((rc = stream_push_cmd(
                 S, (uint32_t)(S->pos - S->lit_start), 0, 0, 0)))
          return rc;
        S->lit_start = S->pos;
        hi = S->pos;
      }
      if (hi > S->mb_lo) {
        S->e.data = data;
        rc = emit_metablock(&S->e, S->cmds, S->ncmd, S->mb_lo, hi, 0);
        if (rc) return rc;
        memcpy(S->sim_ring, S->e.ring, sizeof(S->sim_ring));
        S->ncmd = 0;
        S->copy_bytes = 0;
        S->mb_lo = hi;
      }
    }
  }
  return 0;
}

/* Trim the sliding buffer: keep the window plus context bytes. */
static void stream_trim(EncStream* S) {
  size_t keep_from = S->mb_lo < S->e.maxback ? 0 : S->mb_lo - S->e.maxback;
  if (keep_from <= S->base || S->len < (S->e.maxback * 2))
    return;
  size_t drop = keep_from - S->base;
  memmove(S->buf, S->buf + drop, S->len - drop + SPAD);
  S->base += drop;
  S->len -= drop;
}

/* q10/11 streaming consume: seed -> cost model -> DP -> emit per
   metablock over [S->pos, until), with ALL hash/ring/window state
   persistent across calls -- a flush costs O(new bytes), never a
   re-find over history (the round-2 gap this closes: the default
   Compressor quality is 11). `last` marks the metablock ending at
   `until` as ISLAST. */
static int opt_stream_consume(EncStream* S, size_t until, int last) {
  const uint8_t* data = S->buf - S->base;
  size_t n = S->base + S->len;
  const size_t mb_target = (size_t)1 << 22;
  int rc = 0;
  while (S->pos < until) {
    size_t lo = S->pos;
    size_t hi = lo + mb_target < until ? lo + mb_target : until;
    Cmd* seed = NULL;
    size_t nseed = 0;
    rc = opt_seed_pass(data, n, lo, hi, S->e.maxback, &S->cfg,
                       S->sim_ring, &seed, &nseed);
    if (rc) return rc;
    if (nseed > S->e.plan_cap) {
      free(S->e.plan);
      S->e.plan_cap = nseed + 64;
      S->e.plan = (Plan*)malloc(sizeof(Plan) * S->e.plan_cap);
      if (!S->e.plan) {
        free(seed);
        return EERR_ALLOC;
      }
    }
    opt_costs_from_seed(data, lo, hi, seed, nseed, S->e.ring,
                        S->e.plan, &S->oc);
    Cmd* cmds = NULL;
    size_t ncmd = 0;
    rc = opt_parse_block(data, n, lo, hi, S->e.maxback, &S->cfg_dp,
                         seed, nseed, S->e.ring, &S->oc, S->odp,
                         S->oblen, S->obcpy, S->obdist, S->olastm,
                         &cmds, &ncmd);
    free(seed);
    if (rc) return rc;
    if (S->e.quality >= 11) { /* recost iteration (ZopfliIterate) */
      if (ncmd > S->e.plan_cap) {
        free(S->e.plan);
        S->e.plan_cap = ncmd + 64;
        S->e.plan = (Plan*)malloc(sizeof(Plan) * S->e.plan_cap);
        if (!S->e.plan) {
          free(cmds);
          return EERR_ALLOC;
        }
      }
      opt_costs_from_seed(data, lo, hi, cmds, ncmd, S->e.ring,
                          S->e.plan, &S->oc);
      Cmd* cmds2 = NULL;
      size_t ncmd2 = 0;
      rc = opt_parse_block(data, n, lo, hi, S->e.maxback, &S->cfg_dp2,
                           cmds, ncmd, S->e.ring, &S->oc, S->odp,
                           S->oblen, S->obcpy, S->obdist, S->olastm,
                           &cmds2, &ncmd2);
      if (rc) {
        free(cmds);
        return rc;
      }
      free(cmds);
      cmds = cmds2;
      ncmd = ncmd2;
    }
    if ((rc = stream_split_cmds(S, &cmds, &ncmd, lo))) {
      free(cmds);
      return rc;
    }
    stream_remap_cmds(S, cmds, ncmd, lo);
    S->e.data = data;
    rc = emit_metablock(&S->e, cmds, ncmd, lo, hi,
                        last && hi >= until);
    free(cmds);
    if (rc) return rc;
    memcpy(S->sim_ring, S->e.ring, sizeof(S->sim_ring));
    S->pos = hi;
    S->lit_start = hi;
    S->mb_lo = hi;
  }
  return 0;
}

/* Attach a raw LZ77 (compound) dictionary as preloaded history:
   matchers see it as window prefix; emitted distances are remapped
   into the shared-brotli compound address space (decoder position
   space starts at the data, RFC shared-dictionary; role parity:
   BrotliEncoderAttachPreparedDictionary, c/enc/encode.c:1828).
   Call once, before any input. */
int btpu_enc_attach(void* p, const uint8_t* dict, size_t dlen) {
  EncStream* S = (EncStream*)p;
  if (!S || S->started || S->len || S->dict_len || !dlen)
    return EERR_PARAM;
  if (dlen > ((size_t)1 << 31)) return EERR_PARAM;
  if (dlen + SPAD > S->cap) {
    size_t nc = S->cap ? S->cap : (1 << 16);
    while (dlen + SPAD > nc) nc *= 2;
    uint8_t* nb = (uint8_t*)realloc(S->buf, nc);
    if (!nb) return EERR_ALLOC;
    S->buf = nb;
    S->cap = nc;
  }
  memcpy(S->buf, dict, dlen);
  S->len = dlen;
  memset(S->buf + S->len, 0, SPAD);
  S->dict_len = dlen;
  /* index the dictionary into every matcher's hash state */
  if (dlen >= 5) {
    for (size_t p2 = 0; p2 + 5 <= dlen; p2++) {
      insert_hash(S->buf, p2, &S->cfg);
      if (S->cfg_dp.bucket)
        opt_insert_pos(S->buf, dlen, p2, S->e.maxback, &S->cfg_dp, 0);
      if (S->cfg_dp2.bucket)
        opt_insert_pos(S->buf, dlen, p2, S->e.maxback, &S->cfg_dp2, 0);
    }
  }
  return 0;
}

/* op: 0 = process (buffer, bounded emit), 1 = flush, 2 = finish.
   Emits accumulated output bytes (possibly none for op 0). */
int btpu_enc_chunk(void* p, const uint8_t* in, size_t in_len, int op,
                   uint8_t** out, size_t* out_len) {
  EncStream* S = (EncStream*)p;
  int rc = 0;
  *out = NULL;
  *out_len = 0;
  if (!S || S->finished) return EERR_PARAM;
  /* hash-chain positions are stored as uint32 pos+1 */
  if (S->base + S->len + in_len > ((size_t)1 << 32) - 32)
    return EERR_PARAM;
  if (in_len) {
    if (S->len + in_len + SPAD > S->cap) {
      size_t nc = S->cap ? S->cap : (1 << 16);
      while (S->len + in_len + SPAD > nc) nc *= 2;
      uint8_t* nb = (uint8_t*)realloc(S->buf, nc);
      if (!nb) return EERR_ALLOC;
      S->buf = nb;
      S->cap = nc;
    }
    memcpy(S->buf + S->len, in, in_len);
    S->len += in_len;
    memset(S->buf + S->len, 0, SPAD);
  }
  if (!S->started) {
    put_stream_header(&S->e.bw, S->e.lgwin);
    S->started = 1;
    S->pos = S->lit_start = S->mb_lo = S->dict_len;
    S->e.ctx_start = S->dict_len;
  }
  size_t n = S->base + S->len;
  int opt = S->e.quality >= 10;
  if (op == 0) {
    /* consume all but a lazy-window tail; metablocks emit as they fill
       (q10/11: only FULL metablocks -- a partial span waits for more
       input or a flush, so mid-stream commands never split early) */
    size_t hold = 512;
    if (n > S->pos + hold) {
      size_t tgt = n - hold;
      if (opt) {
        size_t mb = (size_t)1 << 22;
        size_t full = S->pos + ((tgt - S->pos) / mb) * mb;
        if (full > S->pos) rc = opt_stream_consume(S, full, 0);
      } else {
        rc = stream_consume(S, tgt);
      }
    }
  } else {
    int is_last = (op == 2);
    if (opt) {
      size_t before = S->pos;
      rc = opt_stream_consume(S, n, is_last);
      if (rc == 0 && is_last && before >= n) {
        bw_put(&S->e.bw, 1, 1); /* ISLAST */
        bw_put(&S->e.bw, 1, 1); /* ISLASTEMPTY */
      }
    } else {
      rc = stream_consume(S, n);
      if (rc == 0 && S->pos < n) { /* sparse-probe overshoot guard */
        S->pos = n;
      }
      if (rc == 0) {
        if (S->lit_start < n) {
          rc = stream_push_cmd(S, (uint32_t)(n - S->lit_start), 0, 0,
                               0);
          S->lit_start = n;
        }
        if (rc == 0 && n > S->mb_lo) {
          S->e.data = S->buf - S->base;
          rc = emit_metablock(&S->e, S->cmds, S->ncmd, S->mb_lo, n,
                              is_last);
          memcpy(S->sim_ring, S->e.ring, sizeof(S->sim_ring));
          S->ncmd = 0;
          S->copy_bytes = 0;
          S->mb_lo = n;
        } else if (rc == 0 && is_last) {
          bw_put(&S->e.bw, 1, 1); /* ISLAST */
          bw_put(&S->e.bw, 1, 1); /* ISLASTEMPTY */
        }
      }
    }
    if (rc == 0 && !is_last) {
      /* empty metadata block: byte-aligns the flushed prefix */
      bw_put(&S->e.bw, 0, 1);
      bw_put(&S->e.bw, 3, 2);
      bw_put(&S->e.bw, 0, 1);
      bw_put(&S->e.bw, 0, 2);
    }
    if (rc == 0) rc = bw_flush_align(&S->e.bw);
    if (rc == 0 && op == 2) S->finished = 1;
  }
  if (rc) return rc;
  stream_trim(S);
  /* hand out accumulated bytes (bit accumulator is empty only after
     flush/finish; mid-process we hold back the ragged tail) */
  size_t give = S->e.bw.len;
  if (give) {
    uint8_t* o = (uint8_t*)malloc(give ? give : 1);
    if (!o) return EERR_ALLOC;
    memcpy(o, S->e.bw.buf, give);
    *out = o;
    *out_len = give;
    /* keep any pending bits; shift buffer down */
    S->e.bw.len = 0;
  }
  return 0;
}

/* Flush pending data, then write one metadata block carrying `payload`
   (byte-aligned, opaque to decompression; parity: EMIT_METADATA).
   The metadata block doubles as the byte-alignment block, so decoders
   see exactly one metadata event per call. */
int btpu_enc_metadata(void* p, const uint8_t* payload, size_t plen,
                      uint8_t** out, size_t* out_len) {
  EncStream* S = (EncStream*)p;
  int rc = 0;
  *out = NULL;
  *out_len = 0;
  if (!S || S->finished || plen > (1u << 24)) return EERR_PARAM;
  if (!S->started) {
    put_stream_header(&S->e.bw, S->e.lgwin);
    S->started = 1;
  }
  size_t n = S->base + S->len;
  if (S->e.quality >= 10) {
    rc = opt_stream_consume(S, n, 0);
    if (rc) return rc;
  } else {
    rc = stream_consume(S, n);
    if (rc) return rc;
    if (S->pos < n) S->pos = n;
    if (S->lit_start < n) {
      rc = stream_push_cmd(S, (uint32_t)(n - S->lit_start), 0, 0, 0);
      if (rc) return rc;
      S->lit_start = n;
    }
    if (n > S->mb_lo) {
      S->e.data = S->buf - S->base;
      rc = emit_metablock(&S->e, S->cmds, S->ncmd, S->mb_lo, n, 0);
      if (rc) return rc;
      memcpy(S->sim_ring, S->e.ring, sizeof(S->sim_ring));
      S->ncmd = 0;
      S->copy_bytes = 0;
      S->mb_lo = n;
    }
  }
  BW* bw = &S->e.bw;
  bw_put(bw, 0, 1);  /* ISLAST = 0 */
  bw_put(bw, 3, 2);  /* metadata */
  bw_put(bw, 0, 1);  /* reserved */
  int nbytes = plen == 0 ? 0 : plen < (1 << 8) ? 1
               : plen < (1 << 16) ? 2 : 3;
  bw_put(bw, (uint64_t)nbytes, 2);
  for (int i = 0; i < nbytes; i++)
    bw_put(bw, ((plen - 1) >> (8 * i)) & 0xFF, 8);
  rc = bw_flush_align(bw);
  if (rc) return rc;
  rc = bw_reserve(bw, plen);
  if (rc) return rc;
  memcpy(bw->buf + bw->len, payload, plen);
  bw->len += plen;
  stream_trim(S);
  size_t give = bw->len;
  if (give) {
    uint8_t* o = (uint8_t*)malloc(give);
    if (!o) return EERR_ALLOC;
    memcpy(o, bw->buf, give);
    *out = o;
    *out_len = give;
    bw->len = 0;
  }
  return 0;
}

/* ---------- peak-memory estimator ----------
 *
 * Role parity: BrotliEncoderEstimatePeakMemoryUsage
 * (/root/reference/c/enc/encode.c:1886): an upper bound on the
 * encoder's transient heap for a one-shot encode of n bytes, summed
 * from the SAME formulas the allocation sites above use (hasher
 * bucket rings, DP arrays, command buffers, serializer scratch,
 * output writer). The bound is pessimistic: command arrays assume the
 * densest legal parse (one command per 4 bytes) and the writer the
 * uncompressed-fallback ceiling. */
size_t btpu_peak_memory(size_t n, int quality, int lgwin) {
  if (quality < 0) quality = 0;
  if (quality > 11) quality = 11;
  if (lgwin < 10) lgwin = 10;
  if (lgwin > 30) lgwin = 30;
  size_t total = n + 16;                 /* padded input copy */
  total += (16 * 2 * 1200) * (sizeof(uint64_t) + 1); /* pm scratch */
  size_t mb = n < ((size_t)1 << 22) ? n : ((size_t)1 << 22);
  size_t mb_cmds = mb / 4 + 64;          /* densest parse of one mb */
  /* serializer scratch: symbol stream copy, split histograms,
     context-histogram rows (<= 16 types x 64 contexts x 256 syms),
     switch plans */
  size_t serial = mb * 2 + (size_t)16 * 64 * 256 * sizeof(uint32_t) +
                  (1 << 16);
  /* output writer: uncompressed-fallback ceiling */
  size_t writer = n + n / 16 + 1024;
  /* long-range table (cfg_alloc_tables: allocated when the input can
     use it); worst-case touched-page bound per table */
  size_t lr_one = n >= ((size_t)1 << 19)
                      ? ((size_t)1 << (18 + LR_REC_SHIFT)) *
                            sizeof(uint32_t)
                      : 0;
  if (quality >= 10) {
    MatchCfg seedc, dpc;
    cfg_for_quality(&seedc, 7);
    memset(&dpc, 0, sizeof(dpc));
    dpc.hbits = 16;
    dpc.block_bits = quality >= 11 ? 11 : 6;
    size_t hashers =
        ((((size_t)1 << (seedc.hbits + seedc.block_bits)) +
          ((size_t)1 << (size_t)seedc.hbits)) +
         (quality >= 11 ? 2u : 1u) *
             (((size_t)1 << (dpc.hbits + dpc.block_bits)) +
              ((size_t)1 << dpc.hbits))) *
        sizeof(uint32_t) +
        (quality >= 11 ? 3u : 2u) * lr_one;
    {
      /* binary-tree candidate source (bt_alloc): head + 2-slot child
         array over pow2(min(n, window)) positions, per DP iteration */
      size_t win = ((size_t)1 << lgwin) - 16;
      size_t w = n < win ? n : win;
      size_t ws = 256;
      while (ws < w) ws <<= 1;
      hashers += (quality >= 11 ? 2u : 1u) *
                 ((((size_t)1 << BT_HBITS) + 2 * ws) * sizeof(uint32_t));
    }
    /* DP arrays: dp float + blen/bcpy/bdist/lastm, literal costs,
       plan, and two command generations live at once */
    size_t dp_arrays = (mb + 1) * (sizeof(float) + 4 * sizeof(uint32_t))
                       + mb * sizeof(float);
    size_t cmd_bufs = mb_cmds * (2 * sizeof(Cmd) + sizeof(Plan));
    return total + hashers + dp_arrays + cmd_bufs + serial + writer;
  }
  MatchCfg cfg;
  cfg_for_quality(&cfg, quality);
  size_t hasher = (((size_t)1 << (cfg.hbits + cfg.block_bits)) +
                   ((size_t)1 << cfg.hbits)) * sizeof(uint32_t) +
                  (cfg.lr_bits ? lr_one : 0);
  size_t cmd_bufs = ((size_t)1 << 16) * sizeof(Cmd) +
                    mb_cmds * sizeof(Plan);
  return total + hasher + cmd_bufs + serial + writer;
}

/* ---------- exact per-position literal cost (device DP host stage)
 *
 * Role parity: c/enc/literal_cost.c BrotliEstimateBitCostsForLiterals
 * blended with the 2nd-order context-modeled pricing the DP cost model
 * uses (ops/optimal_jax._cost_tables exact path, previously ~25 s of
 * numpy on a 16 MB input).  Two models per position:
 *   1. context bits: -log2 of the seed parse's literal histogram row
 *      [lut0[p1] | lut1[p2]] (+1 smoothing), UTF8 context LUT;
 *   2. (optional) UTF8 position-in-codepoint model: a +-495-byte
 *      sliding window of (class, byte) counts, class = position in
 *      codepoint, with the reference's squash + prologue surcharge.
 * Output is the blended cost quantized to uint8 at 1/8 bit, scaled by
 * `surcharge` (tree-quantization slack, default 1.1). */


#define LCW 495 /* sliding half-window (literal_cost.c window) */

/* UTF8 position-in-codepoint sliding-window literal cost over
   data[lo, hi) into ucost[0, hi-lo) (the literal_cost.c model:
   +-LCW window of (class, byte) counts, squash, prologue surcharge).
   Returns 0, or -1 when the region does not sample as UTF8 / OOM. */
static int utf8_window_cost(const uint8_t* data, size_t lo, size_t hi,
                            float* ucost) {
  size_t n = hi - lo;
  if (n == 0 || choose_ctx_mode(data, lo, hi) != 2) return -1;
  uint8_t* cls = (uint8_t*)malloc(n);
  float* lg = (float*)malloc(sizeof(float) * (2 * LCW + 3));
  if (!cls || !lg) {
    free(cls);
    free(lg);
    return -1;
  }
  lg[0] = 0.0f;
  for (int i = 1; i < 2 * LCW + 3; i++) lg[i] = (float)log2((double)i);
  /* stats level (literal_cost.c DecideMultiByteStatsLevel) */
  size_t c1 = 0, c2 = 0;
  for (size_t p = 0; p < n; p++) {
    size_t gp = lo + p;
    uint8_t c = gp >= 1 ? data[gp - 1] : 0;
    uint8_t last = gp >= 2 ? data[gp - 2] : 0;
    int k = c < 128 ? 0 : (c >= 192 ? 1 : (last < 0xE0 ? 0 : 2));
    if (k == 1) c1++;
    if (k == 2) c2++;
  }
  int max_utf8 = 1; /* ref: "should be 2, but 1 compresses better" */
  if (c1 + c2 < 25) max_utf8 = 0;
  for (size_t p = 0; p < n; p++) {
    size_t gp = lo + p;
    uint8_t c = gp >= 1 ? data[gp - 1] : 0;
    uint8_t last = gp >= 2 ? data[gp - 2] : 0;
    int k = c < 128 ? 0
                    : (c >= 192 ? (1 < max_utf8 ? 1 : max_utf8)
                                : (last < 0xE0 ? 0
                                   : (2 < max_utf8 ? 2 : max_utf8)));
    cls[p] = (uint8_t)k;
  }
  uint32_t wh[3][256];
  uint32_t wt[3] = {0, 0, 0};
  memset(wh, 0, sizeof(wh));
  size_t wend = n < LCW ? n : LCW; /* window [p-LCW, p+LCW] */
  for (size_t q = 0; q < wend; q++) {
    wh[cls[q]][data[lo + q]]++;
    wt[cls[q]]++;
  }
  for (size_t p = 0; p < n; p++) {
    if (p + LCW < n) {
      wh[cls[p + LCW]][data[lo + p + LCW]]++;
      wt[cls[p + LCW]]++;
    }
    if (p >= LCW + 1) {
      wh[cls[p - LCW - 1]][data[lo + p - LCW - 1]]--;
      wt[cls[p - LCW - 1]]--;
    }
    int k = cls[p];
    uint32_t h = wh[k][data[lo + p]];
    if (h < 1) h = 1;
    float cost = lg[wt[k]] - lg[h] + 0.02905f;
    if (cost < 1.0f) cost = cost * 0.5f + 0.5f;
    if (lo + p < 2000)
      cost += 0.35f + (0.35f / 2000.0f) * (float)(lo + p);
    ucost[p] = cost;
  }
  free(cls);
  free(lg);
  return 0;
}

int btpu_lit_cost(const uint8_t* data, size_t n, const uint32_t* mpos,
                  const uint32_t* mlen, size_t nmatch, double surcharge,
                  int use_utf8, uint8_t* out) {
  if (n == 0) return 0;
  const uint8_t* lut0 = kContextLut[2]; /* UTF8 mode, like the host DP */
  const uint8_t* lut1 = lut0 + 256;
  uint32_t* lh = (uint32_t*)calloc((size_t)NUM_LIT_CTX * 256,
                                   sizeof(uint32_t));
  float* bits_tab = (float*)malloc((size_t)NUM_LIT_CTX * 256 *
                                   sizeof(float));
  if (!lh || !bits_tab) {
    free(lh);
    free(bits_tab);
    return EERR_ALLOC;
  }

  /* 1. seed-literal histogram over (context, byte) */
  size_t pos = 0;
  for (size_t i = 0; i <= nmatch; i++) {
    size_t stop = i < nmatch ? mpos[i] : n;
    if (stop > n) stop = n;
    for (size_t pp = pos; pp < stop; pp++) {
      uint8_t p1 = pp >= 1 ? data[pp - 1] : 0;
      uint8_t p2 = pp >= 2 ? data[pp - 2] : 0;
      lh[(size_t)(lut0[p1] | lut1[p2]) * 256 + data[pp]]++;
    }
    if (i < nmatch) {
      size_t e = mpos[i] + mlen[i];
      pos = e > pos ? e : pos;
    }
  }
  for (int cx = 0; cx < NUM_LIT_CTX; cx++) {
    uint64_t t = 0;
    for (int b = 0; b < 256; b++) t += lh[(size_t)cx * 256 + b];
    double lt = log2((double)t + 256.0);
    for (int b = 0; b < 256; b++)
      bits_tab[(size_t)cx * 256 + b] =
          (float)(lt - log2((double)(lh[(size_t)cx * 256 + b] + 1)));
  }

  /* 2. UTF8 sliding-window model (only when the input samples UTF8) */
  float* ucost = NULL;
  if (use_utf8) {
    ucost = (float*)malloc(n * sizeof(float));
    if (ucost && utf8_window_cost(data, 0, n, ucost) != 0) {
      free(ucost);
      ucost = NULL;
    }
  }

  /* 3. blend + quantize (1/8-bit units, uint8) */
  double s8 = surcharge * 8.0;
  for (size_t p = 0; p < n; p++) {
    uint8_t p1 = p >= 1 ? data[p - 1] : 0;
    uint8_t p2 = p >= 2 ? data[p - 2] : 0;
    float cb = bits_tab[(size_t)(lut0[p1] | lut1[p2]) * 256 + data[p]];
    float lit = ucost ? 0.5f * (cb + ucost[p]) : cb;
    double q = (double)lit * s8 + 0.5;
    out[p] = q < 0.0 ? 0 : (q > 255.0 ? 255 : (uint8_t)q);
  }
  free(ucost);
  free(lh);
  free(bits_tab);
  return 0;
}

/* Dictionary post-pass over an externally produced parse (the device
   DP's host stage; role parity: the encoder-side static-dictionary
   matcher applied to parse gaps, enc/matcher.add_dictionary_matches,
   previously ~1.3 s of numpy per 16 MB). Probes every literal-gap
   position with the same transform set as the DP's dict edges, gates
   like the host pass (a farther synthetic distance must buy a longer
   word: >= 5/6/7 output bytes at < 2^12 / < 2^18 / beyond), takes
   non-overlapping hits greedily, and APPENDS only the new word
   references as (pos, output_advance, dist, 2000 + word_length). */
int btpu_dict_post(const uint8_t* data, size_t n, size_t base,
                   size_t active_from, size_t max_distance,
                   const uint8_t* dict_blob, const uint32_t* mpos,
                   const uint32_t* mlen, size_t nmatch,
                   uint32_t* out_pos, uint32_t* out_len,
                   uint32_t* out_dist, uint32_t* out_flag, size_t cap,
                   size_t* out_cnt) {
  *out_cnt = 0;
  if (dict_blob) {
    if (dict_index_init(dict_blob)) return 0;
  } else if (!g_dict.ready) {
    return 0;
  }
  size_t mi = 0;
  size_t p = active_from;
  size_t cnt = 0;
  while (p + 4 <= n) {
    while (mi < nmatch && (size_t)mpos[mi] + mlen[mi] <= p) mi++;
    if (mi < nmatch && (size_t)mpos[mi] <= p) { /* inside a match */
      p = (size_t)mpos[mi] + mlen[mi];
      continue;
    }
    size_t gap_end = mi < nmatch ? (size_t)mpos[mi] : n;
    if (p >= gap_end) {
      p = gap_end;
      continue;
    }
    int dcopy = 0, dtid = 0, dwlen = 0;
    uint32_t didx = 0;
    int dout = dict_probe(data, p, n, 4, 3, &dcopy, &dtid, &didx,
                          &dwlen);
    if (dout >= 4 && p + (size_t)dout <= gap_end) {
      size_t maxd = p + base < max_distance ? p + base : max_distance;
      uint64_t dist = (uint64_t)maxd + 1 +
                      ((uint64_t)dtid << kDictSizeBits[dwlen]) + didx;
      int gate = dist >= (1u << 18) ? 7 : dist >= (1u << 12) ? 6 : 5;
      if (dout >= gate) {
        if (cnt >= cap) return EERR_PARAM;
        out_pos[cnt] = (uint32_t)p;
        out_len[cnt] = (uint32_t)dout;
        out_dist[cnt] = (uint32_t)dist;
        out_flag[cnt] = 2000u + (uint32_t)dcopy;
        cnt++;
        p += (size_t)dout;
        continue;
      }
    }
    p++;
  }
  *out_cnt = cnt;
  return 0;
}

/* Probe the static dictionary at EVERY position (the H10-style "dict
   edges inside the DP" role for the device pipeline: the parse-stats
   diff showed the gap-only post-pass finds 396 word refs on 2 MB
   where the native DP's in-parse dictionary edges find 7,580).
   Sparse output: hit positions (ascending) + packed payloads
   (out_advance << 22 | wlen << 17 | dictoff) where dictoff =
   (transform_id << size_bits[wlen]) + index -- the decode-time
   distance is min(pos + base, maxback) + 1 + dictoff, computed where
   the consumer knows the position space. */
int btpu_dict_probe_all(const uint8_t* data, size_t n, size_t base,
                        size_t maxback, const uint8_t* dict_blob,
                        const uint32_t* mpos, const uint32_t* mlen,
                        size_t nmatch, uint32_t* out_pos,
                        uint32_t* out_payload, size_t cap,
                        size_t* out_cnt) {
  *out_cnt = 0;
  if (dict_blob) {
    if (dict_index_init(dict_blob)) return 0;
  } else if (!g_dict.ready) {
    return 0;
  }
  size_t cnt = 0;
  size_t mi = 0;
  for (size_t p = 0; p + 4 <= n; p++) {
    /* probe only where the seed parse is weak (the native DP probes
       when its walk found < 16): skip the interior of seed matches
       of length >= 12 -- ungated, >24% of text positions carry a
       word hit and would flood the sparse channel */
    while (mi < nmatch && (size_t)mpos[mi] + mlen[mi] <= p) mi++;
    if (mi < nmatch && (size_t)mpos[mi] <= p && mlen[mi] >= 12) {
      p = (size_t)mpos[mi] + mlen[mi] - 1; /* ++ in the loop */
      continue;
    }
    /* the word-length gate by synthetic-distance magnitude (the
       add_dictionary_matches rule): a far dictionary distance costs
       ~22+ bits, so short words never win there -- shipping them
       would flood the sparse channel (ungated: >25% of positions) */
    size_t maxd = p + base < maxback ? p + base : maxback;
    int gate = maxd + 1 >= (1u << 18) ? 7
               : maxd + 1 >= (1u << 12) ? 6 : 5;
    int dcopy = 0, dtid = 0, dwlen = 0;
    uint32_t didx = 0;
    int dout = dict_probe(data, p, n, gate, 3, &dcopy, &dtid, &didx,
                          &dwlen);
    if (dout < gate) continue;
    uint32_t off = ((uint32_t)dtid << kDictSizeBits[dwlen]) + didx;
    /* the sparse payload carries the dict offset in 17 bits; a high
       transform id on an 11-bit length bucket can exceed that and
       would corrupt the packed wlen/advance fields -- skip (such
       deep-transform words rarely win the DP anyway) */
    if (off >= (1u << 17)) continue;
    if (cnt >= cap) return EERR_PARAM;
    out_pos[cnt] = (uint32_t)p;
    out_payload[cnt] = ((uint32_t)dout << 22) |
                       ((uint32_t)dwlen << 17) | off;
    cnt++;
  }
  *out_cnt = cnt;
  return 0;
}
