/* Distance coding under NPOSTFIX/NDIRECT for the region serializer
 * (btpu_serialize), and the per-metablock search of the two parameters
 * that brotli's FONT mode asks for.
 *
 * RFC 7932 section 4 codes an explicit distance d as a symbol of
 * 16 + NDIRECT + (48 << NPOSTFIX) (24 distance bits) and extra bits:
 * d <= NDIRECT is the direct code 16 + d - 1 with none; otherwise, with
 * dd = d - NDIRECT - 1, the low NPOSTFIX bits of dd select the postfix
 * and dd >> NPOSTFIX = hcode is coded as a prefix of nbits =
 * max(bit_length(hcode + 4) - 2, 1) extra bits (enc/bitstream.
 * encode_distances_vec). Glyph data holds 2-byte values, so a font's
 * distances are mostly even and NPOSTFIX 1 halves their extra bits.
 *
 * The search is enc/bitstream.choose_distance_params, with its cost and
 * its tie order: over NPOSTFIX 0..3 and NDIRECT = k << NPOSTFIX for k in
 * 0..15, the metablock's explicit distances (in command order, every
 * step-th where there are more than 32768) cost the entropy of their
 * symbol histogram plus their extra bits, times the step, plus 10 bits a
 * used symbol; the first config cheaper by more than 1e-9 than the best
 * so far wins. The entropy's sum is numpy's pairwise sum, so the two
 * compute the same doubles.
 *
 * Included by btpu_enc.c after its Enc type: emit_metablock calls
 * dist_params_apply on each metablock's plan (plan_cmds codes explicit
 * distances at NPOSTFIX 0, NDIRECT 0; the short codes and the ring do
 * not depend on the parameters), which with `dist_search` picks the
 * parameters and codes the explicit distances again under them, and
 * counts what the serializer returns in its stats.
 */

#define DIST_MAX_NPOSTFIX 3
#define DIST_SAMPLE 32768
/* the largest distance alphabet the search can give: 16 + 120 + 384 */
#define NUM_DIST_FONT (16 + (15 << DIST_MAX_NPOSTFIX) + \
                       (48 << DIST_MAX_NPOSTFIX))

/* stats of a btpu_serialize call (its `stats` output) */
enum {
  DSTAT_METABLOCKS,  /* compressed metablocks written */
  DSTAT_PARAMS,      /* of those, written with NPOSTFIX or NDIRECT not 0 */
  DSTAT_DISTS,       /* explicit distances written */
  DSTAT_EXTRA_BITS,  /* their extra bits */
  DSTAT_THREADED,    /* metablocks whose literal split ladder or per-type
                        clustering ran on more than one thread */
  DSTAT_N
};

static inline int dist_alphabet(int npostfix, int ndirect) {
  return 16 + ndirect + (48 << npostfix);
}

/* The symbol, extra value and extra-bit count of explicit distance
   `dist` (>= 1). */
static inline void dist_code(uint32_t dist, int npostfix, int ndirect,
                             uint16_t* code, uint32_t* extra,
                             uint8_t* nbits) {
  if (dist <= (uint32_t)ndirect) {
    *code = (uint16_t)(16 + dist - 1);
    *extra = 0;
    *nbits = 0;
    return;
  }
  const uint64_t dd = (uint64_t)dist - (uint64_t)ndirect - 1;
  const uint64_t postfix = dd & ((1u << npostfix) - 1);
  const uint64_t hcode = dd >> npostfix;
  /* bit_length of (hcode + 4) >> 2, which is at least 1 */
  const int nb = 64 - __builtin_clzll((hcode + 4) >> 2);
  const uint64_t rest = hcode + 4 - (2ull << nb);
  const uint64_t half = rest >> nb;
  *code = (uint16_t)(16 + ndirect +
                     (((((uint64_t)nb - 1) << 1) | half) << npostfix) +
                     postfix);
  *extra = (uint32_t)(rest - (half << nb));
  *nbits = (uint8_t)nb;
}

/* numpy's pairwise summation of a float64 array (add.reduce) */
static double np_pairwise_sum(const double* a, size_t n) {
  if (n < 8) {
    double r = 0.0;
    for (size_t i = 0; i < n; i++) r += a[i];
    return r;
  }
  if (n <= 128) {
    double r[8];
    size_t i;
    for (int j = 0; j < 8; j++) r[j] = a[j];
    for (i = 8; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; j++) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                 ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; i++) res += a[i];
    return res;
  }
  size_t n2 = n / 2;
  n2 -= n2 % 8;
  return np_pairwise_sum(a, n2) + np_pairwise_sum(a + n2, n - n2);
}

/* choose_distance_params over the explicit distances d[0..n) */
static void choose_dist_params(const uint32_t* d, size_t n, int* npostfix,
                               int* ndirect) {
  *npostfix = 0;
  *ndirect = 0;
  if (n == 0) return;
  size_t step = 1;
  double scale = 1.0;
  if (n > DIST_SAMPLE) {
    step = n / DIST_SAMPLE + 1;
    scale = (double)step;
  }
  uint32_t freq[NUM_DIST_FONT];
  double terms[NUM_DIST_FONT];
  double best_cost = 0.0;
  int have = 0;
  for (int np = 0; np <= DIST_MAX_NPOSTFIX; np++) {
    for (int msb = 0; msb < 16; msb++) {
      const int nd = msb << np;
      const int alpha = dist_alphabet(np, nd);
      memset(freq, 0, sizeof(uint32_t) * (size_t)alpha);
      int64_t bits = 0, total = 0;
      for (size_t i = 0; i < n; i += step) {
        uint16_t code;
        uint32_t extra;
        uint8_t nb;
        dist_code(d[i], np, nd, &code, &extra, &nb);
        freq[code]++;
        bits += nb;
        total++;
      }
      int used = 0;
      for (int s = 0; s < alpha; s++)
        if (freq[s]) {
          terms[used++] = (double)freq[s] * log2((double)freq[s]);
        }
      const double entropy =
          (double)total * log2((double)total) -
          np_pairwise_sum(terms, (size_t)used);
      const double cost = (entropy + (double)bits) * scale + 10.0 * used;
      if (!have || cost < best_cost - 1e-9) {
        have = 1;
        best_cost = cost;
        *npostfix = np;
        *ndirect = nd;
      }
    }
  }
}

/* Before a metablock's histograms: with e->dist_search, choose its
   NPOSTFIX/NDIRECT from its explicit distances and code them again under
   the choice (e->npostfix, e->ndirect, e->dist_alpha), else keep 0/0;
   then count the metablock in e->stats. Returns 0 or EERR_ALLOC. */
static int dist_params_apply(Enc* e, const Cmd* cmds, size_t ncmd,
                             Plan* plan) {
  e->npostfix = 0;
  e->ndirect = 0;
  if (e->dist_search) {
    size_t nexp = 0;
    for (size_t i = 0; i < ncmd; i++)
      if (plan[i].has_dist && plan[i].dcode >= 16) nexp++;
    if (nexp) {
      uint32_t* d = (uint32_t*)malloc(sizeof(uint32_t) * nexp);
      if (!d) return EERR_ALLOC;
      size_t k = 0;
      for (size_t i = 0; i < ncmd; i++)
        if (plan[i].has_dist && plan[i].dcode >= 16) d[k++] = cmds[i].dist;
      choose_dist_params(d, nexp, &e->npostfix, &e->ndirect);
      free(d);
    }
    if (e->npostfix || e->ndirect) {
      for (size_t i = 0; i < ncmd; i++) {
        Plan* pl = &plan[i];
        if (pl->has_dist && pl->dcode >= 16)
          dist_code(cmds[i].dist, e->npostfix, e->ndirect, &pl->dcode,
                    &pl->dextra, &pl->dbits);
      }
    }
    e->dist_alpha = dist_alphabet(e->npostfix, e->ndirect);
  }
  e->stats[DSTAT_METABLOCKS]++;
  e->stats[DSTAT_PARAMS] += (e->npostfix || e->ndirect);
  for (size_t i = 0; i < ncmd; i++)
    if (plan[i].has_dist && plan[i].dcode >= 16) {
      e->stats[DSTAT_DISTS]++;
      e->stats[DSTAT_EXTRA_BITS] += plan[i].dbits;
    }
  return 0;
}
