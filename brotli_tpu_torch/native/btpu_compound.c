/* Compound references: the region serializer (btpu_serialize) for a
 * parse whose matches may copy from a raw dictionary attached before
 * the stream (flag 1), as RFC 9842's dictionary-compressed brotli
 * (`dcb`) and upstream's `brotli -D FILE` write them.
 *
 * A reference at stream position p with distance d, where
 * maxd = min(p, maxback) < d <= maxd + dict_len, copies from the
 * dictionary at address dict_len - (d - maxd). The decoder pushes d onto
 * its distance ring as it does an LZ copy's distance and refuses a
 * copy that runs past the dictionary's end (decode.c
 * InitializeCompoundDictionaryCopy). In the bitstream such a reference
 * is therefore an LZ copy whose distance lies past the window, so this
 * pass checks each one and hands it on as flag 0; every other match
 * goes on as it is, and btpu_serialize judges its flag (1000..1999
 * still give EERR_PARAM). The literal contexts of the stream's first
 * bytes see no dictionary byte: `data_full` is the stream's input alone.
 *
 * btpu_serialize cuts an LZ copy that straddles its 4 MiB metablock grid
 * (lo + k * 4 MiB) and gives the right piece the same distance. For a
 * reference past the window that distance would name another byte once
 * p moves past maxback, so a reference is cut at the grid here, each
 * piece given the distance of its own first dictionary byte; a piece
 * shorter than 2 is left to literals.
 *
 * Build: with btpu_dec.c, btpu_enc.c and btpu_extend.c into libbtpu.so
 * (native/__init__).
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

#define CMP_EERR_ALLOC -3
#define CMP_EERR_PARAM -6
#define CMP_GRID ((size_t)1 << 22) /* btpu_serialize's metablock target */

int btpu_serialize(const uint8_t* data_full, size_t n, size_t lo,
                   size_t hi, int quality, int lgwin,
                   const uint32_t* mpos, const uint32_t* mlen,
                   const uint32_t* mdist, const uint32_t* mflag,
                   size_t nmatch, const uint32_t* ring_in,
                   int write_header, int is_last, int align_end,
                   uint8_t** out, size_t* out_len, uint32_t* ring_out,
                   int ctx_mode, int dist_search, uint64_t* stats,
                   int threads);

/* The distance of dictionary address `addr` from stream position p. */
static uint64_t compound_dist(uint64_t p, uint64_t maxback,
                              uint64_t dict_len, uint64_t addr) {
  return (p < maxback ? p : maxback) + (dict_len - addr);
}

/* As btpu_serialize, with `dict_len` bytes of raw dictionary before the
   stream and flag 1 for a reference into it. Returns EERR_PARAM for a
   flag-1 match whose distance is not a compound one at its position or
   whose copy runs past the dictionary's end, and for lgwin above 24. */
int btpu_serialize_compound(const uint8_t* data_full, size_t n, size_t lo,
                            size_t hi, int quality, int lgwin,
                            size_t dict_len, const uint32_t* mpos,
                            const uint32_t* mlen, const uint32_t* mdist,
                            const uint32_t* mflag, size_t nmatch,
                            const uint32_t* ring_in, int write_header,
                            int is_last, int align_end, uint8_t** out,
                            size_t* out_len, uint32_t* ring_out,
                            int ctx_mode, int dist_search,
                            uint64_t* stats, int threads) {
  if (lgwin < 10 || lgwin > 24 || lo >= hi) return CMP_EERR_PARAM;
  const uint64_t maxback = ((uint64_t)1 << lgwin) - 16;
  /* first pass: check every reference and count its pieces */
  size_t total = 0;
  for (size_t i = 0; i < nmatch; i++) {
    if (mflag[i] != 1) {
      total++;
      continue;
    }
    const uint64_t p = mpos[i], d = mdist[i], len = mlen[i];
    const uint64_t maxd = p < maxback ? p : maxback;
    if (d <= maxd || d - maxd > dict_len) return CMP_EERR_PARAM;
    if (len > d - maxd) return CMP_EERR_PARAM; /* past the end */
    const uint64_t end = p + len;
    total++;
    if (p >= lo && end > p)
      total += (end - 1 - lo) / CMP_GRID - (p - lo) / CMP_GRID;
  }
  uint32_t* buf = (uint32_t*)malloc(sizeof(uint32_t) * 4 * (total + 1));
  if (!buf) return CMP_EERR_ALLOC;
  uint32_t *op = buf, *ol = buf + total + 1, *od = ol + total + 1,
           *of = od + total + 1;
  size_t k = 0;
  for (size_t i = 0; i < nmatch; i++) {
    if (mflag[i] != 1) {
      op[k] = mpos[i];
      ol[k] = mlen[i];
      od[k] = mdist[i];
      of[k] = mflag[i];
      k++;
      continue;
    }
    const uint64_t p = mpos[i], len = mlen[i];
    const uint64_t maxd = p < maxback ? p : maxback;
    const uint64_t addr = dict_len - (mdist[i] - maxd);
    uint64_t at = p;
    while (at < p + len) {
      uint64_t cut = p + len;
      if (at >= lo) {
        const uint64_t line = lo + ((at - lo) / CMP_GRID + 1) * CMP_GRID;
        if (line < cut) cut = line;
      }
      if (cut - at >= 2) {
        op[k] = (uint32_t)at;
        ol[k] = (uint32_t)(cut - at);
        od[k] = (uint32_t)compound_dist(at, maxback, dict_len,
                                        addr + (at - p));
        of[k] = 0;
        k++;
      }
      at = cut;
    }
  }
  int rc = btpu_serialize(data_full, n, lo, hi, quality, lgwin, op, ol, od,
                          of, k, ring_in, write_header, is_last, align_end,
                          out, out_len, ring_out, ctx_mode, dist_search,
                          stats, threads);
  free(buf);
  return rc;
}
