/* Cap-hit extension of a parse whose match lengths were capped (the
 * device matcher's K2 and the host batch matcher stop at `cap` bytes):
 * the host post-pass behind enc/matcher._extend_capped.
 *
 * One forward pass over the position-sorted match list. A match that is
 * not a cap hit is copied. A cap hit (lens >= cap, flags == 0; dictionary
 * matches are exact) at p with distance d is extended by comparing the
 * input from p + cap against p - d + cap, byte by byte, up to
 * room = min(max_match, n - p) - cap; overlapping copies (d < the
 * length) compare the input as it stands. The matches it now covers are
 * dropped. No two extensions overlap, so the pass is linear in the
 * input. The result is bit-equal to the JAX package's Python loop
 * (brotli_tpu/enc/matcher._extend_capped), including a room of 0 or
 * less, where the length becomes cap + room.
 *
 * Build: with btpu_dec.c and btpu_enc.c into libbtpu.so (native/__init__).
 */

#include <stddef.h>
#include <stdint.h>

/* Writes the extended list to om/ol/od/of (at most nm entries each) and
   its length to *n_out. Returns how many cap hits were extended, or -1
   when a cap hit's compare would read outside data[0, n). */
int64_t btpu_extend_capped(const uint8_t* data, size_t n,
                           const int64_t* m, const int64_t* lens,
                           const int64_t* dists, const int64_t* flags,
                           size_t nm, int64_t cap, int64_t max_match,
                           int64_t* om, int64_t* ol, int64_t* od,
                           int64_t* of, size_t* n_out) {
  const int64_t nn = (int64_t)n;
  size_t i = 0, k = 0;
  int64_t extended = 0;
  while (i < nm) {
    if (lens[i] < cap || flags[i] != 0) {
      om[k] = m[i];
      ol[k] = lens[i];
      od[k] = dists[i];
      of[k] = flags[i];
      k++;
      i++;
      continue;
    }
    const int64_t p = m[i], d = dists[i];
    const int64_t room = (max_match < nn - p ? max_match : nn - p) - cap;
    int64_t ln = room;
    if (room > 0) {
      const int64_t a = p - d + cap, b = p + cap;
      if (a < 0 || a + room > nn) return -1;
      const uint8_t* x = data + a;
      const uint8_t* y = data + b;
      ln = 0;
      while (ln < room && x[ln] == y[ln]) ln++;
    }
    ln += cap;
    om[k] = p;
    ol[k] = ln;
    od[k] = d;
    of[k] = 0;
    k++;
    extended++;
    /* skip the matches the extension swallowed: the first match at or
       beyond p + ln, as searchsorted(side="left") finds it */
    const int64_t end = p + ln;
    for (i++; i < nm && m[i] < end; i++) {
    }
  }
  *n_out = k;
  return extended;
}
