/* The static-dictionary probe at one position, written once for the
 * host and the card: K12 (csrc/dict_probe.cu) runs it a thread a
 * position, and native/btpu_probe.c loops over it on the CPU, so the
 * CPU tests run the kernel's own code. It is btpu_enc.c's dict_probe at
 * level 3 and one iteration of btpu_dict_probe_all's loop after its
 * seed gate (the word-length gate, the 17-bit offset check and the
 * payload out_advance << 22 | wlen << 17 | dictoff), bit for bit: the
 * candidates are taken in the C loop's order, so DICT_TAKE's strict >
 * breaks ties the same way.
 *
 * The tables are those dict_index_init builds (the word buckets, the
 * omit-first buckets, the affix forms), exported as one image
 * (btpu_dict_index_export): a BttDictHead, then the arrays at its
 * offsets, each 16-byte aligned. The code is the subset of C that both
 * cc and nvcc compile; under nvcc every function is __host__
 * __device__.
 */

#ifndef BTT_DICT_PROBE_H
#define BTT_DICT_PROBE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define BTT_HD __host__ __device__ __forceinline__
#else
#define BTT_HD static inline
#endif

#define BTT_DICT_HBITS 15
#define BTT_DICT_HSIZE (1 << BTT_DICT_HBITS)
#define BTT_DICT_FORMS 121  /* transforms, so at most this many affix forms */
/* limits of K12's shared copies, which btpu_dict_index_export refuses
   an index beyond: the bytes past p a probe may read (K12 stages them
   past its tile) and the transform pool's bytes */
#define BTT_DICT_REACH 64
#define BTT_DICT_POOL 512

/* a word of a bucket (k = 0) or an omit-first form of one (k bytes
   omitted), as DictEntry and OmitEntry hold them */
typedef struct {
  uint32_t word_off;
  uint16_t idx;
  uint8_t len;
  uint8_t k;
} BttWord;

/* an affix form, as AffixTf holds it */
typedef struct {
  uint8_t tid, uc, plen, slen;
  uint16_t poff, soff;
} BttAffix;

typedef struct {
  uint32_t size;  /* bytes of the whole image */
  /* byte offsets from the image's start */
  uint32_t start, of_start, entries, of_entries, suf, pre, pre_start,
      size_bits, pool, blob;
  uint32_t n_entries, n_of_entries, pool_len, blob_len;
  int32_t nsuf, npre, uc_first_id, uc_all_id;
  int32_t omit_last_id[10], omit_first_id[10];
  uint32_t reach; /* the most bytes from p that any form reads */
  uint32_t pad[3];
} BttDictHead;

/* pointers into an image, or (on the card) into shared copies of its
   small tables */
typedef struct {
  const uint32_t* start;
  const uint32_t* of_start;
  const BttWord* entries;
  const BttWord* of_entries;
  const BttAffix* suf;
  const BttAffix* pre;
  const uint8_t* pre_start;
  const uint8_t* size_bits;
  const uint8_t* pool;
  const uint8_t* blob;
  const int32_t* omit_last_id;
  const int32_t* omit_first_id;
  int nsuf, npre, uc_first_id, uc_all_id;
} BttDict;

BTT_HD BttDict btt_dict_view(const uint8_t* img) {
  const BttDictHead* h = (const BttDictHead*)img;
  BttDict d;
  d.start = (const uint32_t*)(img + h->start);
  d.of_start = (const uint32_t*)(img + h->of_start);
  d.entries = (const BttWord*)(img + h->entries);
  d.of_entries = (const BttWord*)(img + h->of_entries);
  d.suf = (const BttAffix*)(img + h->suf);
  d.pre = (const BttAffix*)(img + h->pre);
  d.pre_start = img + h->pre_start;
  d.size_bits = img + h->size_bits;
  d.pool = img + h->pool;
  d.blob = img + h->blob;
  d.omit_last_id = h->omit_last_id;
  d.omit_first_id = h->omit_first_id;
  d.nsuf = h->nsuf;
  d.npre = h->npre;
  d.uc_first_id = h->uc_first_id;
  d.uc_all_id = h->uc_all_id;
  return d;
}

BTT_HD uint32_t btt_hash4(const uint8_t* p) {
  uint32_t v = (uint32_t)p[0] | (uint32_t)p[1] << 8 |
               (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
  return (v * 0x9E3779B1u) >> (32 - BTT_DICT_HBITS);
}

/* common_len: the length of the common prefix, up to max */
BTT_HD size_t btt_common(const uint8_t* a, const uint8_t* b, size_t max) {
  size_t i = 0;
  while (i < max && a[i] == b[i]) i++;
  return i;
}

BTT_HD int btt_same(const uint8_t* a, const uint8_t* b, int len) {
  for (int i = 0; i < len; i++)
    if (a[i] != b[i]) return 0;
  return 1;
}

/* whether p[0, L) is word w in ASCII upper case (a byte >= 0xC0, which
   the RFC's ToUpperCase rewrites with the rune's tail, never matches) */
BTT_HD int btt_upper_all(const uint8_t* p, const uint8_t* w, int L) {
  for (int b = 0; b < L; b++) {
    uint8_t c = w[b];
    if (c >= 0xC0) return 0;
    uint8_t up = (uint8_t)(c >= 'a' && c <= 'z' ? c - 32 : c);
    if (p[b] != up) return 0;
  }
  return 1;
}

/* dict_probe(data, pos, n, min_out, 3, ...) of btpu_enc.c with p =
   data + pos and rem = n - pos >= 4: the output length (0 = none), its
   transform id, word index and word length. */
BTT_HD int btt_dict_probe(const BttDict* D, const uint8_t* p, size_t rem,
                          int min_out, int* out_tid, uint32_t* out_idx,
                          int* out_wlen) {
  int best_out = 0, best_tid = 0, best_wlen = 0, best_score = 0;
  uint32_t best_idx = 0;
#define BTT_TAKE(out_, score_, tid_, idx_, wlen_)                      \
  do {                                                                 \
    if ((out_) >= min_out && (score_) > best_score) {                  \
      best_score = (score_);                                           \
      best_out = (out_);                                               \
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
        if (D->uc_first_id < 0) break;
        key[0] = (uint8_t)(first | 0x20);
        key[1] = p[1];
        key[2] = p[2];
        key[3] = p[3];
      } else {
        if (D->uc_all_id < 0) break;
        if (!(p[1] >= 'A' && p[1] <= 'Z')) break;
        for (int b = 0; b < 4; b++)
          key[b] = (uint8_t)(p[b] >= 'A' && p[b] <= 'Z' ? p[b] | 0x20
                                                        : p[b]);
      }
    }
    uint32_t h = btt_hash4(tf ? key : p);
    uint32_t lo = D->start[h], hi = D->start[h + 1];
    for (uint32_t e = lo; e < hi; e++) {
      const BttWord de = D->entries[e];
      const uint8_t* w = D->blob + de.word_off;
      int L = de.len;
      if (tf == 1) {
        if (w[0] != key[0]) continue;
        size_t m1 = 1 + btt_common(p + 1, w + 1,
                                   (rem < (size_t)L ? rem : (size_t)L) - 1);
        if ((int)m1 != L) continue;
        BTT_TAKE(L, L * 128 - 140, D->uc_first_id, de.idx, L);
        for (int s = 0; s < D->nsuf; s++) {
          const BttAffix a = D->suf[s];
          if (a.uc != 1) continue;
          int out = L + a.slen;
          if ((size_t)out > rem) continue;
          if (!btt_same(p + L, D->pool + a.soff, a.slen)) continue;
          BTT_TAKE(out, out * 128 - 170, a.tid, de.idx, L);
        }
        continue;
      }
      if (tf == 2) {
        if ((size_t)L > rem) continue;
        if (!btt_upper_all(p, w, L)) continue;
        BTT_TAKE(L, L * 128 - 170, D->uc_all_id, de.idx, L);
        for (int s = 0; s < D->nsuf; s++) {
          const BttAffix a = D->suf[s];
          if (a.uc != 2) continue;
          int out = L + a.slen;
          if ((size_t)out > rem) continue;
          if (!btt_same(p + L, D->pool + a.soff, a.slen)) continue;
          BTT_TAKE(out, out * 128 - 190, a.tid, de.idx, L);
        }
        continue;
      }
      size_t cap = rem < (size_t)L ? rem : (size_t)L;
      size_t m = btt_common(p, w, cap);
      if ((int)m == L) {
        BTT_TAKE(L, L * 128, 0, de.idx, L);
        for (int s = 0; s < D->nsuf; s++) {
          const BttAffix a = D->suf[s];
          if (a.uc != 0) continue;
          int out = L + a.slen;
          if ((size_t)out > rem) continue;
          if (!btt_same(p + L, D->pool + a.soff, a.slen)) continue;
          BTT_TAKE(out, out * 128 - 150, a.tid, de.idx, L);
        }
      } else if ((int)m >= min_out && m >= 6 && L - (int)m <= 9 &&
                 D->omit_last_id[L - (int)m] >= 0) {
        BTT_TAKE((int)m, (int)m * 128 - 160, D->omit_last_id[L - (int)m],
                 de.idx, L);
      }
    }
  }
  /* prefix forms: the input starts with the form's literal prefix and
     the word follows it at q (" the " + word, " " + word, ...); the
     bucket of the word at q is scanned once a form */
  {
    const int s0 = D->pre_start[p[0]];
    const int s1 = D->pre_start[(int)p[0] + 1];
    for (int s = s0; s < s1; s++) {
      const BttAffix a = D->pre[s];
      if ((size_t)a.plen + 4 > rem) continue;
      if (!btt_same(p, D->pool + a.poff, a.plen)) continue;
      const uint8_t* q = p + a.plen;
      uint8_t key[4];
      if (a.uc == 1) {
        if (q[0] < 'A' || q[0] > 'Z') continue;
        key[0] = (uint8_t)(q[0] | 0x20);
        key[1] = q[1];
        key[2] = q[2];
        key[3] = q[3];
      } else if (a.uc == 2) {
        if (q[0] < 'A' || q[0] > 'Z') continue;
        for (int b = 0; b < 4; b++)
          key[b] = (uint8_t)(q[b] >= 'A' && q[b] <= 'Z' ? q[b] | 0x20
                                                        : q[b]);
      }
      const uint32_t h = btt_hash4(a.uc ? key : q);
      const size_t qrem = rem - a.plen;
      const uint32_t lo = D->start[h], hi = D->start[h + 1];
      for (uint32_t e = lo; e < hi; e++) {
        const BttWord de = D->entries[e];
        const uint8_t* w = D->blob + de.word_off;
        const int L = de.len;
        if ((size_t)L + a.slen > qrem) continue;
        if (a.uc == 1) {
          if (w[0] != key[0]) continue;
          if (1 + btt_common(q + 1, w + 1, (size_t)L - 1) != (size_t)L)
            continue;
        } else if (a.uc == 2) {
          if (!btt_upper_all(q, w, L)) continue;
        } else {
          if (btt_common(q, w, (size_t)L) != (size_t)L) continue;
        }
        if (a.slen && !btt_same(q + L, D->pool + a.soff, a.slen)) continue;
        const int out = a.plen + L + a.slen;
        BTT_TAKE(out, out * 128 - 160, a.tid, de.idx, L);
      }
    }
  }
  /* omit-first forms, bucketed by the post-omit 4-byte prefix */
  {
    uint32_t h = btt_hash4(p);
    uint32_t lo = D->of_start[h], hi = D->of_start[h + 1];
    for (uint32_t e = lo; e < hi; e++) {
      const BttWord oe = D->of_entries[e];
      int out = oe.len - oe.k;
      if ((size_t)out > rem) continue;
      const uint8_t* w = D->blob + oe.word_off + oe.k;
      if (btt_common(p, w, (size_t)out) != (size_t)out) continue;
      BTT_TAKE(out, out * 128 - 160, D->omit_first_id[oe.k], oe.idx,
               oe.len);
    }
  }
#undef BTT_TAKE
  if (!best_out) return 0;
  *out_tid = best_tid;
  *out_idx = best_idx;
  *out_wlen = best_wlen;
  return best_out;
}

/* btpu_dict_probe_all's loop body at position pos of n (pos + 4 <= n,
   not gated), p = data + pos: the payload out_advance << 22 | wlen << 17
   | dictoff of the hit, or 0 for none (a hit's out_advance is at least
   5, so a payload is never 0). */
BTT_HD uint32_t btt_dict_probe_at(const BttDict* D, const uint8_t* p,
                                  uint64_t pos, uint64_t n, uint64_t base,
                                  uint64_t maxback) {
  uint64_t maxd = pos + base < maxback ? pos + base : maxback;
  int gate = maxd + 1 >= (1u << 18) ? 7 : maxd + 1 >= (1u << 12) ? 6 : 5;
  int tid = 0, wlen = 0;
  uint32_t idx = 0;
  int dout = btt_dict_probe(D, p, (size_t)(n - pos), gate, &tid, &idx,
                            &wlen);
  if (dout < gate) return 0;
  uint32_t off = ((uint32_t)tid << D->size_bits[wlen]) + idx;
  if (off >= (1u << 17)) return 0;
  return (uint32_t)dout << 22 | (uint32_t)wlen << 17 | off;
}

/* The seed gate: whether pos lies in one of the ngate sorted, disjoint
   intervals [lo[i], hi[i]) (native.probe_gates derives them from a
   seed parse as btpu_dict_probe_all's walk skips positions). */
BTT_HD int btt_gated(const uint32_t* lo, const uint32_t* hi, uint32_t ngate,
                     uint32_t pos) {
  uint32_t a = 0, b = ngate;
  while (a < b) {
    uint32_t m = (a + b) >> 1;
    if (lo[m] <= pos)
      a = m + 1;
    else
      b = m;
  }
  return a > 0 && pos < hi[a - 1];
}

#endif
