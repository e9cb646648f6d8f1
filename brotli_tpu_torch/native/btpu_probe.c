/* The static-dictionary probe's tables for the card, and the probe of
 * csrc/dict_probe.h run on the host.
 *
 * btpu_dict_index_export copies the tables dict_index_init builds (the
 * word buckets, the omit-first buckets, the affix forms, the transform
 * pool and the dictionary's bytes: 1.2 MB) into one image that K12
 * (csrc/dict_probe.cu) reads on the card. btpu_dict_probe_gated loops
 * csrc/dict_probe.h's per-position probe over an input on the CPU: the
 * same code K12 runs a thread a position, held against
 * btpu_dict_probe_all by the CPU tests.
 *
 * dict_index_init and g_dict are static in btpu_enc.c, which stays a
 * verbatim copy: this file includes btpu_history.c, which includes
 * btpu_enc.c, and the library compiles the three through this file
 * only (native/__init__._SRCS).
 */

#include "btpu_history.c"

#include "../csrc/dict_probe.h"

static size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

/* The image's size in bytes, or 0 when the index cannot be built or
   exceeds the limits of csrc/dict_probe.h; the image is written to
   `out` only when `cap` holds it. */
size_t btpu_dict_index_export(const uint8_t* dict_blob, uint8_t* out,
                              size_t cap) {
  if (dict_index_init(dict_blob)) return 0;
  size_t n_ent = g_dict.start[DICT_HSIZE];
  size_t n_of = g_dict.of_start[DICT_HSIZE];
  BttDictHead h;
  memset(&h, 0, sizeof(h));
  size_t at = align16(sizeof(h));
  h.start = (uint32_t)at;
  at = align16(at + sizeof(uint32_t) * (DICT_HSIZE + 1));
  h.of_start = (uint32_t)at;
  at = align16(at + sizeof(uint32_t) * (DICT_HSIZE + 1));
  h.entries = (uint32_t)at;
  at = align16(at + sizeof(BttWord) * n_ent);
  h.of_entries = (uint32_t)at;
  at = align16(at + sizeof(BttWord) * n_of);
  h.suf = (uint32_t)at;
  at = align16(at + sizeof(BttAffix) * BTT_DICT_FORMS);
  h.pre = (uint32_t)at;
  at = align16(at + sizeof(BttAffix) * BTT_DICT_FORMS);
  h.pre_start = (uint32_t)at;
  at = align16(at + 257);
  h.size_bits = (uint32_t)at;
  at = align16(at + sizeof(kDictSizeBits));
  h.pool = (uint32_t)at;
  at = align16(at + sizeof(kTransformPool));
  h.blob = (uint32_t)at;
  at = align16(at + kDictOffsets[25]);
  h.size = (uint32_t)at;
  h.n_entries = (uint32_t)n_ent;
  h.n_of_entries = (uint32_t)n_of;
  h.pool_len = (uint32_t)sizeof(kTransformPool);
  h.blob_len = kDictOffsets[25];
  h.nsuf = g_dict.nsuf;
  h.npre = g_dict.npre;
  h.uc_first_id = g_dict.uc_first_id;
  h.uc_all_id = g_dict.uc_all_id;
  memcpy(h.omit_last_id, g_dict.omit_last_id, sizeof(h.omit_last_id));
  memcpy(h.omit_first_id, g_dict.omit_first_id, sizeof(h.omit_first_id));
  int maxp = 0, maxs = 0;
  for (int i = 0; i < g_dict.npre; i++) {
    if (g_dict.pre[i].plen > maxp) maxp = g_dict.pre[i].plen;
    if (g_dict.pre[i].slen > maxs) maxs = g_dict.pre[i].slen;
  }
  for (int i = 0; i < g_dict.nsuf; i++)
    if (g_dict.suf[i].slen > maxs) maxs = g_dict.suf[i].slen;
  h.reach = (uint32_t)(maxp + 24 + maxs);
  if (h.reach > BTT_DICT_REACH || h.pool_len > BTT_DICT_POOL ||
      g_dict.nsuf > BTT_DICT_FORMS || g_dict.npre > BTT_DICT_FORMS)
    return 0;
  if (!out || cap < at) return at;

  memset(out, 0, at);
  memcpy(out, &h, sizeof(h));
  memcpy(out + h.start, g_dict.start, sizeof(uint32_t) * (DICT_HSIZE + 1));
  memcpy(out + h.of_start, g_dict.of_start,
         sizeof(uint32_t) * (DICT_HSIZE + 1));
  BttWord* w = (BttWord*)(out + h.entries);
  for (size_t i = 0; i < n_ent; i++) {
    w[i].word_off = g_dict.entries[i].word_off;
    w[i].idx = g_dict.entries[i].idx;
    w[i].len = g_dict.entries[i].len;
    w[i].k = 0;
  }
  w = (BttWord*)(out + h.of_entries);
  for (size_t i = 0; i < n_of; i++) {
    w[i].word_off = g_dict.of_entries[i].word_off;
    w[i].idx = g_dict.of_entries[i].idx;
    w[i].len = g_dict.of_entries[i].len;
    w[i].k = g_dict.of_entries[i].k;
  }
  const AffixTf* src[2] = {g_dict.suf, g_dict.pre};
  int cnt[2] = {g_dict.nsuf, g_dict.npre};
  BttAffix* dst[2] = {(BttAffix*)(out + h.suf), (BttAffix*)(out + h.pre)};
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < cnt[t]; i++) {
      dst[t][i].tid = src[t][i].tid;
      dst[t][i].uc = src[t][i].uc;
      dst[t][i].plen = src[t][i].plen;
      dst[t][i].slen = src[t][i].slen;
      dst[t][i].poff = src[t][i].poff;
      dst[t][i].soff = src[t][i].soff;
    }
  memcpy(out + h.pre_start, g_dict.pre_start, 257);
  memcpy(out + h.size_bits, kDictSizeBits, sizeof(kDictSizeBits));
  memcpy(out + h.pool, kTransformPool, sizeof(kTransformPool));
  memcpy(out + h.blob, g_dict.blob, kDictOffsets[25]);
  return at;
}

/* The positions btpu_dict_probe_all's seed walk skips, as sorted,
   disjoint intervals [glo[k], ghi[k]) (at most nmatch; returns their
   count). At p the walk looks at the first seed in array order that
   ends after p, and skips p when that seed starts at or before p and is
   12 or longer: so a seed whose end passes every earlier seed's gates
   [max(its start, the earlier ends), its end). Positions and lengths
   are read as the walk reads them, as uint32. */
size_t btpu_probe_gates(const int64_t* mpos, const int64_t* mlen,
                        size_t nmatch, uint32_t* glo, uint32_t* ghi) {
  uint64_t before = 0; /* the largest end of the seeds so far */
  size_t k = 0;
  for (size_t i = 0; i < nmatch; i++) {
    uint64_t p = (uint32_t)mpos[i], len = (uint32_t)mlen[i], e = p + len;
    if (e <= before) continue;
    if (len >= 12) {
      glo[k] = (uint32_t)(p > before ? p : before);
      ghi[k] = e > 0xFFFFFFFFu ? 0xFFFFFFFFu : (uint32_t)e;
      k++;
    }
    before = e;
  }
  return k;
}

/* btpu_dict_probe_all's contract with its seed walk replaced by the
   gate intervals [glo[i], ghi[i]) (sorted, disjoint), over the image's
   tables: the hits' positions and payloads in position order; more
   than `cap` hits return EERR_PARAM. */
int btpu_dict_probe_gated(const uint8_t* data, size_t n, size_t base,
                          size_t maxback, const uint8_t* image,
                          const uint32_t* glo, const uint32_t* ghi,
                          size_t ngate, uint32_t* out_pos,
                          uint32_t* out_payload, size_t cap,
                          size_t* out_cnt) {
  *out_cnt = 0;
  if (n >= ((size_t)1 << 32)) return EERR_PARAM;
  BttDict d = btt_dict_view(image);
  size_t cnt = 0;
  for (size_t p = 0; p + 4 <= n; p++) {
    if (btt_gated(glo, ghi, (uint32_t)ngate, (uint32_t)p)) continue;
    uint32_t pay = btt_dict_probe_at(&d, data + p, p, n, base, maxback);
    if (!pay) continue;
    if (cnt >= cap) return EERR_PARAM;
    out_pos[cnt] = (uint32_t)p;
    out_payload[cnt] = pay;
    cnt++;
  }
  *out_cnt = cnt;
  return 0;
}
