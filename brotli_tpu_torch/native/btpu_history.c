/* The seed parse of an input that follows a history it may copy from:
 * a raw dictionary laid before the input (RFC 9842's `dcb`, the port's
 * ops/optimal._seed_parse_dcb). The history's positions are only
 * indexed, as upstream's BrotliEncoderPrepareDictionary hashes a
 * dictionary without parsing it; the input after it is parsed exactly
 * as btpu_find_matches parses a buffer, so its matches reach back into
 * the history. On a dictionary of 3.46 MB before 2.84 MB of input
 * (trace_viewer_index.js of the benchmark's `versions` traffic, one x86
 * core) parsing both takes 0.195 s, 0.19 s of it on the dictionary;
 * indexing the dictionary and parsing the input takes 0.051 s.
 *
 * The matcher's functions are static in btpu_enc.c, which stays a
 * verbatim copy: this file includes it, and the library compiles
 * btpu_enc.c through this file only, which btpu_probe.c includes in
 * turn (native/__init__._SRCS).
 */

#include "btpu_enc.c"

/* As btpu_find_matches over raw[0, n), but positions below `start` are
   indexed and never searched: the matches start at `start` or later
   (positions are raw's). out_* hold at least (n - start) / 4 + 16. */
int btpu_find_matches_after(const uint8_t* raw, size_t n, size_t start,
                            int quality, int lgwin, uint32_t* out_pos,
                            uint32_t* out_len, uint32_t* out_dist,
                            size_t cap, size_t* out_cnt) {
  if (quality < 0 || quality > 9 || lgwin < 10 || lgwin > 24 ||
      start >= n)
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
  for (size_t p = 0; p < start; p++) insert_hash(data, p, &cfg);
  /* from here, btpu_find_matches's loop */
  size_t pos = start, cnt = 0, miss_run = 0;
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
