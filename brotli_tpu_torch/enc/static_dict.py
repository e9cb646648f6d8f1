"""Encoder-side static dictionary matching over the FULL transform set
(copy of brotli_tpu.enc.static_dict).

A sorted (4-byte-prefix, length, index) table over all 13,504 RFC
Appendix A words supports fully vectorized probing: positions gather
their 4-byte word, binary-search the table, and verify whole-word
equality with batched byte compares. On top of the base-word match,
the full RFC Appendix B transform repertoire is composed table-driven:
prefix/suffix forms (identity, uppercase-first, uppercase-all variants
with their prefixes and suffixes), omit-last cutoffs (with suffixes),
and omit-first forms via auxiliary shifted-key tables.

Re-design of the reference's generated bucket LUT + hand-written
suffix if-chain (c/enc/static_dict.c:36-335, static_dict_lut.c,
dictionary_hash.c) -- here every matching form is derived from the
normative transform table at import time, so the coverage is the
whole 121-transform set rather than a curated subset.
"""

from functools import lru_cache

import numpy as np

from ..format import constants as C
from ..format import dictionary as dict_mod
from ..format import transforms as tf

MAX_PROBE = 8  # candidates examined per position per key group

# legacy alias kept for external callers/tests
UPPERCASE_FIRST_ID = 9

# omit-last-k identity transforms by cutoff length (parity:
# kCutoffTransforms, c/enc/hash.h:67-70 / static_dict.c:130-133)
CUTOFF_TRANSFORM_IDS = np.array(tf.CUTOFF_TRANSFORMS, np.int64)

_VARIANTS = {"IDENTITY": 0, "UPPERCASE_FIRST": 1, "UPPERCASE_ALL": 2}


def _transform_groups():
    """Parse TRANSFORMS into vectorizable match groups.

    Returns (prefix_groups, omit_last, omit_first):
      prefix_groups: {(variant, prefix): [(tid, suffix), ...]}
      omit_last:     [(tid, k, suffix), ...]   (identity body, no prefix)
      omit_first:    [(tid, k), ...]           (identity body, bare)
    """
    prefix_groups = {}
    omit_last, omit_first = [], []
    for tid, (pre, op, suf) in enumerate(tf.TRANSFORMS):
        if op in _VARIANTS:
            key = (_VARIANTS[op], pre)
            prefix_groups.setdefault(key, []).append((tid, suf))
        elif op.startswith("OMIT_LAST_"):
            assert pre == b""
            omit_last.append((tid, int(op[10:]), suf))
        else:
            assert op.startswith("OMIT_FIRST_") and pre == b"" \
                and suf == b""
            omit_first.append((tid, int(op[11:])))
    return prefix_groups, omit_last, omit_first


_PREFIX_GROUPS, _OMIT_LAST, _OMIT_FIRST = _transform_groups()


@lru_cache(maxsize=1)
def _all_words():
    """(lens int16[N], words uint8[N, 24]) over every dictionary word,
    in (length-bucket, index) order."""
    blob = dict_mod.dictionary_array()
    lens, mats, idxs = [], [], []
    for L in range(C.MIN_DICTIONARY_WORD_LENGTH,
                   C.MAX_DICTIONARY_WORD_LENGTH + 1):
        nbits = dict_mod.SIZE_BITS_BY_LENGTH[L]
        if nbits == 0:
            continue
        count = 1 << nbits
        off = dict_mod.OFFSETS_BY_LENGTH[L]
        words = blob[off:off + count * L].reshape(count, L)
        m = np.zeros((count, C.MAX_DICTIONARY_WORD_LENGTH), np.uint8)
        m[:, :L] = words
        mats.append(m)
        lens.append(np.full(count, L, np.int16))
        idxs.append(np.arange(count, dtype=np.int32))
    return (np.concatenate(lens), np.concatenate(mats),
            np.concatenate(idxs))


def _sorted_tables(words24: np.ndarray, lens: np.ndarray,
                   idxs: np.ndarray):
    """Sort rows by (first-4-byte key, -length); longest word first
    within a key group. Returns (keys u32, lens i16, idxs i32, mat)."""
    key = (words24[:, 0].astype(np.uint32)
           | words24[:, 1].astype(np.uint32) << 8
           | words24[:, 2].astype(np.uint32) << 16
           | words24[:, 3].astype(np.uint32) << 24)
    order = np.lexsort((-lens.astype(np.int32), key))
    out = (key[order], lens[order], idxs[order], words24[order])
    for a in out:
        a.setflags(write=False)
    return out


@lru_cache(maxsize=4)
def case_tables(variant: int):
    """Sorted probe tables for a case variant (0 identity, 1
    uppercase-first, 2 uppercase-all): rows hold the TRANSFORMED word
    bytes, so input windows compare directly against decode output."""
    lens, mat, idxs = _all_words()
    if variant == 0:
        return _sorted_tables(mat, lens, idxs)
    out = mat.copy()
    # vectorized ASCII fast path covers almost every word; rows with
    # any non-ASCII byte go through the exact rune-wise transform
    letters = (out >= 0x61) & (out <= 0x7A) & \
        (np.arange(24) < lens[:, None])
    ascii_rows = ~(out >= 0x80).any(axis=1)
    if variant == 1:
        flip = letters & (np.arange(24) == 0)
    else:
        flip = letters
    out[ascii_rows] ^= np.where(flip[ascii_rows], 32, 0).astype(np.uint8)
    hard = np.flatnonzero(~ascii_rows)
    op_tid = 9 if variant == 1 else 44  # bare ucfirst / ucall ids
    for r in hard:
        L = int(lens[r])
        w = tf.transform_word(mat[r, :L].tobytes(), op_tid)[:L]
        out[r, :L] = np.frombuffer(w.ljust(L, b"\0"), np.uint8)[:L]
    return _sorted_tables(out, lens, idxs)


@lru_cache(maxsize=16)
def omit_first_tables(k: int):
    """Sorted probe tables keyed on word[k:k+4]; rows hold the word
    SHIFTED left by k (the omit-first body). Words shorter than k+4
    are excluded (a 4-byte key is required)."""
    lens, mat, idxs = _all_words()
    keep = lens >= k + 4
    body = np.zeros_like(mat[keep])
    body[:, :24 - k] = mat[keep][:, k:]
    return _sorted_tables(body, (lens[keep] - k).astype(np.int16),
                          idxs[keep])


def _match_prefix_len(win: np.ndarray, mat: np.ndarray,
                      L: np.ndarray) -> np.ndarray:
    """Common-prefix length of each 24-byte input window vs its
    candidate word row, capped at the word length."""
    eq = (win == mat) | (np.arange(24) >= L[:, None])
    cp = np.argmin(eq, axis=1)
    return np.where(eq.all(axis=1), 24, cp)


class _Best:
    """Per-position best candidate: longest output, then smallest
    transform id (smaller ids sit lower in the distance address
    space, costing fewer distance extra bits)."""

    def __init__(self, n):
        self.out = np.zeros(n, np.int64)
        self.wlen = np.zeros(n, np.int64)
        self.idx = np.zeros(n, np.int64)
        self.tr = np.full(n, 1 << 30, np.int64)

    def update(self, rows, out, wlen, idx, tid):
        if len(rows) == 0:
            return
        cur_o, cur_t = self.out[rows], self.tr[rows]
        better = (out > cur_o) | ((out == cur_o) & (tid < cur_t))
        r = rows[better]
        self.out[r] = out[better] if np.ndim(out) else out
        self.wlen[r] = wlen[better]
        self.idx[r] = idx[better]
        self.tr[r] = tid


def probe(data: np.ndarray, positions: np.ndarray,
          max_probe: int = MAX_PROBE):
    """Vectorized full-transform dictionary probe.

    Returns per position (out_len, word_len, word_idx, transform):
    out_len is the transformed OUTPUT length (0 = no match), word_len
    the base word length (the command's copy code). Parity:
    BrotliFindAllStaticDictionaryMatches (c/enc/static_dict.c) -- but
    table-driven over all 121 transforms instead of a hand if-chain.
    """
    n = len(data)
    p = np.asarray(positions, np.int64)
    best = _Best(len(p))
    if n < 4 or len(p) == 0:
        z = np.zeros(len(p), np.int64)
        return z, z.copy(), z.copy(), z.copy()
    padded = np.concatenate([data, np.zeros(40, np.uint8)])

    for (variant, pre), tlist in _PREFIX_GROUPS.items():
        lp = len(pre)
        ok = p + lp + 4 <= n
        for j, b in enumerate(pre):
            ok &= padded[np.minimum(p + j, n)] == b
        sel = np.flatnonzero(ok)
        if len(sel) == 0:
            continue
        q = p[sel] + lp
        keys, lens_t, idxs_t, mat_t = case_tables(variant)
        w4 = (padded[q].astype(np.uint32)
              | padded[q + 1].astype(np.uint32) << 8
              | padded[q + 2].astype(np.uint32) << 16
              | padded[q + 3].astype(np.uint32) << 24)
        lo = np.searchsorted(keys, w4, side="left")
        hit = keys[np.minimum(lo, len(keys) - 1)] == w4
        sub = np.flatnonzero(hit)
        if len(sub) == 0:
            continue
        sel, q, lo, w4 = sel[sub], q[sub], lo[sub], w4[sub]
        win = padded[q[:, None] + np.arange(24)]
        remaining = n - q
        is_omit_group = variant == 0 and lp == 0
        for probe_i in range(max_probe):
            cand = np.minimum(lo + probe_i, len(keys) - 1)
            okc = keys[cand] == w4
            L = lens_t[cand].astype(np.int64)
            cp = _match_prefix_len(win, mat_t[cand], L)
            cp = np.minimum(cp, remaining)
            full = okc & (cp >= L)
            rows = np.flatnonzero(full)
            if len(rows):
                qL = q[rows] + L[rows]
                rem = n - qL
                for tid, suf in tlist:
                    ls = len(suf)
                    good = rem >= ls
                    for j, b in enumerate(suf):
                        good &= padded[np.minimum(qL + j, n)] == b
                    g = np.flatnonzero(good)
                    best.update(sel[rows[g]], lp + L[rows[g]] + ls,
                                L[rows[g]], idxs_t[cand[rows[g]]], tid)
            if is_omit_group:
                for tid, k, suf in _OMIT_LAST:
                    body = L - k
                    base_ok = okc & (body >= 2) & (cp >= body) & (k >= 1)
                    rows = np.flatnonzero(base_ok)
                    if len(rows) == 0:
                        continue
                    qB = q[rows] + body[rows]
                    ls = len(suf)
                    good = n - qB >= ls
                    for j, b in enumerate(suf):
                        good &= padded[np.minimum(qB + j, n)] == b
                    g = np.flatnonzero(good)
                    best.update(sel[rows[g]], body[rows[g]] + ls,
                                L[rows[g]], idxs_t[cand[rows[g]]], tid)

    # omit-first forms: separate tables keyed on word[k:k+4]
    ok0 = p + 4 <= n
    sel0 = np.flatnonzero(ok0)
    if len(sel0):
        q0 = p[sel0]
        w4_0 = (padded[q0].astype(np.uint32)
                | padded[q0 + 1].astype(np.uint32) << 8
                | padded[q0 + 2].astype(np.uint32) << 16
                | padded[q0 + 3].astype(np.uint32) << 24)
        win0 = None
        for tid, k in _OMIT_FIRST:
            keys, blens, idxs_t, mat_t = omit_first_tables(k)
            lo = np.searchsorted(keys, w4_0, side="left")
            hit = keys[np.minimum(lo, len(keys) - 1)] == w4_0
            sub = np.flatnonzero(hit)
            if len(sub) == 0:
                continue
            if win0 is None:
                win0 = padded[q0[:, None] + np.arange(24)]
            q, loh, w4h = q0[sub], lo[sub], w4_0[sub]
            rem = n - q
            for probe_i in range(max_probe):
                cand = np.minimum(loh + probe_i, len(keys) - 1)
                okc = keys[cand] == w4h
                B = blens[cand].astype(np.int64)
                cp = _match_prefix_len(win0[sub], mat_t[cand], B)
                full = okc & (np.minimum(cp, rem) >= B)
                rows = np.flatnonzero(full)
                best.update(sel0[sub[rows]], B[rows], B[rows] + k,
                            idxs_t[cand[rows]], tid)

    found = best.out > 0
    tr = np.where(found, best.tr, 0)
    return best.out, best.wlen, best.idx, tr


def dict_distance(pos, word_len, word_idx, max_backward, transform=0):
    """Stream distance encoding a dictionary reference at `pos`:
    distance = max_distance + 1 + (transform << nbits | word_idx)
    (RFC 8 address packing)."""
    nbits = np.asarray(dict_mod.SIZE_BITS_BY_LENGTH, np.int64)[
        np.clip(word_len, 0, C.MAX_DICTIONARY_WORD_LENGTH)]
    max_dist = np.minimum(pos, max_backward)
    return max_dist + 1 + (np.asarray(transform, np.int64) << nbits |
                           word_idx)
