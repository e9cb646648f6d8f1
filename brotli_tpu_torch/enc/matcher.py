"""LZ77 match finding, host path (copy of brotli_tpu.enc.matcher).

Vectorized-first design that mirrors the device matcher
(ops/matcher.py): rolling hashes and candidate discovery are batched
array ops; only final greedy parse runs serially. The hash is
multiplicative over 4-byte windows -- semantics equivalent to the
reference's H4/H5 family (c/enc/hash_longest_match_quickly_inc.h), not a
translation of it.

Commands are (insert_len, copy_len, distance) with distance == 0 meaning
"final insert-only command".
"""
import numpy as np

from .. import native
from ..utils import trace

MIN_MATCH = 4
HASH_MUL = np.uint32(0x1E35A7BD)


def hash4(data: np.ndarray, hash_bits: int) -> np.ndarray:
    """Multiplicative hash of every 4-byte window; shape (n-3,)."""
    d = data.astype(np.uint32)
    word = d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)
    return ((word * HASH_MUL) >> np.uint32(32 - hash_bits)).astype(np.int64)


def _match_len(data, a: int, b: int, max_len: int) -> int:
    """Common-prefix length of data[a:] vs data[b:], capped."""
    n = min(max_len, len(data) - b)
    ln = 0
    step = 64
    # geometric strides: long matches (megabytes on repetitive data)
    # cost O(log) numpy calls instead of O(len/64)
    while ln < n:
        step = min(step, n - ln)
        da = data[a + ln:a + ln + step]
        db = data[b + ln:b + ln + step]
        neq = np.flatnonzero(da != db)
        if len(neq):
            return ln + int(neq[0])
        ln += step
        step = min(step * 4, 1 << 20)
    return n


def distance_bit_cost(dists: np.ndarray, dist_len_table=None) -> np.ndarray:
    """Approximate bits to encode explicit distances (symbol + extras).
    With a first-pass distance code-length table the symbol cost is
    exact; otherwise a flat 6-bit symbol estimate is used."""
    d = np.maximum(dists.astype(np.int64), 1) + 3  # d = dist-1, +4
    # integer-exact bit_length(d) - 2
    nbits = np.zeros(len(d), np.int64)
    tmp = d >> 2
    while np.any(tmp):
        nbits += tmp > 0
        tmp >>= 1
    if dist_len_table is None:
        sym_bits = np.full(len(d), 6.0)
    else:
        half = (d - (np.int64(1) << (nbits + 1))) >> nbits
        dcode = 16 + (((nbits - 1) << 1) | half)
        dcode = np.clip(dcode, 0, len(dist_len_table) - 1)
        sym_bits = np.where(dist_len_table[dcode] > 0,
                            dist_len_table[dcode], 15).astype(np.float64)
    return sym_bits + nbits


def find_matches_costmodel(data: np.ndarray, max_distance: int,
                           hash_bits: int = 18, num_candidates: int = 4,
                           use_dict: bool = False, base: int = 0):
    """Two-pass cost-model parse (q10/11): a first greedy pass supplies
    literal and distance bit costs; the second pass picks candidates by
    estimated bit savings instead of raw length (the batched stand-in
    for the reference's zopfli DP, c/enc/backward_references_hq.c --
    iterated cost refinement rather than shortest-path, which is
    serial)."""
    m, lens, dists, flags = find_matches_vectorized(
        data, max_distance, hash_bits, num_candidates,
        use_dict=use_dict, base=base)
    if len(data) < (1 << 12):
        return m, lens, dists, flags
    # cost model from the first pass: literal bits from the pass-1
    # literal histogram, distance symbol bits from pass-1's code lengths
    covered = np.zeros(len(data) + 1, np.int64)
    np.add.at(covered, m, 1)
    np.add.at(covered, m + lens, -1)
    is_lit = np.cumsum(covered[:-1]) == 0
    lit_hist = np.bincount(data[is_lit], minlength=256) + 1
    lit_bits = -np.log2(lit_hist / lit_hist.sum())
    S = np.concatenate([[0.0], np.cumsum(lit_bits[data])])
    from .entropy import package_merge
    expl = flags == 0
    if np.any(expl):
        dcode = _dist_codes(dists[expl])
        dist_len = package_merge(np.bincount(dcode, minlength=64), 15)
    else:
        dist_len = None
    return find_matches_vectorized(
        data, max_distance, hash_bits, num_candidates,
        use_dict=use_dict, base=base, cost_model=(S, dist_len))


def _dist_codes(dists: np.ndarray) -> np.ndarray:
    d = dists.astype(np.int64) + 3
    nbits = np.zeros(len(d), np.int64)
    tmp = d >> 2
    while np.any(tmp):
        nbits += tmp > 0
        tmp >>= 1
    half = (d - (np.int64(1) << (nbits + 1))) >> nbits
    return np.clip(16 + (((nbits - 1) << 1) | half), 0, 63)


def find_matches_vectorized(data: np.ndarray, max_distance: int,
                            hash_bits: int = 18, num_candidates: int = 2,
                            max_match: int = 1 << 24,
                            use_dict: bool = False, base: int = 0,
                            cost_model=None):
    """Batch matcher: the NumPy reference of the TPU parse pipeline.

    1. rolling 4-byte hashes over every position (vector op)
    2. candidate discovery via stable sort by (hash, pos): the previous
       K entries in sort order are the K nearest earlier occurrences
    3. vectorized common-prefix match lengths (chunked compares)
    4. greedy parse as pointer-doubling reachability over next[i] =
       i + skip[i] -- O(n log n) parallel work, no serial scan
    Returns (ins, cpy, dist) int64 arrays.
    """
    n = len(data)
    z = np.zeros(0, np.int64)
    if n < 8:
        return z, z, z, z
    CAP = 16  # capped parallel match length; cap-hits extend serially
    npos = n - 3
    # 8-byte little-endian words at every position (vector build)
    w8 = np.zeros(n, np.uint64)
    for i in range(8):
        w8[:n - i] |= data[i:].astype(np.uint64) << np.uint64(8 * i)
    h = hash4(data, hash_bits)
    order = np.argsort(h, kind="stable").astype(np.int64)
    h_s = h[order]
    best_len = np.zeros(n, np.int32)
    best_dist = np.zeros(n, np.int64)
    best_score = np.full(n, -1e30) if cost_model is not None else None
    if cost_model is not None:
        S, dist_len_table = cost_model
        CMD_BITS = 10.0
    pos_idx = np.arange(npos, dtype=np.int64)
    for k in range(1, num_candidates + 1):
        cand = np.full(npos, -1, np.int64)
        same = h_s[k:] == h_s[:-k]
        cand[order[k:]] = np.where(same, order[:-k], -1)
        dist = pos_idx - cand
        valid = (cand >= 0) & (dist <= max_distance)
        c = np.where(valid, cand, 0)
        # two uint64 rounds -> match length in [0, 16]
        x0 = w8[pos_idx] ^ w8[c]
        l0 = _tz_bytes(x0)
        p1 = np.minimum(pos_idx + 8, n - 1)
        c1 = np.minimum(c + 8, n - 1)
        x1 = w8[p1] ^ w8[c1]
        mlen = np.where(x0 == 0, 8 + _tz_bytes(x1), l0).astype(np.int32)
        mlen = np.minimum(mlen, (n - 3 - pos_idx).clip(0) + 3)
        mlen = np.where(valid, mlen, 0)
        if cost_model is None:
            better = mlen > best_len[:npos]
        else:
            # estimated bit savings: literals replaced minus match cost
            gain = (S[np.minimum(pos_idx + mlen, n)] - S[pos_idx] -
                    distance_bit_cost(dist, dist_len_table) - CMD_BITS)
            gain = np.where(valid & (mlen >= MIN_MATCH), gain, -1e30)
            better = gain > best_score[:npos]
            best_score[:npos] = np.where(better, gain, best_score[:npos])
        best_len[:npos] = np.where(better, mlen, best_len[:npos])
        best_dist[:npos] = np.where(better, dist, best_dist[:npos])

    is_dict = np.zeros(n, bool)
    dict_wlen = np.zeros(n, np.int64)
    if use_dict:
        from . import static_dict
        cand_pos = np.flatnonzero(best_len[:npos] < 12)
        if len(cand_pos):
            dlen, dwlen, didx, dtr = static_dict.probe(data, cand_pos)
            ddist = static_dict.dict_distance(cand_pos + base, dwlen,
                                              didx, max_distance, dtr)
            gate = np.where(ddist >= (1 << 18), 7,
                            np.where(ddist >= (1 << 12), 6, 5))
            good = (dlen >= gate) & \
                (dlen > best_len[cand_pos].astype(np.int64) + 1)
            gp = cand_pos[good]
            best_len[gp] = dlen[good].astype(np.int32)
            best_dist[gp] = ddist[good]
            dict_wlen[gp] = dwlen[good]
            is_dict[gp] = True

    if cost_model is None:
        # score gate: longer minimum match for far distances (stand-in
        # for the reference's score model, c/enc/hash.h:73-120)
        min_len = np.where(best_dist >= (1 << 18), 6,
                           np.where(best_dist >= (1 << 12), 5, 4))
        min_len = np.where(is_dict, 4, min_len)  # dict already gated
        take = best_len >= np.maximum(min_len, MIN_MATCH)
        # lazy matching, vectorized: drop a match when the next position
        # has a strictly longer one (the 1-byte-lookahead deferral,
        # backward_references_inc.h cost_diff_lazy)
        nxt_len = np.concatenate([best_len[1:], [0]])
        nxt_take = np.concatenate([take[1:], [False]])
        take &= ~(nxt_take & (nxt_len > best_len + 1))
    else:
        take = (best_score > 0.5) | is_dict
        nxt_score = np.concatenate([best_score[1:], [-1e30]])
        nxt_take = np.concatenate([take[1:], [False]])
        lit0 = S[np.minimum(np.arange(n) + 1, n)] - S[np.arange(n)]
        take &= ~(nxt_take & (nxt_score > best_score + lit0) & ~is_dict)
    skip = np.where(take, best_len.astype(np.int64), 1)

    # pointer-doubling reachability from position 0
    nxt = np.minimum(np.arange(n, dtype=np.int64) + skip, n)
    jump = np.concatenate([nxt, [n]])
    reached = np.zeros(n + 1, bool)
    reached[0] = True
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    for _ in range(steps):
        tmp = np.zeros(n + 1, bool)
        tmp[jump[reached]] = True
        reached |= tmp
        jump = jump[jump]
    sel = np.flatnonzero(reached[:n])
    m = sel[take[sel]]
    lens = best_len[m].astype(np.int64)
    dists = best_dist[m]
    # flag >= 2 = static dict, no ring push; 2000 + word_len carries
    # the emitted copy code (the word's length bucket) since the
    # transformed output length may differ from it either way
    flags = np.where(is_dict[m], 2000 + dict_wlen[m], 0)
    return _extend_capped(data, m, lens, dists, flags, CAP, max_match)


def _tz_bytes(x: np.ndarray) -> np.ndarray:
    """Number of trailing zero BYTES of uint64 values (8 for x == 0)."""
    out = np.zeros(x.shape, np.int32)
    nz = x != 0
    low = (x & np.uint64(0xFFFFFFFF)) == 0
    v = np.where(low, x >> np.uint64(32), x)
    out += np.where(low, 4, 0).astype(np.int32)
    low16 = (v & np.uint64(0xFFFF)) == 0
    v = np.where(low16, v >> np.uint64(16), v)
    out += np.where(low16, 2, 0).astype(np.int32)
    low8 = (v & np.uint64(0xFF)) == 0
    out += np.where(low8, 1, 0).astype(np.int32)
    return np.where(nz, out, 8)


def _extend_capped(data, m, lens, dists, flags, cap, max_match):
    """Extend LZ matches that hit the parallel cap, dropping later
    matches they swallow, in one native pass (native.extend_capped).
    Dictionary matches (flags != 0) are exact and never extended.
    Counts the cap-hit matches passed in (match.extend.caphits) and
    those extended (match.extend.extensions; the rest were swallowed)."""
    nhit = int(np.count_nonzero((lens >= cap) & (flags == 0)))
    if len(m) == 0 or nhit == 0:
        return m, lens, dists, flags
    *out, extended = native.extend_capped(data, m, lens, dists, flags, cap,
                                          max_match)
    trace.count("match.extend.caphits", nhit)
    trace.count("match.extend.extensions", extended)
    return tuple(out)


def add_dictionary_matches(data, m, lens, dists, flags, max_distance,
                           base: int = 0, active_from: int = 0, *,
                           native_pass: bool = True):
    """Post-pass: probe the static dictionary in the literal gaps of an
    existing parse and insert non-overlapping word references.

    `base` is the absolute stream offset of `data` (decode-time
    max_distance depends on absolute position). `active_from`: skip
    positions before it (window-history prefix of a segment buffer).

    From 16 KiB on, one O(n) native pass (btpu_dict_post) probes the
    gaps with the same transform set; below it, where the native pass
    runs out of room, or with `native_pass=False` (the JAX package's
    BROTLI_TPU_NO_NATIVE_DICT), the numpy pass below.
    """
    if len(data) >= (1 << 14) and native_pass:
        try:
            found = native.dict_post(
                np.ascontiguousarray(data).tobytes(), m, lens,
                max_distance, base, active_from)
        except ValueError:
            # the native pass holds one word per 8 bytes of input; a
            # parse denser in words takes the numpy pass, as in the JAX
            # package
            found = None
        if found is not None:
            if len(found[0]) == 0:
                return m, lens, dists, flags
            nm, nl, nd, nf = (np.concatenate([a, f]) for a, f in
                              zip((m, lens, dists, flags), found))
            order = np.argsort(nm, kind="stable")
            return nm[order], nl[order], nd[order], nf[order]
    from . import static_dict
    n = len(data)
    covered = np.zeros(n + 1, np.int32)
    np.add.at(covered, m, 1)
    np.add.at(covered, m + lens, -1)
    in_gap = np.cumsum(covered[:n], dtype=np.int32) == 0
    in_gap[:active_from] = False
    in_gap[max(n - MIN_MATCH, 0):] = False
    cand = np.flatnonzero(in_gap)
    if len(cand) == 0:
        return m, lens, dists, flags
    dlen, dwlen, didx, dtr = static_dict.probe(data, cand)
    abs_pos = cand + base
    ddist = static_dict.dict_distance(abs_pos, dwlen, didx, max_distance,
                                      dtr)
    gate = np.where(ddist >= (1 << 18), 7,
                    np.where(ddist >= (1 << 12), 6, 5))
    # word must fit before the next LZ match
    if len(m):
        nxt = np.searchsorted(m, cand)
        gap_end = np.where(nxt < len(m), m[np.minimum(nxt, len(m) - 1)], n)
    else:
        gap_end = np.full(len(cand), n, np.int64)
    ok = (dlen >= gate) & (cand + dlen <= gap_end)
    hits = np.flatnonzero(ok)
    if len(hits) == 0:
        return m, lens, dists, flags
    # non-overlapping selection, vectorized: accept a hit iff it does
    # not overlap ANY earlier hit (slightly conservative vs the exact
    # greedy scan, but O(1) vector ops instead of a Python loop)
    hp = cand[hits]
    he = hp + dlen[hits]
    prev_end = np.maximum.accumulate(
        np.concatenate([[-1], he[:-1]]))
    sel = hits[hp >= prev_end]
    nm = np.concatenate([m, cand[sel]])
    nl = np.concatenate([lens, dlen[sel]])
    nd = np.concatenate([dists, ddist[sel]])
    nf = np.concatenate([flags, 2000 + dwlen[sel]])
    order = np.argsort(nm, kind="stable")
    return nm[order], nl[order], nd[order], nf[order]


def matches_to_commands(m, lens, dists, flags, lo: int, hi: int):
    """Commands for block [lo, hi) from non-overlapping sorted matches.

    Inserts are the gaps between consecutive matches; a trailing gap
    becomes a final insert-only command (cpy = dist = 0).
    """
    keep = (m >= lo) & (m + lens <= hi)
    m, lens, dists, flags = m[keep], lens[keep], dists[keep], flags[keep]
    prev_end = np.concatenate([[lo], m + lens])
    ins = m - prev_end[:-1]
    final_ins = hi - int(prev_end[-1]) if len(m) else hi - lo
    if final_ins > 0 or len(m) == 0:
        ins = np.concatenate([ins, [final_ins]])
        lens = np.concatenate([lens, [0]])
        dists = np.concatenate([dists, [0]])
        flags = np.concatenate([flags, [0]])
    return (ins.astype(np.int64), lens.astype(np.int64),
            dists.astype(np.int64), flags.astype(np.int64))


def split_matches_at(m, lens, dists, flags, boundaries):
    """Split LZ matches straddling block boundaries; pieces shorter
    than 2 are dropped (their bytes fall back to literals). Dictionary
    matches cannot split (word refs are atomic) -- they are dropped.

    One vectorized pass per crossing depth (a match spanning k blocks
    splits over ceil(log) rounds; in practice 1-2)."""
    m = np.asarray(m, np.int64)
    lens = np.asarray(lens, np.int64)
    dists = np.asarray(dists, np.int64)
    flags = np.asarray(flags, np.int64)
    bnd = np.asarray(boundaries[:-1], dtype=np.int64)
    while len(bnd) and len(m):
        # first boundary strictly inside each match (positions are
        # unique and sorted; at most one match crosses a boundary)
        bi = np.searchsorted(bnd, m, side="right")
        has = bi < len(bnd)
        b = bnd[np.minimum(bi, len(bnd) - 1)]
        cross = has & (m + lens > b)
        if not np.any(cross):
            break
        keep = ~cross
        lz = cross & (flags == 0)
        left = b - m
        right = lens - left
        lo_ok = lz & (left >= 2)
        hi_ok = lz & (right >= 2)
        parts = (
            (m[keep], lens[keep], dists[keep], flags[keep]),
            (m[lo_ok], left[lo_ok], dists[lo_ok], flags[lo_ok]),
            (b[hi_ok], right[hi_ok], dists[hi_ok], flags[hi_ok]),
        )
        m = np.concatenate([p[0] for p in parts])
        lens = np.concatenate([p[1] for p in parts])
        dists = np.concatenate([p[2] for p in parts])
        flags = np.concatenate([p[3] for p in parts])
        order = np.argsort(m, kind="stable")
        m, lens, dists, flags = (m[order], lens[order], dists[order],
                                 flags[order])
    return m, lens, dists, flags


def _batch_match_len(data, pos, cand, valid, cap, chunk=32):
    """Vectorized LCP of data[pos:] vs data[cand:], capped at `cap`."""
    n = len(data)
    npos = len(pos)
    mlen = np.zeros(npos, np.int64)
    active = valid.copy()
    offset = 0
    d64 = data
    while offset < cap and active.any():
        idx = np.flatnonzero(active)
        p = pos[idx] + offset
        c = cand[idx] + offset
        # stay in bounds: compare up to `chunk` bytes
        max_here = np.minimum(n - p, chunk)
        span = np.arange(chunk)
        pa = np.minimum(p[:, None] + span, n - 1)
        ca = np.minimum(c[:, None] + span, n - 1)
        eq = d64[pa] == d64[ca]
        eq &= span < max_here[:, None]
        # first mismatch within the chunk
        any_neq = ~eq.all(axis=1)
        first = np.where(any_neq, np.argmin(eq, axis=1), max_here)
        mlen[idx] += first
        full = (first == chunk) & (max_here == chunk)
        active[idx] = full
        offset += chunk
    return np.minimum(mlen, cap)


def find_matches_greedy(data: np.ndarray, max_distance: int,
                        hash_bits: int = 17, min_quality_len: int = 4):
    """Greedy single-probe serial matcher (simple oracle for tests).

    Returns (positions, lengths, distances) of non-overlapping matches.
    """
    n = len(data)
    out = []
    if n >= MIN_MATCH + 4:
        hashes = hash4(data, hash_bits)
        table = np.full(1 << hash_bits, -1, dtype=np.int64)
        pos = 0
        limit = n - MIN_MATCH
        while pos <= limit:
            h = hashes[pos]
            cand = table[h]
            table[h] = pos
            if cand >= 0 and pos - cand <= max_distance and \
                    data[cand] == data[pos] and \
                    data[cand + 1] == data[pos + 1] and \
                    data[cand + 2] == data[pos + 2] and \
                    data[cand + 3] == data[pos + 3]:
                ln = _match_len(data, cand, pos, n - pos)
                if ln >= min_quality_len:
                    out.append((pos, ln, pos - cand))
                    end = min(pos + ln, limit)
                    step = 1 if ln < 64 else 4
                    for p in range(pos + 1, end, step):
                        table[hashes[p]] = p
                    pos += ln
                    continue
            pos += 1
    if out:
        m, lens, dists = map(np.array, zip(*out))
    else:
        m = lens = dists = np.zeros(0, np.int64)
    return m.astype(np.int64), lens.astype(np.int64), dists.astype(np.int64)
