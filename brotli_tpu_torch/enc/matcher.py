"""Match-array helpers of the device pipelines, copied from
brotli_tpu.enc.matcher: the serial extension of cap-hit matches, the
static-dictionary post-pass (native path only), metablock command
planning and boundary splitting.

Commands are (insert_len, copy_len, distance) with distance == 0 meaning
"final insert-only command".
"""

import numpy as np

from .. import native

MIN_MATCH = 4


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


def _extend_capped(data, m, lens, dists, flags, cap, max_match):
    """Serially extend LZ matches that hit the parallel cap, dropping
    later matches they swallow. Dictionary matches (flags != 0) are
    exact and never extended. Iterations ~ number of cap-hit matches."""
    n = len(data)
    caphit = (lens >= cap) & (flags == 0)
    if len(m) == 0 or not np.any(caphit):
        return m, lens, dists, flags
    out = ([], [], [], [])
    i = 0
    nm = len(m)
    hit_idx = np.flatnonzero(caphit)
    while i < nm:
        hi = np.searchsorted(hit_idx, i)
        nxt_hit = int(hit_idx[hi]) if hi < len(hit_idx) else nm
        if nxt_hit > i:  # bulk-copy the run of uncapped matches
            for o, a in zip(out, (m, lens, dists, flags)):
                o.append(a[i:nxt_hit])
            i = nxt_hit
            continue
        p, d = int(m[i]), int(dists[i])
        ln = cap + _match_len(data, p - d + cap, p + cap,
                              min(max_match, n - p) - cap)
        for o, v in zip(out, (p, ln, d, 0)):
            o.append(np.array([v]))
        # skip matches swallowed by the extension
        i = int(np.searchsorted(m, p + ln, side="left"))
    return tuple(np.concatenate(o).astype(np.int64) for o in out)


def add_dictionary_matches(data, m, lens, dists, flags, max_distance,
                           base: int = 0, active_from: int = 0):
    """Post-pass: probe the static dictionary in the literal gaps of an
    existing parse and insert non-overlapping word references, in one
    O(n) native pass (btpu_dict_post).

    `base` is the absolute stream offset of `data` (decode-time
    max_distance depends on absolute position). `active_from`: skip
    positions before it (window-history prefix of a segment buffer).
    The JAX package takes a numpy pass below 16 KiB; the device
    pipeline always passes at least one 64 KiB metablock.
    """
    if len(data) < (1 << 14):
        raise NotImplementedError(
            "dictionary post-pass below 16 KiB (ROADMAP M13)")
    dp_, dl_, dd_, df_ = native.dict_post(
        np.ascontiguousarray(data).tobytes(), m, lens, max_distance, base,
        active_from)
    if len(dp_) == 0:
        return m, lens, dists, flags
    nm = np.concatenate([m, dp_])
    nl = np.concatenate([lens, dl_])
    nd = np.concatenate([dists, dd_])
    nf = np.concatenate([flags, df_])
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
