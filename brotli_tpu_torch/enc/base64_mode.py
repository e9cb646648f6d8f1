"""Base64-region detection + flat-code forcing (1.2.0 feature; copy of
brotli_tpu.enc.base64_mode).

Role parity: BROTLI_PARAM_BASE64_MODE -- trigger scan in
c/enc/backward_references_inc.h:38-91 (the ";base64," trigger, region
extension over the base64 charset, '=' padding excluded), literal-split
forcing in c/enc/metablock.c:30-175, and the fixed 6-bit flat code per
base64 histogram in c/enc/block_encoder_inc.h:20-33.

Detection here is one vectorized pass (trigger match via shifted
compares, region extent via run-length arithmetic on the charset mask)
instead of the reference's per-position scan.
"""

import numpy as np

TRIGGER = b";base64,"
MAX_REGIONS = 16

_IS_B64 = np.zeros(256, bool)
for _c in (b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
           b"abcdefghijklmnopqrstuvwxyz0123456789+/"):
    _IS_B64[_c] = True


def base64_code_lengths() -> np.ndarray:
    """The forced flat literal code: 6 bits for each base64 char
    (exactly Kraft-complete), 0 elsewhere."""
    return np.where(_IS_B64, 6, 0).astype(np.int32)


def detect_regions(arr: np.ndarray, max_regions: int = MAX_REGIONS):
    """Find up to `max_regions` base64 payload regions.

    Returns (starts, lengths) int64 arrays: each region begins right
    after a ";base64," trigger and spans the maximal run of base64
    charset bytes (trailing '=' padding never enters a region since
    '=' is not in the charset)."""
    n = len(arr)
    t = len(TRIGGER)
    if n < t + 1:
        z = np.zeros(0, np.int64)
        return z, z
    hit = np.ones(n - t, bool)
    for i, ch in enumerate(TRIGGER):
        hit &= arr[i:n - t + i] == ch
    starts = np.flatnonzero(hit) + t
    if len(starts) == 0:
        z = np.zeros(0, np.int64)
        return z, z
    # run length of base64 chars from every position: scan from the
    # end, counting up while in-charset
    m = _IS_B64[arr]
    run = np.zeros(n + 1, np.int64)
    # vectorized suffix run-lengths: positions where mask is False
    # reset the count; count[i] = next_false[i] - i
    idx = np.arange(n)
    next_false = np.where(~m, idx, n)
    next_false = np.minimum.accumulate(next_false[::-1])[::-1]
    run[:n] = next_false - idx
    lengths = run[starts]
    keep = lengths > 0
    starts, lengths = starts[keep], lengths[keep]
    # overlapping triggers (a trigger inside a prior region) collapse
    # to the earliest
    if len(starts) > 1:
        ends = starts + lengths
        keep = np.ones(len(starts), bool)
        last_end = -1
        for i in range(len(starts)):
            if starts[i] < last_end:
                keep[i] = False
            else:
                last_end = ends[i]
        starts, lengths = starts[keep], lengths[keep]
    return starts[:max_regions], lengths[:max_regions]


def region_mask(arr: np.ndarray, starts, lengths) -> np.ndarray:
    """Boolean per-position mask of base64 payload bytes."""
    mask = np.zeros(len(arr) + 1, bool)
    delta = np.zeros(len(arr) + 1, np.int64)
    np.add.at(delta, starts, 1)
    np.add.at(delta, starts + lengths, -1)
    mask[:len(arr)] = np.cumsum(delta[:len(arr)]) > 0
    return mask[:len(arr)]


def drop_matches_in_regions(matches, mask):
    """Remove matches that start inside a base64 region (the reference
    skips LZ/dictionary lookups there entirely)."""
    m, lens, dists, flags = matches
    if len(m) == 0:
        return matches
    keep = ~mask[np.minimum(m, len(mask) - 1)]
    return m[keep], lens[keep], dists[keep], flags[keep]
