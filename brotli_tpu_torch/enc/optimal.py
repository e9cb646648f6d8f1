"""Cost units and match-array post-processing of the optimal parse,
copied from brotli_tpu.enc.optimal."""

import numpy as np

QB = 16            # cost quantization: 1/16 bit
CMD_BASE_Q = 1 * QB  # floor cost per command beyond modeled parts


def _coalesce(m, lens, dists, flags):
    """Merge adjacent same-distance LZ copies (chunked long matches)
    back into single commands."""
    if len(m) < 2:
        return m, lens, dists, flags
    join = (m[1:] == m[:-1] + lens[:-1]) & (dists[1:] == dists[:-1]) & \
        (flags[1:] == 0) & (flags[:-1] == 0)
    # group id per run of joined matches
    grp = np.concatenate([[0], np.cumsum(~join)])
    ngrp = int(grp[-1]) + 1
    first = np.zeros(ngrp, np.int64)
    first[grp[::-1]] = np.arange(len(m))[::-1]  # first member per group
    nl = np.zeros(ngrp, np.int64)
    np.add.at(nl, grp, lens)
    return m[first], nl, dists[first], flags[first]


def bridge_matches(data, m, lens, dists, flags, max_gap=32):
    """Merge [copy@d][g-byte literal gap][copy@d] into one copy when
    the gap bytes also match at distance d (verified byte-for-byte).

    The DP chunks long matches into <=W-1 edges; when the chunk grid
    does not divide the span, its model prefers a 1-byte literal over
    an extra modeled command, which leaves 1-byte holes that break a
    long copy apart. Bridging is exact: strictly fewer commands and
    literals, same distances."""
    if len(m) < 2:
        return m, lens, dists, flags
    e = m[:-1] + lens[:-1]
    g = m[1:] - e
    d = dists[:-1]
    ok = (dists[1:] == d) & (d > 0) & (flags[:-1] == 0) & \
        (flags[1:] == 0) & (g > 0) & (g <= max_gap)
    if ok.any():
        for off in range(int(g[ok].max())):
            act = np.flatnonzero(ok & (g > off))
            if act.size == 0:
                break
            idx = (e[act] + off).astype(np.int64)
            src = idx - d[act]
            bad = (src < 0) | (data[idx] != data[np.maximum(src, 0)])
            ok[act[bad]] = False
        lens = lens.copy()
        lens[:-1][ok] += g[ok]  # absorb the gap; _coalesce fuses runs
    return _coalesce(m, lens, dists, flags)
