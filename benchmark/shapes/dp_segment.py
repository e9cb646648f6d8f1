"""The q10/q11 device DP's segments of one request: the program's v3
parse cuts an input into segments of `seg_bytes` and pads each to the
smallest of `buckets` that holds it. A segment's shape is what its
kernels' work follows from: `n` positions (the bucket), `levels` as
(prefix bytes, number of ranks), `ncand` candidate columns (the ranks
of all levels), `nslots` = ncand + 2 slot rows, the DP window `W` and
block `B`."""


def segments(n_bytes, seg_bytes, buckets, levels, W, B):
    out = []
    for lo in range(0, n_bytes, seg_bytes):
        size = min(lo + seg_bytes, n_bytes) - lo
        n = next((b for b in buckets if size <= b), buckets[-1])
        ncand = sum(r for _, r in levels)
        out.append({"n": n, "levels": [list(x) for x in levels],
                    "ncand": ncand, "nslots": ncand + 2, "W": W, "B": B})
    return out
