"""The q10/q11 device DP's segments of one request at a window wider
than a segment: the program's v3 parse cuts an input into segments of
`seg_bytes`, pads each to the smallest of `buckets` that holds it, and
gives each a halo of history before it, the part of the `window` that
its last position can still reach, min(lo, window - seg_bytes), in
whole blocks of `B` (ops/optimal._halo; none where the window is not
wider than a segment). As much of the halo as the bucket's padding
holds rides in the bucket; K9, the sorts and K10 run over the rest as
well, and every later kernel over the bucket alone.

A segment's shape is dp_segment's (`n` positions, the bucket, `levels`,
`ncand`, `nslots`, `W`, `B`) with `halo`, the history bytes, and `nh`,
the candidate rows K9 and K10 run over.

`agrees(window, segments)` tells whether the halo bytes these segments
count are the program's own (counter dp.halo_bytes of
ops/optimal._dispatch_v3, once a segment); where they are not, it says
so in the result line (`window.warn`)."""

from benchmark import spans as S


def segments(n_bytes, seg_bytes, buckets, levels, W, B, window):
    out = []
    for lo in range(0, n_bytes, seg_bytes):
        size = min(lo + seg_bytes, n_bytes) - lo
        n = next((b for b in buckets if size <= b), buckets[-1])
        h = (max(min(lo, window - seg_bytes), 0) // B * B
             if window > seg_bytes else 0)
        inside = min(h, (n - size) // B * B)  # in the bucket's padding
        ncand = sum(r for _, r in levels)
        out.append({"n": n, "nh": n + h - inside, "halo": h,
                    "levels": [list(x) for x in levels], "ncand": ncand,
                    "nslots": ncand + 2, "W": W, "B": B})
    return out


def agrees(w, segs, name) -> bool:
    got = S.window()
    have = None if got is None else got[1].get("dp.halo_bytes")
    want = sum(s["halo"] for s in segs)
    if have != want:
        w.warn(f"{name}: the shapes count {want} halo bytes, dp.halo_bytes "
               f"{have}; left out")
        return False
    return True
