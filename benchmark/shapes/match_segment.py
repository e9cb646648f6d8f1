"""The device LZ matcher's segments of one request: above `seg_bytes`
the program's matcher advances by half a buffer, each segment carrying
the half before it as window history, and pads each buffer to the
smallest of `buckets` that holds it. A segment's shape is its `n`
positions (the bucket) and the `ncand` hash candidates a position."""


def segments(n_bytes, seg_bytes, buckets, ncand):
    adv = seg_bytes // 2 if n_bytes > seg_bytes else seg_bytes
    out = []
    for lo in range(0, n_bytes, adv):
        size = min(lo + adv, n_bytes) - max(0, lo - (seg_bytes - adv))
        n = next((b for b in buckets if size <= b), buckets[-1])
        out.append({"n": n, "ncand": ncand})
    return out
