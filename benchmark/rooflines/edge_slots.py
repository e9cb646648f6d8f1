"""K11 (csrc/edge_slots.cu: a scatter kernel and a slot kernel in one
call), once a DP segment: reads the (n, ncand) candidates, the bytes,
the seed and dictionary edges (`ns` and `nd` of them, 0 where the shape
does not state them) and the cost tables, writes the (nslots, n) pd and
cs tables, the literal costs and the distance fill. About 12 operations
for a distance cost a slot and position."""

SHAPE = "dp_segment"
KERNEL = "slots_kernel"  # once a call, beside its scatter kernel


def counts(seg):
    n, ncand, nslots = seg["n"], seg["ncand"], seg["nslots"]
    ns, nd = seg.get("ns", 0), seg.get("nd", 0)
    nbytes = (4 * ncand * n + n + 24 * ns + 16 * nd +
              4 * (64 + 64 * 256 + 256 * 256) + 8 * nslots * n + 8 * n)
    return [(nbytes, n * nslots * 12)]
