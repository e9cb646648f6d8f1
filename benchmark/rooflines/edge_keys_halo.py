"""K9 (csrc/edge_keys.cu), once a level of a DP segment with a halo:
reads the nh bytes of its candidate rows (the bucket and the history
before it that the bucket does not hold), writes nh int32 sort keys.
About 20 operations a row (two words, two multiplies, the key).
`agrees`: the shape's halo is the program's (shapes/dp_segment_halo)."""

from benchmark import core

SHAPE = "dp_segment_halo"
KERNEL = "edge_keys_kernel"


def counts(seg):
    nh = seg["nh"]
    return [(nh + 4 * nh, nh * 20) for _ in seg["levels"]]


def agrees(w, segs):
    return core.load_module("shapes", SHAPE).agrees(w, segs,
                                                    "edge_keys_halo")
