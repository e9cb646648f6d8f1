"""K10's level launch (csrc/edge_ranks.cu), once a level of a DP segment
with a halo: reads the nh sorted keys, their order and bytes of the
candidate rows, writes the level's ranks words of the n positions of the
bucket only (its rows are padded to 64 bytes, which the count leaves
out). About 8 operations a rank of a written row (the neighbour's key,
order and a word compare). `agrees`: the shape's halo is the program's
(shapes/dp_segment_halo)."""

from benchmark import core

SHAPE = "dp_segment_halo"
KERNEL = "edge_ranks_kernel"


def counts(seg):
    n, nh = seg["n"], seg["nh"]
    return [(4 * nh + 8 * nh + nh + 4 * ranks * n, n * ranks * 8)
            for _, ranks in seg["levels"]]


def agrees(w, segs):
    return core.load_module("shapes", SHAPE).agrees(w, segs,
                                                    "edge_ranks_halo")
