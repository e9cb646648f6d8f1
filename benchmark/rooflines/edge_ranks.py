"""K10's level launch (csrc/edge_ranks.cu), once a level of a DP
segment: reads the sorted keys, the order and the bytes, writes the
level's ranks words (its rows are padded to 64 bytes, which the count
leaves out). About 8 operations a rank (the neighbour's key, order and
a word compare)."""

SHAPE = "dp_segment"
KERNEL = "edge_ranks_kernel"


def counts(seg):
    n = seg["n"]
    return [(4 * n + 8 * n + n + 4 * ranks * n, n * ranks * 8)
            for _, ranks in seg["levels"]]
