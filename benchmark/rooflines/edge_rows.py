"""K10's row pass (csrc/edge_ranks.cu), once a DP segment: reads the
levels' words and writes the int32 (n, ncand) candidate table, a copy a
word."""

SHAPE = "dp_segment"
KERNEL = "edge_rows_kernel"


def counts(seg):
    n, ncand = seg["n"], seg["ncand"]
    return [(8 * ncand * n, n * ncand)]
