"""K1 (csrc/suffix_min.cu), once a DP segment: reads the (nslots, n)
payload and cost slots and the W copy costs, writes the (n, 2W) rows.
About 8 operations for each of a position's nslots scatters and W
suffix-min steps."""

SHAPE = "dp_segment"
KERNEL = "suffix_min_kernel"


def counts(seg):
    n, W, ns = seg["n"], seg["W"], seg["nslots"]
    return [((2 * ns * n + W + 2 * W * n) * 4, n * (ns + W) * 8)]
