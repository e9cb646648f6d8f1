"""K4 (csrc/dp_backtrack.cu), once a DP segment: reads the (n / B, B + 1)
payload matrix, writes the B steps of sources and values of every
block. About 8 operations a position."""

SHAPE = "dp_segment"
KERNEL = "dp_backtrack_kernel"


def counts(seg):
    n, B = seg["n"], seg["B"]
    nb = n // B
    return [((nb * (B + 1) + 2 * B * nb) * 4, nb * B * 8)]
