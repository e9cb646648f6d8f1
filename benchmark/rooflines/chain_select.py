"""K2 (csrc/chain_select.cu), once a device-matcher segment: reads the n
skips and writes the n selections, an operation a position."""

SHAPE = "match_segment"
KERNEL = "chain_select_kernel"


def counts(seg):
    n = seg["n"]
    return [(2 * n * 4, n)]
