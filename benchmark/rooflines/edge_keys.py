"""K9 (csrc/edge_keys.cu), once a level of a DP segment: reads the n
bytes, writes n int32 sort keys. About 20 operations a position (two
words, two multiplies, the key)."""

SHAPE = "dp_segment"
KERNEL = "edge_keys_kernel"


def counts(seg):
    n = seg["n"]
    return [(n + 4 * n, n * 20) for _ in seg["levels"]]
