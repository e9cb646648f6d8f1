"""K3 (csrc/dp_scan.cu), once a DP segment: reads K1's (n, 2W) rows and
the n literal costs, writes the (n / B, B + 1) payload matrix. About 4
operations for each of a position's W window cells."""

SHAPE = "dp_segment"
KERNEL = "dp_scan_kernel"


def counts(seg):
    n, W, B = seg["n"], seg["W"], seg["B"]
    return [((2 * W * n + n + (n // B) * (B + 1)) * 4, n * W * 4)]
