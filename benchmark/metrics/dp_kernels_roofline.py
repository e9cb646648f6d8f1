"""Share (%) of the window's device kernel time that the DP segments'
kernels K1, K3, K4, K9, K10, K10's row pass and K11 would take at the
card's peak bytes/s or operations/s, counted from the segments' shapes
(core.roofline_share). The kernels are named here: a roofline added for
another kernel is another metric's."""

from benchmark.core import roofline_share

KERNELS = ("suffix_min", "dp_scan", "dp_backtrack", "edge_keys",
           "edge_ranks", "edge_rows", "edge_slots")


def read(w):
    return roofline_share(w, "dp_segment", KERNELS)
