"""Share (%) of the window's device kernel time that the device
matcher's kernel K2 (chain_select) would take at the card's peak,
counted from the segments' shapes (core.roofline_share). The kernel is
named here: a roofline added for another kernel is another metric's."""

from benchmark.core import roofline_share

KERNELS = ("chain_select",)


def read(w):
    return roofline_share(w, "match_segment", KERNELS)
