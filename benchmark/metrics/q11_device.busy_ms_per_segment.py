"""Device ms of a q11 DP segment: the union of the intervals of every
kernel, memset and copy in the window, over the DP segments that the
window's requests held."""

from benchmark.core import segments


def read(w):
    n = len(segments(w, "dp_segment"))
    if not n or not w.device_ops:
        return None
    return 1e3 * w.busy_s / n
