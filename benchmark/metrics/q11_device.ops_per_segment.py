"""Device operations (kernels, memsets and copies) of a q11 DP segment:
those of the window over the DP segments its requests held."""

from benchmark.core import segments


def read(w):
    n = len(segments(w, "dp_segment"))
    if not n or not w.device_ops:
        return None
    return len(w.device_ops) / n
