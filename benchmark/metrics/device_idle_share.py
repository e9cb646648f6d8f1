"""Share (%) of the window in which the card ran nothing: 1 - the union
of the intervals of its kernels, memsets and copies over the window."""


def read(w):
    if not w.device_ops:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
