"""Seconds from the process's start to the start of the window: imports,
the inputs made from the seed, the kernels loaded (built on a
checkout's first run) and the warm-up request."""


def read(w):
    return w.setup_s
