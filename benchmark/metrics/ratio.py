"""Compression ratio: all input bytes of the window over all the
stream bytes its requests returned."""


def read(w):
    out = sum(w.output_bytes)
    return sum(w.request_bytes) / out if out else None
