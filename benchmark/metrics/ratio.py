"""Compression ratio: all input bytes of the window over all the
stream bytes its requests returned. Where the traffic gives a request a
dictionary, its bytes are counted on neither side: the client already
holds it."""


def read(w):
    out = sum(w.output_bytes)
    return sum(w.request_bytes) / out if out else None
