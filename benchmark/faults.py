"""Faults planted under the timed path, for the control runs and the
tests that show the check can fail (`benchmark.run --fault NAME`; the
benchmark's own runs plant none). Each wraps the configuration's entry
`fn(data, **kwargs)` and breaks one guarantee the configuration states:

  * identity: a step that returns its input unchanged (no stream);
  * half: half of the request left out (the stream of its first half);
  * lossy: one byte of the document altered where the stream is
    produced (a valid stream of other bytes);
  * window: the stream declares a 24-bit window, not the configured one.
"""


def identity(fn):
    return lambda data, **kw: bytes(data)


def half(fn):
    return lambda data, **kw: fn(data[:len(data) // 2], **kw)


def lossy(fn):
    def run(data, **kw):
        changed = bytearray(data)
        i = (len(data) * 7) // 11
        changed[i] ^= 0x20
        return fn(bytes(changed), **kw)
    return run


def window(fn):
    return lambda data, **kw: fn(data, **{**kw, "lgwin": 24})


FAULTS = {"identity": identity, "half": half, "lossy": lossy,
          "window": window}
