"""Faults planted under the timed path, for the control runs and the
tests that show the check can fail (`benchmark.run --fault NAME`; the
benchmark's own runs plant none). Each wraps the configuration's entry
`fn(data, **kwargs)`, called as the run calls the entry (with the
request's dictionary among `kwargs` where the traffic gives one), and
breaks one guarantee the configuration states:

  * identity: a step that returns its input unchanged (no stream);
  * half: half of the request left out (the stream of its first half);
  * lossy: one byte of the document altered where the stream is
    produced (a valid stream of other bytes);
  * window: the stream declares a 24-bit window, not the configured one;
  * swapdict: the request compressed with another document's dictionary
    (a valid stream of other bytes for the dictionary the client holds);
    only on traffic whose documents carry dictionaries.
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


def swapdict(fn, key, dictionaries):
    """`key` is the entry's dictionary keyword and `dictionaries` the
    documents' dictionaries, as the traffic gives them."""
    if key is None or len(set(dictionaries or ())) < 2:
        raise ValueError("swapdict swaps the dictionaries of a traffic "
                         "whose documents carry two or more different "
                         "ones; this traffic names no dictionary keyword "
                         "or has one dictionary")

    def run(data, **kw):
        own = kw[key]
        i = dictionaries.index(own)
        other = next(d for d in dictionaries[i + 1:] + dictionaries[:i]
                     if d != own)
        return fn(data, **{**kw, key: other})
    return run


FAULTS = {"identity": identity, "half": half, "lossy": lossy,
          "window": window, "swapdict": swapdict}


def plant(name, fn, key=None, dictionaries=None):
    """The entry `fn` with the fault `name` under it; `key` and
    `dictionaries` as `swapdict` takes them (None on traffic without
    dictionaries)."""
    if name == "swapdict":
        return swapdict(fn, key, dictionaries)
    return FAULTS[name](fn)
