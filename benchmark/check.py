"""The comparison that decides `correct`.

Every stream the window's requests returned is judged against the
document that request sent, by the plain reference decoder in
benchmark/reference, which imports nothing of the program:

  * wrong_streams: requests whose stream does not decode to their
    document byte for byte, fails to decode, or whose call raised;
  * wrong_window: requests whose stream declares other window bits than
    the configuration's guarantee states.

Both limits are 0: the configuration promises a lossless RFC 7932
stream that declares its window. Where the traffic gives each document
a raw dictionary, a stream is decoded with the dictionary its request
carried. Requests that returned the same bytes for the same document and
dictionary share one decode; the distinct ones are decoded in a pool of
processes after the window has closed.
"""

import concurrent.futures as cf
import hashlib
import multiprocessing
import os

from benchmark import reference

LIMITS = {"wrong_streams": 0, "wrong_window": 0}


def judge(doc: bytes, stream: bytes, window_bits: int,
          dictionary: bytes = None):
    """(declares `window_bits`, decodes to `doc` with `dictionary`) for
    one stream."""
    try:
        declared = reference.window_bits(stream) == window_bits
    except Exception:  # an unreadable header declares nothing
        declared = False
    try:
        same = reference.decompress(stream, dictionary) == doc
    except Exception:  # an invalid stream is a wrong one
        same = False
    return declared, same


def compare(docs, requests, window_bits: int, dictionaries=None,
            workers: int = None) -> dict:
    """The numbers compared, {name: value}, for `requests`, a list of
    (document index, stream or None where the call raised);
    `dictionaries`, where the traffic has them, holds each document's
    dictionary, the one its requests carried."""
    dicts = dictionaries or [None] * len(docs)
    digests = {}  # by object: bytes held twice are hashed once

    def digest(b):
        if b is None:
            return None
        if id(b) not in digests:
            digests[id(b)] = hashlib.sha256(b).digest()
        return digests[id(b)]

    def key(di, stream):
        return di, digest(dicts[di]), digest(stream)

    verdicts, jobs = {}, {}
    for di, stream in requests:
        if stream is not None:
            jobs.setdefault(key(di, stream), (docs[di], stream, dicts[di]))
    if jobs:
        workers = workers or max(1, min(len(jobs), (os.cpu_count() or 2) - 1))
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            futs = {k: pool.submit(judge, d, s, window_bits, dd)
                    for k, (d, s, dd) in jobs.items()}
            verdicts = {k: f.result() for k, f in futs.items()}
    wrong = bad_window = 0
    for di, stream in requests:
        if stream is None:
            wrong += 1
            continue
        declared, same = verdicts[key(di, stream)]
        wrong += not same
        bad_window += not declared
    return {"wrong_streams": wrong, "wrong_window": bad_window}
