"""The q10/q11 device encode's serializer pool
(`enc/encoder._encode_q11_streamed`) on the CPU, with the plain
versions of the kernels.

Each route runs once at small metablocks (lgblock 16: 64 KiB spans)
with its spans recorded on their way to the pool: v3 in two halves
(8 spans, the first segment early), v1 (a segment a group, 4 spans) and
the `dcb` route (5 spans, compound references). Then:

  (a) the ring `bitstream.ring_after` predicts for each span is the one
      the native serializer returns for it, and the pooled stream is
      the one the spans give serialized one after another, each from
      the ring the one before it ended on;
  (b) the spans hold static words, omit-last words and, on the `dcb`
      route, compound references, so (a) covers each kind of match;
  (c) replayed through the pool with a wrong predicted ring, the
      stream keeps its bytes and every later span counts
      `serialize.ring_redo`;
  (d) replayed with one span's serialization failing, or the parse
      failing, the error reaches the caller and nothing hangs, also
      when the hand-off is waiting on the pool's bound;
  (e) replayed with slow serializers on one and on eight cores, at
      most min(spans, 8, cores) spans serialize at once and at most two
      more are in flight, `serialize.overlapped` counts only where the
      spans ran side by side, and the bytes do not change.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from brotli_tpu_torch import native
from brotli_tpu_torch.enc import bitstream
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.ops.optimal import DPConfig
from brotli_tpu_torch.tools.corpus import build_corpus
from brotli_tpu_torch.utils import trace

CORPUS = build_corpus(1 << 20)
MAXD = (1 << 22) - 16
LGBLOCK = 16
SEG = 1 << 16


def dcb_input():
    """(document, dictionary): a 100 KB slice of the corpus, and the
    300 KB after it with bytes of the slice spliced in, so the
    document's spans copy from the dictionary."""
    dic = CORPUS[200_000:300_000]
    rng = np.random.default_rng(7)
    doc = bytearray(CORPUS[300_000:600_000])
    for at in range(0, len(doc), 16_384):
        j = int(rng.integers(0, len(dic) - 2_000))
        doc[at:at + 2_000] = dic[j:j + 2_000]
    return bytes(doc), dic


ROUTES = {
    "v3 in halves": lambda: (CORPUS[50_000:50_000 + (512 << 10)], None,
                             DPConfig()),
    "v1": lambda: (CORPUS[400_000:400_000 + (256 << 10)], None,
                   DPConfig(mode="v1")),
    "dcb": lambda: (*dcb_input(), DPConfig()),
}


@pytest.fixture(scope="module", autouse=True)
def small_segments():
    """64 KiB DP segments and buckets (v3 and v1) and one torch thread:
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("SEG_V3", SEG), ("BUCKETS_V3", [SEG]),
                            ("SEG", SEG), ("BUCKETS", [SEG])):
            mp.setattr(O, name, value)
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def encode(doc, dic, dp):
    arr = np.frombuffer(doc, np.uint8)
    return PE._encode_q11_streamed(arr, len(arr), MAXD, 11, LGBLOCK, 22,
                                   torch.device("cpu"), dp, dic)


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    """(document, dictionary, the spans handed to the pool as
    (lo, hi, matches), the stream)."""
    doc, dic, dp = ROUTES[request.param]()
    spans = []
    real = PE.find_matches_optimal

    def spy(arr, maxd, on_block, **kw):
        def record(lo, hi, matches):
            spans.append((lo, hi, tuple(np.array(a) for a in matches)))
            on_block(lo, hi, matches)
        return real(arr, maxd, on_block=record, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PE, "find_matches_optimal", spy)
        out = encode(doc, dic, dp)
    assert [(lo, hi) for lo, hi, _ in spans] == [
        (lo, min(lo + (1 << LGBLOCK), len(doc)))
        for lo in range(0, len(doc), 1 << LGBLOCK)]
    assert native.decode(out, compound=dic or b"") == doc
    return doc, dic, spans, out


def replay(monkeypatch, spans, fail_after=None):
    """Stand in for the parse: hand the recorded spans to `on_block`, and
    raise after `fail_after` of them where given."""
    def parse(arr, maxd, on_block, **kw):
        for k, (lo, hi, matches) in enumerate(spans):
            if k == fail_after:
                raise RuntimeError("the parse failed")
            on_block(lo, hi, matches)

    monkeypatch.setattr(PE, "find_matches_optimal", parse)


def cores(monkeypatch, n):
    monkeypatch.setattr(PE.os, "sched_getaffinity",
                        lambda pid: set(range(n)))


# -- (a), (b) ------------------------------------------------------------------

def test_predicted_rings_and_the_stream_match_one_serializer(route):
    doc, dic, spans, out = route
    ring, blobs = None, []
    for lo, hi, (m, lens, dists, flags) in spans:
        predicted = bitstream.ring_after(dists, flags, ring)
        blob, ring = native.serialize_region(
            doc, lo, hi, (m, lens, dists, flags), 11, 22, ring=ring,
            write_header=lo == 0, is_last=hi >= len(doc), align_end=True,
            dict_len=len(dic or b""))
        np.testing.assert_array_equal(predicted, ring)
        blobs.append(blob)
    assert b"".join(blobs) == out


def test_the_spans_hold_every_kind_of_match(route):
    _, dic, spans, _ = route
    lens, flags = (np.concatenate([m[i] for _, _, m in spans])
                   for i in (1, 3))
    assert (flags >= 2000).any()  # static words, 2000 + the word's length
    # omit-last words: shorter than their word
    assert ((flags >= 2000) & (lens < flags - 2000)).any()
    assert (flags == 1).any() == (dic is not None)  # compound references


# -- (c) -----------------------------------------------------------------------

def test_a_wrong_predicted_ring_is_serialized_again(route, monkeypatch):
    doc, dic, spans, out = route
    replay(monkeypatch, spans)
    monkeypatch.setattr(bitstream, "ring_after",
                        lambda dists, flags, ring=None: np.arange(1, 5))
    trace.enable(True)
    assert encode(doc, dic, None) == out
    got = trace.counters()
    assert got["serialize.spans"] == len(spans)
    assert got["serialize.ring_redo"] == len(spans) - 1


# -- (d) -----------------------------------------------------------------------

def run_bounded(fn, timeout=60):
    """fn() on a thread joined with a timeout: (its result, its error)."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except Exception as e:  # handed to the test
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the encode hung"
    return box.get("out"), box.get("err")


@pytest.mark.parametrize("ncores", [1, 8])
@pytest.mark.parametrize("where", ["first span", "middle span", "last span",
                                   "the parse"])
def test_a_failure_reaches_the_caller(route, monkeypatch, where, ncores):
    doc, dic, spans, _ = route
    cores(monkeypatch, ncores)
    k = {"first span": 0, "middle span": len(spans) // 2,
         "last span": len(spans) - 1, "the parse": None}[where]
    replay(monkeypatch, spans, fail_after=2 if k is None else None)
    real = native.serialize_region
    bad_lo = None if k is None else spans[k][0]

    def serialize(data, lo, *args, **kw):
        time.sleep(0.01)  # later spans queue behind the bound
        if lo == bad_lo:
            raise ValueError(f"span at {lo} failed")
        return real(data, lo, *args, **kw)

    monkeypatch.setattr(native, "serialize_region", serialize)
    out, err = run_bounded(lambda: encode(doc, dic, None))
    assert out is None
    if k is None:
        assert isinstance(err, RuntimeError), err
    else:
        assert isinstance(err, ValueError) and str(bad_lo) in str(err)


# -- (e) -----------------------------------------------------------------------

@pytest.mark.parametrize("ncores", [1, 8])
def test_spans_run_side_by_side_within_the_bound(route, monkeypatch,
                                                 ncores):
    doc, dic, spans, out = route
    cores(monkeypatch, ncores)
    workers = min(len(spans), 8, ncores)
    real = native.serialize_region
    lock = threading.Lock()
    state = {"now": 0, "most": 0, "ended": 0, "handed": 0, "in_flight": 0}

    def serialize(*args, **kw):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        try:
            time.sleep(0.02)
            return real(*args, **kw)
        finally:
            with lock:
                state["now"] -= 1
                state["ended"] += 1

    def parse(arr, maxd, on_block, **kw):
        for lo, hi, matches in spans:
            on_block(lo, hi, matches)
            with lock:
                state["handed"] += 1
                state["in_flight"] = max(state["in_flight"],
                                         state["handed"] - state["ended"])

    monkeypatch.setattr(native, "serialize_region", serialize)
    monkeypatch.setattr(PE, "find_matches_optimal", parse)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable(True)
    try:
        got, err = run_bounded(lambda: encode(doc, dic, None))
    finally:
        sys.setswitchinterval(switch)
    assert err is None and got == out
    assert state["most"] <= workers and state["in_flight"] <= workers + 2
    counts = trace.counters()
    assert counts["serialize.spans"] == len(spans)
    assert "serialize.ring_redo" not in counts
    overlapped = counts.get("serialize.overlapped", 0)
    if workers == 1:
        assert overlapped == 0 and state["most"] == 1
    else:
        assert 1 <= overlapped <= len(spans) - 1 and state["most"] > 1
