"""The native serializer's thread budget (`native.serialize_region(...,
threads=)`, `btpu_enc.c`'s `par_for`): a metablock's q10/q11 literal
split ladder (four k-means rungs) and per-type context clustering run
side by side, and the bytes never depend on the budget.

  (a) at 1, 2 and 8 threads the stream and the exit ring are equal on
      two WOFF2 inputs in FONT mode with the NPOSTFIX/NDIRECT search,
      jQuery 3.6.0 and the first 4 MiB of `trace_viewer_index`
      (sniffed contexts), the smoke corpus's random-tail 4 MiB at q11
      and at q10 (the ladder without the refinement), a span with
      compound references, and an input of fewer than 4,096 literals;
  (b) the `threaded` count: 0 at one thread and on the small input, one
      a metablock where the passes ran side by side;
  (c) serializers on more threads than cores, each with a budget, write
      the bytes of one thread;
  (d) the q11 card route (`compress(mode=2, encoder="device")`, on the
      CPU with the plain kernels) writes the stream it writes with every
      budget forced to 1, and gives each span a budget of the cores the
      other spans and the parse leave free.
"""

import os
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from brotli_tpu_torch import compress, native
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus
from brotli_tpu_torch.utils import trace

DATA = pathlib.Path(__file__).resolve().parent.parent / "benchmark" / "data"
FONT = dict(ctx_mode=3, dist_search=True)
MAXBACK = (1 << 22) - 16


def _plain(data):
    """The native q9 seed parse of `data` as serializer matches."""
    p, ln, d = native.find_matches(data, 9, 22)
    return data, 0, (p, ln, d, np.zeros(len(p), np.int64))


def _font(name):
    return _plain((DATA / "woff2" / name).read_bytes())


def _script(name, size=None):
    return _plain((DATA / "versions" / name).read_bytes()[:size])


def _random_tail():
    return _plain(build_corpus(16 << 20)[12 << 20:])


def _compound():
    """jQuery 3.6.0 after zone.js as raw dictionary: its matches into
    the dictionary lifted to compound references (flag 1)."""
    dic = (DATA / "versions" / "zone-xprof-2.21.5.js").read_bytes()
    doc = (DATA / "versions" / "jquery-3.6.0.js").read_bytes()
    D = len(dic)
    m, ln, d = (a.astype(np.int64) for a in
                native.find_matches(dic + doc, 9, 22, start=D))
    m, ln, d, f = PE._lift_dictionary_matches(
        (m, ln, d, np.zeros(len(m), np.int64)), D, MAXBACK)
    return doc, D, (m - D, ln, d, f)


# name: (input, quality, coding, whether the passes engage)
CASES = {
    "font DejaVuSansMono-Bold": (lambda: _font("DejaVuSansMono-Bold.bin"),
                                 11, FONT, True),
    "font DejaVuSerif-Bold": (lambda: _font("DejaVuSerif-Bold.bin"), 11,
                              FONT, True),
    "jquery-3.6.0": (lambda: _script("jquery-3.6.0.js"), 11, {}, True),
    "trace_viewer_index 4 MiB": (
        lambda: _script("trace_viewer_index-tensorboard_plugin_profile-"
                        "2.13.0.js", 4 << 20), 11, {}, True),
    "random tail q11": (_random_tail, 11, {}, True),
    "random tail q10": (_random_tail, 10, {}, True),
    "compound": (_compound, 11, {}, True),
    # at most 3,000 literals: below the ladder's 4,096
    "small": (lambda: _script("jquery-3.6.0.js", 3_000), 11, {}, False),
}


def _serialize(case, threads):
    (data, dict_len, matches), quality, coding, _ = case
    stats = {}
    blob, ring = native.serialize_region(
        data, 0, len(data), matches, quality, 22, write_header=True,
        is_last=True, dict_len=dict_len, stats=stats, threads=threads,
        **coding)
    return blob, ring, stats


@pytest.fixture(scope="module")
def one_thread():
    """name -> (case, its one-thread stream, ring and stats), made on
    first use."""
    made = {}

    def get(name):
        if name not in made:
            make, quality, coding, engages = CASES[name]
            case = (make(), quality, coding, engages)
            made[name] = (case, *_serialize(case, 1))
        return made[name]
    return get


# -- (a), (b) ------------------------------------------------------------------

@pytest.mark.parametrize("threads", [2, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_the_bytes_do_not_depend_on_the_budget(one_thread, name, threads):
    case, want, want_ring, want_stats = one_thread(name)
    blob, ring, stats = _serialize(case, threads)
    assert blob == want
    np.testing.assert_array_equal(ring, want_ring)
    assert want_stats["threaded"] == 0
    engages = case[3]
    assert stats.pop("threaded") == (want_stats["metablocks"] if engages
                                     else 0)
    assert stats == {k: v for k, v in want_stats.items()
                     if k != "threaded"}
    if name == "compound":
        assert (case[0][2][3] == 1).any()
        data, dict_len = case[0][0], case[0][1]
        dic = (DATA / "versions" / "zone-xprof-2.21.5.js").read_bytes()
        assert len(dic) == dict_len
        assert native.decode(blob, compound=dic) == data
    else:
        assert native.decode(blob) == case[0][0]


def test_a_budget_below_one_is_refused():
    data, _, matches = _plain(b"abcabcabc" * 100)
    with pytest.raises(ValueError, match="threads"):
        native.serialize_region(data, 0, len(data), matches, 11, 22,
                                threads=0)


# -- (c) -----------------------------------------------------------------------

def test_serializers_on_more_threads_than_cores_keep_their_bytes():
    """cores + 2 serializers at once, each with a budget of 4, on a
    shortened switch interval: every stream is the one-thread stream."""
    data, _, matches = _plain(
        (DATA / "woff2" / "DejaVuSansMono-Bold.bin").read_bytes()[:96_000])
    case = ((data, 0, matches), 11, FONT, True)
    want = _serialize(case, 1)[0]
    n = len(os.sched_getaffinity(0)) + 2
    got = [None] * n

    def run(k):
        got[k] = _serialize(case, 4)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=run, args=(k,), daemon=True)
                   for k in range(n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers), "a serializer hung"
    assert all(g is not None and g[0] == want and g[2]["threaded"] == 1
               for g in got)


# -- (d) -----------------------------------------------------------------------

LGBLOCK = 16
SEG = 1 << 16


@pytest.fixture(scope="module")
def small_segments():
    """64 KiB DP segments and buckets and one torch thread: several test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("SEG_V3", SEG), ("BUCKETS_V3", [SEG]),
                            ("SEG", SEG), ("BUCKETS", [SEG])):
            mp.setattr(O, name, value)
        yield
    torch.set_num_threads(n)


def _spy(monkeypatch, force=None, cores=8, before=None):
    """Record every span's (lo, hi, budget) as its serialization starts
    on a host of `cores` cores, after `before(lo)` where given; `force`
    replaces every budget."""
    budgets = []
    real = native.serialize_region

    def serialize(data, lo, hi, *args, threads=1, **kw):
        budgets.append((lo, hi, threads))
        if before is not None:
            before(lo)
        return real(data, lo, hi, *args,
                    threads=threads if force is None else force, **kw)

    monkeypatch.setattr(native, "serialize_region", serialize)
    monkeypatch.setattr(PE.os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    return budgets


def _traced(fn):
    """(fn(), the counters it left)."""
    trace.reset()
    trace.enable(True)
    try:
        return fn(), trace.counters()
    finally:
        trace.enable(False)
        trace.reset()


def _compress(doc):
    return compress(doc, mode=2, quality=11, lgwin=22, lgblock=LGBLOCK,
                    encoder="device", device="cpu")


def _replay(doc, spans, lgblock=LGBLOCK, handed=None):
    """The route's serializer pool fed `spans` by a stand-in parse, which
    calls `handed(k)` after handing over span k where given."""
    def parse(arr, maxd, on_block, **kw):
        for k, (lo, hi, matches) in enumerate(spans):
            on_block(lo, hi, matches)
            if handed is not None:
                handed(k)

    arr = np.frombuffer(doc, np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PE, "find_matches_optimal", parse)
        return PE._encode_q11_streamed(arr, len(arr), MAXBACK, 11, lgblock,
                                       22, torch.device("cpu"), None, None,
                                       mode=PE.FONT)


@pytest.fixture(scope="module")
def font_doc():
    """A WOFF2 input of 256 KiB or more, the route's least: five spans."""
    return (DATA / "woff2" / "DejaVuSansMono-Bold.bin").read_bytes()


@pytest.fixture(scope="module")
def forced(small_segments, font_doc):
    """The route's stream with every budget forced to 1, and the spans
    the parse handed over."""
    spans = []
    real = PE.find_matches_optimal

    def parse(arr, maxd, on_block, **kw):
        def record(lo, hi, matches):
            spans.append((lo, hi, tuple(np.array(a) for a in matches)))
            on_block(lo, hi, matches)
        return real(arr, maxd, on_block=record, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PE, "find_matches_optimal", parse)
        budgets = _spy(mp, force=1)
        out, counts = _traced(lambda: _compress(font_doc))
    assert len(spans) == 5 and len(budgets) == 5
    assert counts["serialize.threaded"] == 0
    return out, spans


def test_the_route_writes_one_threads_stream(forced, font_doc,
                                             monkeypatch):
    budgets = _spy(monkeypatch)
    out, counts = _traced(lambda: _compress(font_doc))
    assert out == forced[0]
    assert native.decode(out) == font_doc
    assert len(budgets) == 5 and all(1 < b <= 8 for _, _, b in budgets)
    assert counts["serialize.metablocks"] == 5
    # the last span, 7,315 bytes, holds fewer literals than the ladder's
    # 4,096 and one literal type: its passes never fork
    assert counts["serialize.threaded"] == 4


def test_a_span_takes_the_cores_left_free(forced, font_doc, monkeypatch):
    """Replayed so that each span starts before the next is handed over
    and no span ends before all have started: span k starts beside k
    others, less one core for the parse until the last span."""
    out, spans = forced
    started = [threading.Event() for _ in spans]
    all_started = threading.Barrier(len(spans), timeout=60)

    def before(lo):
        started[[s[0] for s in spans].index(lo)].set()
        all_started.wait()

    def handed(k):
        assert started[k].wait(60), f"span {k} never started"

    budgets = _spy(monkeypatch, before=before)
    assert _replay(font_doc, spans, handed=handed) == out
    assert [b for _, _, b in budgets] == [7, 6, 5, 4, 4]
    assert [lo for lo, _, _ in budgets] == [s[0] for s in spans]


@pytest.mark.parametrize("cores", [8, 3, 1])
def test_a_one_span_request_takes_every_core(font_doc, monkeypatch,
                                             cores):
    """One span is the parse's last: nothing else runs beside it."""
    doc = font_doc[:1 << LGBLOCK]
    _, _, matches = _plain(doc)
    budgets = _spy(monkeypatch, cores=cores)
    out, counts = _traced(lambda: _replay(doc, [(0, len(doc), matches)]))
    assert budgets == [(0, len(doc), cores)]
    assert counts["serialize.threaded"] == (cores > 1)
    assert native.decode(out) == doc
