"""RFC 9842 dictionary-compressed brotli (`dcb`) on the port's card route,
on the CPU with the plain versions of the kernels:

  (a) `compress(..., dictionary=D, encoder="device")` at q11 parses the
      input with the raw dictionary as history through the streamed q11
      route: each stream decodes to its input with its dictionary under
      the benchmark's plain reference, the port's decoder and the native
      decoder, and is at most 1% larger than the Python pipeline's (the
      DP over dictionary and input laid end to end);
  (b) at a small window, dictionary and input reach past it: compound
      references there (`dcb.far_bytes`), and the stream decodes;
  (c) the route records the streamed route's spans and no `match-find`;
      "auto" with a dictionary and the card route without one keep
      their bytes;
  (d) K10's plain version with the stream's base inside the dictionary,
      the seed parse after a dictionary (native/btpu_history.c),
      `lift_compound`, and the native compound writer
      (native/btpu_compound.c);
  (e) the Python pipeline with a dictionary whose length and the
      input's exceed the window, whose static words the JAX package
      wrote inside the compound region.

The DP's segments are cut to 128 KiB with buckets of 64 and 128 KiB
(the card's 4 MiB and its 2 and 4 MiB buckets, over 32), so an input
that fills less than its bucket carries the dictionary's tail in the
padding, as the card's route does; the route's threshold is lowered to
32 KiB. Inputs are in-repo only.
"""

import hashlib

import numpy as np
import pytest
import torch

import brotli_tpu_torch as bt
from benchmark import reference
from brotli_tpu_torch import native
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus
from brotli_tpu_torch.utils import trace

CORPUS = build_corpus(1 << 20)
MAXD22 = (1 << 22) - 16


@pytest.fixture(autouse=True)
def small_segments(monkeypatch):
    """Segments and buckets cut by 32, the route's threshold to 32 KiB,
    one torch thread (several test workers share the cores), and
    tracing off and empty before and after."""
    monkeypatch.setattr(O, "SEG_V3", 1 << 17)
    monkeypatch.setattr(O, "BUCKETS_V3", [1 << 16, 1 << 17])
    monkeypatch.setattr(PE, "MIN_DEVICE_INPUT", 1 << 15)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()
    torch.set_num_threads(n)


def dcb_pair(seed, dict_len, doc_len):
    """(dictionary, document): a seeded slice of the corpus, and a newer
    release of it: byte mutations, insertions from elsewhere in the
    corpus, and a tail of random bytes and new text."""
    rng = np.random.default_rng(seed)
    off = int(rng.integers(0, len(CORPUS) - 2 * dict_len))
    dic = CORPUS[off:off + dict_len]
    doc = bytearray(dic)
    for i in rng.integers(0, len(doc), 40):
        doc[int(i)] = int(rng.integers(0, 256))
    for _ in range(20):
        i = int(rng.integers(0, len(doc)))
        j = int(rng.integers(0, len(CORPUS) - 200))
        doc[i:i] = CORPUS[j:j + int(rng.integers(5, 200))]
    tail = max(doc_len - len(doc), 0)
    doc += bytes(rng.integers(0, 256, tail // 4, dtype=np.uint8))
    doc += CORPUS[off + dict_len:off + dict_len + tail - tail // 4]
    return dic, bytes(doc[:doc_len])


def decodes(stream, doc, dic):
    """The stream decodes to `doc` with `dic` under the plain reference,
    the port's decoder and the native decoder."""
    assert reference.decompress(stream, dic) == doc
    assert bt.decompress(stream, dictionary=dic) == doc
    assert native.decode(stream, compound=dic) == doc


def card(doc, dic, lgwin=22):
    return bt.compress(doc, quality=11, lgwin=lgwin, dictionary=dic,
                       encoder="device", device="cpu")


# -- (a) the card route against the Python pipeline ---------------------------

PAIRS = {
    # the whole dictionary rides in the bucket's padding
    "halo holds the dictionary": (1, 40_000, 60_000),
    # part of it: the rest is reached by the seed parse's copies
    "halo holds its tail": (2, 100_000, 120_000),
    # two segments: the first full, the second with the input's own
    # bytes before it
    "two segments": (3, 120_000, 150_000),
}


@pytest.mark.parametrize("case", list(PAIRS))
def test_the_card_route_decodes_and_keeps_up_with_the_pipeline(case):
    dic, doc = dcb_pair(*PAIRS[case])
    out = card(doc, dic)
    decodes(out, doc, dic)
    pipeline = bt.compress(doc, quality=11, dictionary=dic,
                           encoder="python", device="cpu")
    assert native.decode(pipeline, compound=dic) == doc
    assert len(out) <= 1.01 * len(pipeline), (len(out), len(pipeline))
    assert reference.window_bits(out) == 22


# -- (b) past the window ------------------------------------------------------

def test_copies_reach_the_dictionary_past_the_window():
    """lgwin 16: the window is 65,520 bytes, and 100 KB of dictionary lie
    before 120 KB of input; the DP's halo candidates and the seed parse
    reach every dictionary byte as a compound reference."""
    dic, doc = dcb_pair(2, 100_000, 120_000)
    trace.enable(True)
    out = card(doc, dic, lgwin=16)
    trace.enable(False)
    got = trace.counters()
    assert got["dcb.far_bytes"] > 0
    assert got["dcb.copy_bytes"] >= got["dcb.far_bytes"]
    assert got["dcb.refs"] > 0
    decodes(out, doc, dic)
    assert reference.window_bits(out) == 16
    # the concatenated pipeline cannot reach so far
    pipeline = bt.compress(doc, quality=11, lgwin=16, dictionary=dic,
                           encoder="python", device="cpu")
    assert len(out) < len(pipeline)


# -- (c) the route, and the bytes of the routes beside it ---------------------

def test_the_route_is_the_streamed_q11_route(monkeypatch):
    dic, doc = dcb_pair(1, 40_000, 60_000)
    stores = []
    monkeypatch.setattr(PE.bitstream, "store_metablock",
                        lambda *a, **k: stores.append(1))
    trace.enable(True)
    out = card(doc, dic)
    trace.enable(False)
    names = {s.name for s in trace.spans()}
    assert {"request", "dcb.seed", "dp.dict-probe", "dp.dispatch",
            "dp.collect", "dcb.lift", "serialize", "serialize.wait"} <= \
        names
    assert "match-find" not in names and not stores
    decodes(out, doc, dic)


def test_a_card_route_refuses_a_dictionary_off_v3():
    dic, doc = dcb_pair(1, 40_000, 60_000)
    arr = np.frombuffer(doc, np.uint8)
    for dp, base in ((O.DPConfig(mode="v1"), 0), (None, 5)):
        with pytest.raises(ValueError, match="raw dictionary"):
            O.find_matches_optimal(arr, MAXD22, base, device="cpu", dp=dp,
                                   dictionary=dic)


def _sha(b):
    return hashlib.sha256(b).hexdigest()


def test_auto_with_a_dictionary_and_the_card_route_keep_their_bytes(
        monkeypatch):
    """Digests from the parent commit: "auto" with a raw dictionary is
    the native encoder's, and the card route without a dictionary (64 KiB
    segments) is unchanged."""
    dic, doc = CORPUS[100_000:160_000], CORPUS[130_000:430_000]
    assert _sha(bt.compress(doc, quality=11, lgwin=22, dictionary=dic)) == \
        "5f909d201aef0edfadadcca2b55bd2cf1b8950f1987807ae2b7b1bdd07008419"
    monkeypatch.setattr(O, "SEG_V3", 1 << 16)
    monkeypatch.setattr(O, "BUCKETS_V3", [1 << 16])
    monkeypatch.setattr(PE, "MIN_DEVICE_INPUT", 1 << 18)
    out = bt.compress(CORPUS[:300_000], quality=11, device="cpu")
    assert _sha(out) == \
        "b95b6bf738ab4c7441bdde027b99b6f0e219ea33ce45a3b238758540ba304644"


# -- (d) K10 with a dictionary, the lift, the compound writer -----------------

def _k10(data, npos, maxd, ranks, base):
    key = O.edge_keys_plain(data, npos, 4)
    key_s, order = torch.sort(key, stable=True)
    return O.edge_ranks_plain(key_s, order, data, npos, maxd, ranks, base)


def test_k10_takes_sources_in_the_dictionary_at_any_distance():
    """A buffer of 64 KiB whose first 24 KiB are the dictionary's tail
    (base -24 KiB) and a window of 1,008 bytes: every candidate copies
    equal bytes, lies within the window or in the dictionary, and a
    dictionary source's copy stops at the dictionary's end; with base 0
    or more the candidates are those of base 0."""
    dic, doc = dcb_pair(4, 24 << 10, 40 << 10)
    buf = np.frombuffer(dic + doc, np.uint8)
    data = torch.from_numpy(buf.copy())
    n, npos, maxd, h = len(buf), len(buf) - 3, 1008, 24 << 10
    ranks = tuple(range(1, 13)) + (16,)
    got = _k10(data, npos, maxd, ranks, -h)
    packed = got.numpy().astype(np.int64)
    ln, dist = packed >> 25, packed & O.MASK25
    pos = np.arange(n)[:, None].repeat(len(ranks), 1)
    live = ln >= 2
    sp = pos - h  # stream positions
    in_dict = dist > sp
    assert live.any() and (live & in_dict & (dist > maxd)).any()
    assert (~live | in_dict | (dist <= maxd)).all()
    assert (~(live & in_dict) | (ln <= dist - sp)).all()
    for p, k in zip(*np.nonzero(live)):
        a, d, ll = int(p), int(dist[p, k]), int(ln[p, k])
        assert (buf[a:a + ll] == buf[a - d:a - d + ll]).all()
    base0 = _k10(data, npos, maxd, ranks, 0)
    assert torch.equal(_k10(data, npos, maxd, ranks, 1 << 20), base0)
    assert not torch.equal(got, base0)


def test_the_history_seed_parse_indexes_the_dictionary_alone():
    """native.find_matches with `start`: no match before it, every match
    copies equal bytes from within the window, those reaching before
    `start` from the dictionary; and the route's seed covers the input
    about as the parse of both does."""
    dic, doc = dcb_pair(5, 100_000, 120_000)
    cat = dic + doc
    D, lgwin = len(dic), 18
    p, l, d = (a.astype(np.int64) for a in native.find_matches(
        cat, 9, lgwin, start=D))
    buf = np.frombuffer(cat, np.uint8)
    assert len(p) and (p >= D).all() and (d <= (1 << lgwin) - 16).all()
    assert (p[1:] >= p[:-1] + l[:-1]).all()
    for a, ln, dist in zip(p, l, d):
        assert (buf[a:a + ln] == buf[a - dist:a - dist + ln]).all()
    assert (p - d < D).any()
    full = native.find_matches(cat, 9, lgwin)
    seed = O._seed_parse_dcb(O.RawDictionary(buf, D), MAXD22, 9)
    both = full[1][full[0] >= D].astype(np.int64).sum()
    assert seed[1].sum() >= 0.99 * both


def _matches(fn, data, *args):
    """One call of a native match finder by its C name: (pos, len,
    dist) as lists."""
    n = len(data)
    cap = n // 4 + 16
    out = [np.empty(cap, np.uint32) for _ in range(3)]
    cnt = native.ctypes.c_size_t()
    rc = getattr(native.get_lib(), fn)(
        data, n, *args, *(native._ptr(a) for a in out), cap,
        native.ctypes.byref(cnt))
    assert rc == 0
    return [a[:cnt.value].tolist() for a in out]


@pytest.mark.parametrize("quality,lgwin,case", [
    (9, 18, "pair"), (9, 22, "corpus"), (5, 16, "corpus"),
    (2, 22, "pair"), (9, 10, "random")])
def test_find_matches_after_from_zero_is_btpu_find_matches(quality, lgwin,
                                                           case):
    """btpu_history.c's copy of btpu_find_matches's loop, called from
    position 0 (nothing indexed ahead), gives the verbatim matcher's
    parse match for match."""
    if case == "pair":
        dic, doc = dcb_pair(5, 100_000, 120_000)
        data = dic + doc
    elif case == "corpus":
        data = CORPUS[:300_000]
    else:  # runs of misses longer than 512 positions, then repeats
        noise = np.random.default_rng(3).integers(
            0, 256, 20_000, dtype=np.uint8).tobytes()
        data = noise + CORPUS[:100_000] + noise
    want = _matches("btpu_find_matches", data, quality, lgwin)
    assert len(want[0]) > 100
    assert _matches("btpu_find_matches_after", data, 0, quality,
                    lgwin) == want


def test_one_parse_under_both_serializers_decodes():
    """tools/dcb_serializers: the route's spans laid end to end are its
    parse (no two matches overlap, flag 1 only into the
    dictionary), and the Python serializer writes them with and without
    its NPOSTFIX/NDIRECT search into streams that decode."""
    from brotli_tpu_torch.tools import dcb_serializers as T
    dic, doc = dcb_pair(1, 40_000, 60_000)
    out, (m, lens, dists, flags) = T.route_matches(doc, dic, 11, 22,
                                                   device="cpu")
    assert out == bt.compress(doc, quality=11, lgwin=22, dictionary=dic,
                              encoder="device", device="cpu")
    assert (m[1:] >= m[:-1] + lens[:-1]).all()
    assert m[-1] + lens[-1] <= len(doc)
    assert (flags == 1).sum() > 10
    assert (dists[flags == 1] > np.minimum(m[flags == 1], MAXD22)).all()
    for search in (True, False):
        s = T.python_serialized(doc, dic, (m, lens, dists, flags), 11, 22,
                                search)
        assert native.decode(s, compound=dic) == doc


def test_lift_compound_cuts_at_the_dictionary_end():
    """Doc coordinates with concatenated distances, D = 100, maxback 50:
    a copy from the dictionary cut at its end, the rest from the input's
    start; one past the window within the input dropped; a static word
    kept as it is."""
    D, maxback = 100, 50
    m = np.array([10, 40, 60, 80, 200])
    lens = np.array([8, 30, 6, 5, 7])
    dists = np.array([30, 60, 70, 55, 300])
    flags = np.array([0, 0, 0, 0, 2005])
    trace.enable(True)
    got = O.lift_compound(m, lens, dists, flags, D, maxback)
    trace.enable(False)
    want = (
        # at 10: source -20, 8 bytes would run to -12 < 0: compound,
        #        distance min(10, 50) + 30 - 10 = 30
        # at 40: source -20, cut after 20 bytes; the rest at 60 from
        #        the input's start, distance 60 (> 50: left to literals)
        # at 60: source -10, 6 bytes: cut after 10? no, 6 < 10 bytes
        #        remain: compound, distance 50 + 70 - 60 = 60
        # at 80: source 25, within the input past the window: dropped
        # at 200: the static word
        [10, 40, 60, 200], [8, 20, 6, 7], [30, 60, 60, 300],
        [1, 1, 1, 2005])
    for g, w in zip(got, want):
        assert g.tolist() == w
    assert trace.counters() == {"dcb.refs": 3, "dcb.copy_bytes": 34,
                                "dcb.far_bytes": 26}
    # the rest of a copy runs on from the input's start where the
    # window allows
    got = O.lift_compound(np.array([5]), np.array([12]), np.array([9]),
                          np.array([0]), D, maxback)
    assert [g.tolist() for g in got] == [[5, 9], [4, 8], [9, 9], [1, 0]]


def _serialize(doc, matches, dic_len, lo=0, hi=None, ring=None,
               lgwin=16):
    hi = len(doc) if hi is None else hi
    return native.serialize_region(
        doc, lo, hi, [np.asarray(a, np.int64) for a in matches], 11, lgwin,
        ring=ring, write_header=lo == 0, is_last=hi >= len(doc),
        align_end=True, dict_len=dic_len)


def test_the_native_writer_takes_compound_references():
    """Flag-1 matches written natively, one ending exactly at the
    dictionary's end and one past the window; a span boundary whose
    distance ring carries a compound distance into the next span, which
    repeats it; the output decodes under the three decoders."""
    rng = np.random.default_rng(7)
    dic = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    maxback = (1 << 16) - 16
    # the input: a copy of the dictionary's last 300 bytes at 0, random
    # bytes, then dictionary bytes 1000..1400 at 70,000 (past the
    # window), and again at 80,000 (the next span)
    doc = bytearray(rng.integers(0, 256, 90_000, dtype=np.uint8))
    doc[0:300] = dic[-300:]
    doc[70_000:70_400] = dic[1000:1400]
    doc[75_000:75_400] = dic[1000:1400]
    doc = bytes(doc)

    def comp(p, src):
        return min(p, maxback) + len(dic) - src
    first = ([0, 70_000], [300, 400], [comp(0, 4700), comp(70_000, 1000)],
             [1, 1])
    blob1, ring = _serialize(doc, first, len(dic), 0, 72_000)
    assert ring[0] == comp(70_000, 1000)
    # past the window the same distance names the same byte: 1000
    second = ([75_000], [400], [comp(75_000, 1000)], [1])
    blob2, _ = _serialize(doc, second, len(dic), 72_000, len(doc),
                          ring=ring)
    decodes(blob1 + blob2, doc, dic)


@pytest.mark.parametrize("bad", [
    "past the dictionary's end", "inside the window", "past the compound "
    "region", "a custom word's flag"])
def test_the_native_writer_refuses_what_it_cannot_write(bad):
    dic_len = 5000
    doc = bytes(range(256)) * 40
    m, ln, d, f = {
        "past the dictionary's end": (100, 10, 100 + 5, 1),
        "inside the window": (100, 10, 50, 1),
        "past the compound region": (100, 10, 100 + dic_len + 1, 1),
        "a custom word's flag": (100, 10, 50, 1500),
    }[bad]
    with pytest.raises(ValueError, match="unsupported parameters"):
        _serialize(doc, ([m], [ln], [d], [f]), dic_len)


def test_the_native_writer_cuts_a_reference_at_its_metablock_grid():
    """btpu_serialize's metablocks are 4 MiB from the region's start; a
    reference across the line is cut there, the right piece given the
    distance of its own first dictionary byte (past the window, where an
    LZ copy's piece would keep the distance)."""
    rng = np.random.default_rng(8)
    dic = bytes(rng.integers(0, 256, 20_000, dtype=np.uint8))
    doc = bytearray(rng.integers(0, 16, (4 << 20) + 20_000,
                                 dtype=np.uint8))
    at = (4 << 20) - 6_000
    doc[at:at + 12_000] = dic[2_000:14_000]
    doc = bytes(doc)
    maxback = (1 << 16) - 16
    ref = ([at], [12_000], [maxback + len(dic) - 2_000], [1])
    out, _ = _serialize(doc, ref, len(dic))
    assert native.decode(out, compound=dic) == doc


# -- (e) the Python pipeline past the window ----------------------------------

@pytest.mark.parametrize("quality", [5, 9])
def test_the_python_pipeline_past_the_window_decodes(quality):
    """60 KB of dictionary and 100 KB of input at lgwin 16: the matchers
    run over both laid end to end, and a static word found past the
    window there must sit past the compound region in the stream (the
    JAX package wrote it maxback + 1 + offset, inside the dictionary's
    addresses, and its streams fail with DICTIONARY)."""
    dic, doc = CORPUS[500_000:560_000], CORPUS[540_000:640_000]
    out = bt.compress(doc, quality=quality, lgwin=16, dictionary=dic,
                      encoder="python", backend="numpy")
    decodes(out, doc, dic)
