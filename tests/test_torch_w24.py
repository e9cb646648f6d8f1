"""The q11 route at windows wider than a DP segment (the brotli CLI's
lgwin 24 on the card's 4 MiB segments), on the CPU with the plain
versions of the kernels:

  (a) each segment past the first ranks candidates over a halo of the
      input before it: with every seed that reaches before its segment
      dropped, the stream still holds far copies (`dp.far_bytes`), which
      only the halo's candidates can give, and none without the halo;
      the streams decode under the benchmark's plain reference and the
      native decoder and declare their window;
  (b) where the window is one segment, or not wider than 4 MiB, the
      streams are byte-equal to those of the parse before halos
      (digests from the parent commit);
  (c) K10's halo rows are the rows that a halo-free run over the
      concatenated bytes gives for the segment's positions, and K9's
      wide keys (the hash's top 31 bits) rank each position's nearest
      earlier equal keys;
  (d) the halos and the far-copy counters at the card's shapes.

The DP's segments are cut to 64 KiB with buckets of 32 and 64 KiB, so
lgwin 24's window spans every segment of a 200 KB input, as it spans
four of the card's 4 MiB segments, and lgwin 22's takes no halo at any
segment size; the route's threshold is lowered to 32 KiB.
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

SEG = 1 << 16
CORPUS = build_corpus(1 << 19)


@pytest.fixture(autouse=True)
def small_segments(monkeypatch):
    """Segments and buckets cut by 64, the route's threshold to 32 KiB,
    one torch thread (several test workers share the cores), and
    tracing off and empty before and after."""
    monkeypatch.setattr(O, "SEG_V3", SEG)
    monkeypatch.setattr(O, "BUCKETS_V3", [SEG // 2, SEG])
    monkeypatch.setattr(PE, "MIN_DEVICE_INPUT", 1 << 15)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()
    torch.set_num_threads(n)


def far_doc(seed, size=200_000, copies=None):
    """Corpus text with seeded random blocks of 3,000 bytes, each written
    again between one and three segments later: copies that only a
    window wider than a segment reaches. `copies` collects each second
    copy's (position, distance)."""
    rng = np.random.default_rng(seed)
    doc = bytearray(CORPUS[:size])
    for k in range(12):
        blk = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        p = 2_000 + 5_000 * k
        q = p + int(rng.integers(SEG + 4_000, 3 * SEG - 4_000))
        doc[p:p + 3000] = blk
        if q + 3000 <= size:
            doc[q:q + 3000] = blk
            if copies is not None:
                copies.append((q, q - p))
    return bytes(doc)


def compress_counted(doc, lgwin):
    trace.enable(True)
    try:
        out = bt.compress(doc, quality=11, lgwin=lgwin, device="cpu")
    finally:
        trace.enable(False)
    got = trace.counters()
    trace.reset()
    return out, got


def decodes(stream, doc, lgwin):
    assert reference.decompress(stream) == doc
    assert native.decode(stream) == doc
    assert reference.window_bits(stream) == lgwin


def _segment_local(real):
    """The seed parse without a copy that reaches before its segment: one
    whose source lies before the segment it starts in, or that runs into
    the next segment (its part there reads before that one)."""
    def seed(arr, max_distance, base, *args, **kw):
        m, lens, dists, flags = real(arr, max_distance, base, *args, **kw)
        start = m // O.SEG_V3 * O.SEG_V3
        keep = (m - dists >= start) & ((m + lens - 1) // O.SEG_V3 ==
                                        m // O.SEG_V3)
        return m[keep], lens[keep], dists[keep], flags[keep]
    return seed


# -- (a) far copies from the halo alone ---------------------------------------

def test_far_copies_come_from_the_halo_alone(monkeypatch):
    doc = far_doc(1)
    monkeypatch.setattr(O, "_seed_parse", _segment_local(O._seed_parse))
    z = np.zeros(0, np.int64)
    monkeypatch.setattr(O, "_far_matches", lambda arr, md: (z, z, z))
    out, got = compress_counted(doc, 24)
    decodes(out, doc, 24)
    # 64, 128 and 192 KiB before the three later segments (the last
    # one's 28 KiB of the 192 in its bucket's padding)
    assert got["dp.halo_bytes"] == (1 + 2 + 3) * SEG
    assert got["dp.far_bytes"] > 12_000
    assert got["dp.far_seed_bytes"] == 0
    # lgwin 22 takes no halo: nothing reaches past the segment
    plain, got = compress_counted(doc, 22)
    decodes(plain, doc, 22)
    assert got["dp.halo_bytes"] == 0 and got["dp.far_bytes"] == 0
    assert len(out) < len(plain)


def test_the_seed_parse_and_the_halo_together():
    """With the whole seed parse, most far bytes are the seed's copies
    at the same distance; the stream decodes and is smaller than the
    one-segment window's."""
    doc = far_doc(2)
    out, got = compress_counted(doc, 24)
    decodes(out, doc, 24)
    assert 0 < got["dp.far_seed_bytes"] <= got["dp.far_bytes"]
    assert len(out) < len(bt.compress(doc, quality=11, lgwin=16,
                                      device="cpu"))


# -- (b) one segment's window: the bytes before halos -------------------------

# sha256 of the streams of the parent commit, before halos existed
BEFORE = {
    16: "11402d0cccf654ce86f2aa5faf5f0ca5fbc39c1c98aa02386317baac3d333d92",
    22: "001572f9ece593e8c0ccaab647a15ef065c64f3ceff008ed0b6f84408ca25578",
}


@pytest.mark.parametrize("lgwin", [16, 22])
def test_a_window_of_one_segment_keeps_its_bytes(lgwin):
    """lgwin 16: the window is the segment; lgwin 22: a window of 4 MiB
    takes no halo at any segment size (the tests that hold the port to
    the JAX package run 64 KiB segments at lgwin 22)."""
    doc = far_doc(3, 150_000)
    out, got = compress_counted(doc, lgwin)
    assert got["dp.halo_bytes"] == 0
    assert hashlib.sha256(out).hexdigest() == BEFORE[lgwin]
    decodes(out, doc, lgwin)


# -- (c) K10's halo rows, K9's wide keys --------------------------------------

@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("row0", [SEG // 2, SEG, 3 * SEG // 2])
def test_k10_halo_rows_are_the_concatenated_runs(row0, wide):
    """The segment's rows of `_candidates` with `row0` bytes of history
    before its bucket are the rows from row0 on of a halo-free run over
    the same bytes, on the JAX keys and on the wide ones; the history's
    sources reach the segment's rows."""
    doc = far_doc(4, row0 + SEG // 2)
    data = torch.from_numpy(np.frombuffer(doc, np.uint8).copy())
    npos = len(doc) - 3
    maxd = (1 << 18) - 16
    whole = O._candidates(data, npos, maxd, wide=wide)
    halo = O._candidates(data, npos, maxd, base=0, row0=row0, wide=wide)
    assert halo.shape == (len(doc) - row0, whole.shape[1])
    assert torch.equal(halo, whole[row0:])
    pos = torch.arange(row0, len(doc))[:, None]
    dist = (halo & ((1 << 25) - 1)).to(torch.int64)
    assert ((dist > 0) & (pos - dist < row0)).sum() > 1000
    key_s, order = torch.sort(O.edge_keys_plain(data, npos, 8, wide),
                              stable=True)
    want = O.edge_ranks_plain(key_s, order, data, npos, maxd,
                              O.LEVELS[1][1], wide=wide)
    words = torch.empty((len(doc) - row0, 16), dtype=torch.int32)
    O.edge_ranks(key_s, order, data, npos, maxd, O.LEVELS[1][1], words,
                 0, row0, wide)
    assert torch.equal(words[:, :14], want[row0:])
    assert not words[:, 14:].any()


def _h32(data, plen):
    w = [x.to(torch.int64) for x in O._words(data, plen // 4)]
    muls = (O.HASH_MUL, O.HASH_MUL2, O.HASH_MUL3, O.HASH_MUL4)
    h = 0
    for x, m in zip(w, muls):
        h = h ^ ((x * m) & 0xFFFFFFFF)
    return h


@pytest.mark.parametrize("plen", [4, 8, 16])
def test_k9_wide_keys_are_the_hash_top_bits(plen):
    """K9's wide key is the level's uint32 hash product's top 31 bits
    (minus 2**31, so live rows stay negative), with no position bits;
    the JAX key's hash (key >> 14) is its top 17. Padding rows keep the
    position, and the stable sort orders a wide key's rows by
    position."""
    n = 1 << 16
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 4, n, dtype=np.uint8)
    raw[40_000:44_096] = raw[:4096]  # equal keys at every level
    data = torch.from_numpy(raw)
    npos = n - 3 - (plen - 4)
    pos = torch.arange(n)
    live = pos < npos
    h = _h32(data, plen)
    key = O.edge_keys_plain(data, npos, plen, wide=True)
    assert torch.equal(key[live].to(torch.int64), (h[live] >> 1) - (1 << 31))
    assert torch.equal(key[~live].to(torch.int64), pos[~live])
    narrow = O.edge_keys_plain(data, npos, plen)
    assert torch.equal((narrow[live] >> 14).to(torch.int64),
                       (h[live] >> 15) - (1 << 17))
    key_s, order = torch.sort(key, stable=True)
    same = key_s[1:] == key_s[:-1]
    assert int(same.sum()) > 4000
    assert bool((order[1:][same] > order[:-1][same]).all())


def test_k10_wide_ranks_are_the_nearest_equal_keys():
    """On the wide keys K10's rank k is the k-th nearest earlier position
    with the same 31-bit hash, whatever its distance: where a JAX key's
    17-bit hash groups rows of other strings, the wide rank 1 of a
    repeated 8-byte string is its last occurrence."""
    n = 1 << 16
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.integers(0, 3, n, dtype=np.uint8))
    npos = n - 3 - 4
    maxd = (1 << 24) - 16
    key = O.edge_keys_plain(data, npos, 8, wide=True)
    key_s, order = torch.sort(key, stable=True)
    got = O.edge_ranks_plain(key_s, order, data, npos, maxd, (1, 2),
                             wide=True)
    # the previous row of the same key, by brute force over positions
    last, prev = {}, np.zeros(n, np.int64)
    for p, k in enumerate(key.tolist()):
        prev[p] = p - last[k] if (k < 0 and k in last) else 0
        if k < 0:
            last[k] = p
    dist = (got[:, 0] & ((1 << 25) - 1)).numpy()
    mlen = (got[:, 0] >> 25).numpy()
    assert np.array_equal(dist[mlen > 0], prev[mlen > 0])
    # an 8-byte string seen before: its last occurrence, at least 8 long
    assert (mlen >= 8).sum() > n // 2
    assert np.array_equal(mlen > 0, prev > 0)


# -- (d) the card's shapes ----------------------------------------------------

@pytest.mark.parametrize("lgwin,halos", [
    (22, [0, 0, 0, 0, 0]),
    (23, [0, 4, 4, 4, 4]),
    (24, [0, 4, 8, 12, 12]),
])
def test_halos_at_the_card_shapes(monkeypatch, lgwin, halos):
    """At 4 MiB segments, a 16 MiB + 16 KiB input (the deploys traffic's
    document) gets a halo of the window's reach before each segment, in
    MiB; none at lgwin 22."""
    monkeypatch.setattr(O, "SEG_V3", 1 << 22)
    monkeypatch.setattr(O, "BUCKETS_V3", [1 << 21, 1 << 22])
    n = (16 << 20) + (16 << 10)
    maxd = (1 << lgwin) - 16
    got = []
    for lo in range(0, n, O.SEG_V3):
        hi = min(lo + O.SEG_V3, n)
        got.append(O._halo(lo, hi, O._bucket_v3(hi - lo), None, maxd) >> 20)
    assert got == halos


def test_far_matches_are_exact_long_and_far():
    """The long-range matches copy exactly, FAR_MIN bytes or more, from
    further back than a segment and within the window, none overlapping
    another; they cover the planted copies that lie further back than a
    segment."""
    planted = []
    doc = far_doc(7, copies=planted)
    arr = np.frombuffer(doc, np.uint8)
    maxd = (1 << 24) - 16
    m, lens, dists = O._far_matches(arr, maxd)
    assert len(m) and (lens >= O.FAR_MIN).all()
    assert ((dists > SEG - 16) & (dists <= maxd)).all()
    assert (m[1:] >= (m + lens)[:-1]).all()
    for p, ln, d in zip(m.tolist(), lens.tolist(), dists.tolist()):
        assert doc[p:p + ln] == doc[p - d:p - d + ln]
    assert planted
    for q, d in planted:  # each second copy, as far as a later one left
        # it, nearly all covered at its distance
        intact = int((arr[q:q + 3000] == arr[q - d:q + 3000 - d]).sum())
        got = sum(max(0, min(p + ln, q + 3000) - max(p, q))
                  for p, ln, dd in zip(m.tolist(), lens.tolist(),
                                       dists.tolist()) if dd == d)
        assert intact - 128 <= got <= intact, (q, d, got, intact)
    assert O._far_matches(arr[:SEG], maxd)[0].size == 0


def test_minus_cuts_intervals_around_the_covered():
    s, e = np.array([0, 10, 40, 70]), np.array([8, 30, 60, 80])
    cs, ce = np.array([5, 15, 50]), np.array([12, 20, 75])
    ps, pe, src = O._minus(s, e, cs, ce)
    assert list(zip(ps.tolist(), pe.tolist(), src.tolist())) == [
        (0, 5, 0), (12, 15, 1), (20, 30, 1), (40, 50, 2), (75, 80, 3)]


def test_with_far_keeps_far_seeds_then_long_range_then_near():
    """A byte goes to the seed's far copy, else to a long-range match,
    else to the seed's near copy, each cut to what it keeps; pieces
    under 4 bytes go."""
    far = SEG
    seed = (np.array([0, 100, 300, 500], np.int64),
            np.array([80, 150, 100, 50], np.int64),
            np.array([10, far + 1, 20, 30], np.int64),
            np.zeros(4, np.int64))
    long_range = (np.array([50, 240, 520], np.int64),
                  np.array([120, 80, 28], np.int64),
                  np.array([far + 9, far + 7, far + 5], np.int64))
    m, lens, dists, flags = O._with_far(seed, long_range)
    # [548, 550) of the last near copy is 2 bytes: dropped
    assert list(zip(m.tolist(), lens.tolist(), dists.tolist())) == [
        (0, 50, 10), (50, 50, far + 9), (100, 150, far + 1),
        (250, 70, far + 7), (320, 80, 20), (500, 20, 30),
        (520, 28, far + 5)]
    assert not flags.any()


def test_count_far_counts_the_seed_at_the_same_distance(monkeypatch):
    """dp.far_bytes sums the copies past SEG_V3 - 16 (flags 0 only);
    dp.far_seed_bytes the bytes of them that a seed copy covers at the
    same distance."""
    far = SEG
    m = np.array([10, 500, 900, 2000, 3000], np.int64)
    lens = np.array([100, 50, 40, 30, 20], np.int64)
    dists = np.array([far, far + 5, far, 3, far + 9], np.int64)
    flags = np.array([0, 0, 0, 0, 2001], np.int64)
    seed = (np.array([0, 60, 480, 905, 2000], np.int64),
            np.array([50, 100, 40, 10, 30], np.int64),
            np.array([far, far, far + 5, far + 1, 3], np.int64),
            np.zeros(5, np.int64))
    trace.enable(True)
    O._count_far(m, lens, dists, flags, seed)
    trace.enable(False)
    # copy 0 [10, 110) at far: seed [0, 50) gives 40, [60, 160) 50;
    # copy 1 [500, 550): seed [480, 520) at far + 5 gives 20; copy 2
    # [900, 940): seed [905, 915) is at another distance
    assert trace.counters() == {"dp.far_bytes": 190,
                                "dp.far_seed_bytes": 110}
