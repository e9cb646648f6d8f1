"""K12's per-position probe against the native probe, on the CPU.

K12 (`brotli_tpu_torch/csrc/dict_probe.cu`) runs the static-dictionary
probe of `csrc/dict_probe.h` a thread a position on the card. The native
library compiles the same header into a host loop,
`native.dict_probe_gated`, with the seed gate as the intervals
`native.probe_gates` derives. These tests hold that loop, bit for
bit, to the JAX package's `brotli_tpu.native.dict_probe_all`
(`btpu_dict_probe_all`, the C walk the card replaces) on the benchmark
cells' documents and on inputs that
reach each of its rules: the case forms, the prefix forms, the ends of
the input, the word-length gate's thresholds, the seed gate and the
overflow of the output cap. `tools/probe_dict.py` holds K12 itself to
the port's `native.dict_probe_all`, which the DP's probe on a CPU tensor
returns and which is held to the JAX package's here, on the card.
"""

import numpy as np
import pytest
import torch

from benchmark import core
from brotli_tpu import native as JN
from brotli_tpu_torch import native
from brotli_tpu_torch.format import constants as C
from brotli_tpu_torch.format.dictionary import OFFSETS_BY_LENGTH
from brotli_tpu_torch.format.dictionary import SIZE_BITS_BY_LENGTH as SIZE_BITS
from brotli_tpu_torch.format.dictionary import dictionary_data
from brotli_tpu_torch.format.transforms import TRANSFORMS
from brotli_tpu_torch.ops import kernels
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.utils import trace

from test_torch_matcher import _LOGS16M

MAXD = C.max_backward_distance(22)
# the versions traffic's pairs (benchmark/traffic/versions.json)
_PAIRS = ("jquery", "zone", "trace_viewer")


def _native(data, mpos, mlen, base=0, maxback=MAXD):
    try:
        return JN.dict_probe_all(np.ascontiguousarray(data).tobytes(),
                                     mpos, mlen, base, maxback)
    except ValueError:
        return None


def _shared(data, mpos, mlen, base=0, maxback=MAXD):
    lo, hi = native.probe_gates(mpos, mlen)
    try:
        return native.dict_probe_gated(data, lo, hi, base, maxback)
    except ValueError:
        return None


def _same(data, mpos, mlen, base=0, maxback=MAXD):
    """Both probes' (positions, payloads), asserted bit-equal."""
    want = _native(data, mpos, mlen, base, maxback)
    got = _shared(data, mpos, mlen, base, maxback)
    assert (want is None) == (got is None)
    if want is not None:
        for a, b in zip(want, got):
            assert a.dtype == b.dtype == np.uint32
            np.testing.assert_array_equal(a, b)
    return want


def _seed(arr):
    return O._seed_parse(arr, MAXD, 0)


def _tids(hits):
    """The transform id of each hit (dictoff = tid << size_bits + idx)."""
    pay = hits[1].astype(np.int64)
    wlen = (pay >> 17) & 0x1F
    return (pay & ((1 << 17) - 1)) >> np.array(SIZE_BITS)[wlen]


def _words(rng, k):
    """k dictionary words, drawn from every length."""
    blob = dictionary_data()
    out = []
    lens = rng.integers(4, 25, k)
    for L in lens:
        i = int(rng.integers(0, 1 << SIZE_BITS[L]))
        off = OFFSETS_BY_LENGTH[L] + i * int(L)
        out.append(blob[off:off + int(L)])
    return out


@pytest.fixture(scope="module")
def image():
    return native.dict_index_image()


def _head(image):
    h = image[:176].view(np.uint32)
    return dict(size=h[0], start=h[1], of_start=h[2], entries=h[3],
                of_entries=h[4], suf=h[5], pre=h[6], pre_start=h[7],
                size_bits=h[8], pool=h[9], blob=h[10], n_entries=h[11],
                n_of_entries=h[12], pool_len=h[13], blob_len=h[14],
                nsuf=int(h[15]), npre=int(h[16]),
                uc_first_id=int(h[17:18].view(np.int32)[0]),
                uc_all_id=int(h[18:19].view(np.int32)[0]),
                omit_last_id=h[19:29].view(np.int32),
                omit_first_id=h[29:39].view(np.int32), reach=h[39])


def test_exported_index_has_dict_index_init_sizes(image):
    """The image holds the tables dict_index_init builds: every word of
    lengths 4-24 in its hash bucket, an omit-first form for each word
    and each k with a bare OMIT_FIRST_k transform that leaves 4 bytes,
    the affix forms of the identity and upper-case cores, the pool and
    the dictionary's bytes; and a reach K12 stages."""
    h = _head(image)
    assert h["size"] == len(image) and len(image) % 16 == 0
    blob = dictionary_data()
    assert bytes(image[h["blob"]:h["blob"] + h["blob_len"]]) == blob
    words = sum(1 << SIZE_BITS[L] for L in range(4, 25))
    assert h["n_entries"] == words == 13_504

    def first(op):
        return next((t for t, (p, o, s) in enumerate(TRANSFORMS)
                     if o == op and not p and not s), -1)

    omit_first = [None] + [first(f"OMIT_FIRST_{k}") for k in range(1, 10)]
    omit_last = [None] + [first(f"OMIT_LAST_{k}") for k in range(1, 10)]
    assert list(h["omit_first_id"][1:]) == omit_first[1:]
    assert list(h["omit_last_id"][1:]) == omit_last[1:]
    assert h["uc_first_id"] == first("UPPERCASE_FIRST")
    assert h["uc_all_id"] == first("UPPERCASE_ALL")
    forms = [(p, s) for p, o, s in TRANSFORMS
             if (p or s) and o in ("IDENTITY", "UPPERCASE_FIRST",
                                   "UPPERCASE_ALL")]
    assert h["nsuf"] == sum(1 for p, _ in forms if not p)
    assert h["npre"] == sum(1 for p, _ in forms if p)
    assert h["nsuf"] <= 121 and h["npre"] <= 121
    assert h["n_of_entries"] == sum(
        (1 << SIZE_BITS[L]) * sum(1 for k in range(1, 10)
                                  if L - k >= 4 and omit_first[k] >= 0)
        for L in range(4, 25))
    start = image[h["start"]:h["start"] + 4 * ((1 << 15) + 1)].view(np.uint32)
    of_start = image[h["of_start"]:h["of_start"] + 4 * ((1 << 15) + 1)].view(
        np.uint32)
    assert start[0] == 0 and start[-1] == h["n_entries"]
    assert of_start[0] == 0 and of_start[-1] == h["n_of_entries"]
    assert (np.diff(start.astype(np.int64)) >= 0).all()
    assert (np.diff(of_start.astype(np.int64)) >= 0).all()
    ent = image[h["entries"]:h["entries"] + 8 * h["n_entries"]].view(
        np.uint32).reshape(-1, 2)
    lens = (ent[:, 1] >> 16) & 0xFF
    assert np.bincount(lens, minlength=25)[4:25].tolist() == [
        1 << SIZE_BITS[L] for L in range(4, 25)]
    # each word sits in the bucket of the hash of its first 4 bytes
    for e in np.random.default_rng(0).integers(0, h["n_entries"], 200):
        off = int(ent[e, 0])
        v = int.from_bytes(blob[off:off + 4], "little")
        bucket = ((v * 0x9E3779B1) & 0xFFFFFFFF) >> 17
        assert start[bucket] <= e < start[bucket + 1]
    longest = max(len(p) for p, _ in forms) + 24 + max(len(s) for _, s in
                                                      forms)
    assert h["reach"] == longest == 37
    # within the limits of csrc/dict_probe.h (K12's shared copies)
    assert h["reach"] <= 64 and h["pool_len"] <= 512


@pytest.fixture(scope="module")
def bulk16m():
    """The first document of `q11_w22.bulk16m` at seed 0, and its seed
    parse."""
    gen = core.load_module("gen", "smoke_corpus")
    arr = np.frombuffer(gen.document(16 << 20, 0, vocab_seed=0), np.uint8)
    return arr, _seed(arr)


def test_bulk16m_document(bulk16m):
    arr, seed = bulk16m
    hits = _same(arr, seed[0], seed[1])
    assert hits is not None and len(hits[0]) > 1_000_000


def test_bulk16m_first_segment(bulk16m):
    """The early first probe: the first SEG_V3 bytes with their own
    seed parse (find_matches_optimal's dp.seed1)."""
    arr = bulk16m[0][:O.SEG_V3]
    seed = _seed(arr)
    assert len(_same(arr, seed[0], seed[1])[0]) > 100_000


def test_logs16m_document():
    gen = core.load_module("gen", "access_log")
    arr = np.frombuffer(gen.document(16 << 20, 7, **_LOGS16M), np.uint8)
    seed = _seed(arr)
    assert len(_same(arr, seed[0], seed[1])[0]) > 1000


@pytest.mark.parametrize("pair", range(len(_PAIRS)), ids=_PAIRS)
def test_versions_document_after_its_dictionary(pair):
    """A `versions` document probed as the dcb route does: base the
    dictionary's size, its window past the dictionary, the seeds of the
    parse with the dictionary as history."""
    gen = core.load_module("gen", "versions")
    params = core.load_json("traffic", "versions")["params"]
    doc = gen.documents(0, **params)[pair]
    dic = gen.dictionaries(0, **params)[pair]
    hist = O.RawDictionary(np.frombuffer(dic + doc, np.uint8), len(dic))
    seed = O._seed_parse_dcb(hist, MAXD, O.DPConfig.seed_q)
    arr = np.frombuffer(doc, np.uint8)
    hits = _same(arr, seed[0], seed[1], len(dic), MAXD + len(dic))
    assert len(hits[0]) > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_random_bytes(seed):
    arr = np.random.default_rng(seed).integers(0, 256, 1 << 20,
                                               dtype=np.uint8)
    s = _seed(arr)
    _same(arr, s[0], s[1])


def _uppercase_text(rng, k):
    """Dictionary words in upper case, capitalised and after the
    transforms' prefixes (" the ", ", ", ...), with their suffixes, each
    followed by 120 bytes that no form matches (0x80-0xBF), so the hits
    stay under the cap without seeds."""
    prefixes = sorted({p for p, _, _ in TRANSFORMS if p})
    suffixes = sorted({s for _, _, s in TRANSFORMS if s})
    parts = []
    for w in _words(rng, k):
        kind = rng.integers(0, 4)
        if kind == 1:
            w = w[:1].upper() + w[1:]
        elif kind == 2:
            w = w.upper()
        parts.append(prefixes[rng.integers(0, len(prefixes))] + w +
                     suffixes[rng.integers(0, len(suffixes))] +
                     rng.integers(0x80, 0xC0, 120, dtype=np.uint8).tobytes())
    return np.frombuffer(b"".join(parts), np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uppercase_and_prefix_forms(seed, image):
    """Text that reaches the upper-case-first, upper-case-all and prefix
    forms; no seeds, so every position is probed."""
    arr = _uppercase_text(np.random.default_rng(seed), 6000)
    z = np.zeros(0, np.int64)
    hits = _same(arr, z, z)
    assert hits is not None
    h = _head(image)
    tids = set(_tids(hits).tolist())
    assert h["uc_first_id"] in tids and h["uc_all_id"] in tids
    prefixed = {t for t, (p, o, _) in enumerate(TRANSFORMS) if p}
    upper_prefixed = {t for t in prefixed
                      if TRANSFORMS[t][1] != "IDENTITY"}
    assert tids & prefixed and tids & upper_prefixed


@pytest.mark.parametrize("cut", [1, 2, 3, 4, 5, 7])
def test_input_that_ends_mid_word(cut):
    """The probe's reads stop at n: a word (and its suffix forms) cut by
    the input's end is not matched past it."""
    rng = np.random.default_rng(cut)
    text = _uppercase_text(rng, 300).tobytes()
    last = _words(rng, 1)[0] + b" the "
    arr = np.frombuffer(text + last[:len(last) - cut], np.uint8)
    z = np.zeros(0, np.int64)
    assert _same(arr, z, z) is not None


@pytest.mark.parametrize("base,maxback", [
    ((1 << 12) - 2, MAXD), ((1 << 12) - 1, MAXD), ((1 << 12) - 700, MAXD),
    ((1 << 18) - 2, MAXD), ((1 << 18) - 1, MAXD), ((1 << 18) - 700, MAXD),
    (1 << 20, (1 << 12) - 2), (1 << 20, (1 << 12) - 1),
    (1 << 20, (1 << 18) - 2), (1 << 20, (1 << 18) - 1), (0, 0)])
def test_word_length_gate_thresholds(base, maxback):
    """The gate is 5, 6 or 7 as min(p + base, maxback) + 1 reaches 2**12
    and 2**18: inputs that start on either side of each threshold, or
    cross it, and windows that cap it."""
    arr = _uppercase_text(np.random.default_rng(base ^ maxback), 400)
    z = np.zeros(0, np.int64)
    hits = _same(arr, z, z, base, maxback)
    assert hits is not None and len(hits[0])


def _walk(n, mpos, mlen):
    """The positions btpu_dict_probe_all's loop probes: its seed walk,
    line for line."""
    out, mi, p = [], 0, 0
    while p + 4 <= n:
        while mi < len(mpos) and mpos[mi] + mlen[mi] <= p:
            mi += 1
        if mi < len(mpos) and mpos[mi] <= p and mlen[mi] >= 12:
            p = mpos[mi] + mlen[mi]
            continue
        out.append(p)
        p += 1
    return np.array(out, np.int64)


def _ungated(n, gates):
    p = np.arange(max(n - 3, 0))
    lo, hi = gates.astype(np.int64)
    i = np.searchsorted(lo, p, side="right") - 1
    gated = (i >= 0) & (p < hi[np.maximum(i, 0)])
    return p[~gated]


def test_seeds_of_11_and_12_across_tile_edges(bulk16m):
    """Seeds of length 11 and 12 that start before and end after a
    4,096-position edge (and K12's 2,048-position tiles): the 12 gates
    its positions, the 11 does not."""
    arr = bulk16m[0][:1 << 16].copy()
    mpos = np.array([4090, 8185, 12283, 16380, 20470, 24570], np.int64)
    mlen = np.array([11, 12, 11, 12, 12, 11], np.int64)
    gates = native.probe_gates(mpos, mlen)
    np.testing.assert_array_equal(gates, [[8185, 16380, 20470],
                                          [8197, 16392, 20482]])
    np.testing.assert_array_equal(_ungated(len(arr), gates),
                                  _walk(len(arr), mpos, mlen))
    hits = _same(arr, mpos, mlen)
    for lo, hi in gates.T:
        assert not ((hits[0] >= lo) & (hits[0] < hi)).any()
    assert ((hits[0] >= 4090) & (hits[0] < 4101)).any()


@pytest.mark.parametrize("seed", range(6))
def test_probe_gates_follow_the_walk(seed):
    """Seeds that overlap, nest, end together or run unsorted: the gates
    skip exactly what the C walk skips, and the probes agree."""
    rng = np.random.default_rng(seed)
    n = 1 << 14
    k = 400
    mpos = rng.integers(0, n, k)
    if seed < 4:
        mpos = np.sort(mpos)
    mlen = rng.integers(0, 80, k)
    if seed == 1:
        mlen[::7] = 12
    gates = native.probe_gates(mpos, mlen)
    assert (gates[0] < gates[1]).all()
    assert (gates[0, 1:] >= gates[1, :-1]).all()
    np.testing.assert_array_equal(_ungated(n, gates), _walk(n, mpos, mlen))
    arr = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    arr[::3] = 32
    _same(arr, mpos, mlen)


def test_dictionary_dense_input_overflows_to_nothing():
    """More hits than one per 8 bytes: both probes refuse, and the DP's
    probe returns no hits and counts the overflow."""
    text = b" ".join(_words(np.random.default_rng(5), 20_000))
    arr = np.frombuffer(text, np.uint8)
    z = np.zeros(0, np.int64)
    assert _same(arr, z, z) is None
    trace.reset()
    trace.enable()
    try:
        dpos, dpay, dwlen = O._dict_probe_global(arr, [(z, z)], 0, MAXD)
        counts = trace.counters()
    finally:
        trace.enable(False)
        trace.reset()
    assert len(dpos) == len(dpay) == len(dwlen) == 0
    assert counts["dp.dict-probe.overflows"] == 1
    assert counts["dp.dict-probe.hits"] == 0
    assert counts["dp.dict-probe.bytes"] == len(arr)
    assert counts["dp.dict-probe.positions"] == len(arr) - 3


def test_probe_on_a_cpu_tensor_is_native(bulk16m):
    """With the input uploaded to the CPU, the DP's probe returns
    native.dict_probe_all's arrays, which are the JAX package's, and
    counts what it probed."""
    arr = bulk16m[0][:1 << 20]
    seed = _seed(arr)
    want = native.dict_probe_all(arr.tobytes(), seed[0], seed[1], 0, MAXD)
    for a, b in zip(want, _native(arr, seed[0], seed[1])):
        np.testing.assert_array_equal(a, b)
    trace.reset()
    trace.enable()
    try:
        got = O._dict_probe_global(arr, [seed], 0, MAXD,
                                   torch.from_numpy(arr.copy()))
        counts = trace.counters()
    finally:
        trace.enable(False)
        trace.reset()
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], (want[1] >> 17) & 0x1F)
    assert counts["dp.dict-probe.hits"] == len(want[0])
    assert counts["dp.dict-probe.overflows"] == 0
    assert counts["dp.dict-probe.bytes"] == len(arr)
    assert counts["dp.dict-probe.positions"] == len(
        _walk(len(arr), seed[0].tolist(), seed[1].tolist()))


def _k12_stand_in(image_np):
    """kernels.dict_probe's output contract, computed by the shared
    per-position code on the CPU: [count, 0, positions, payloads] with
    the hits written only within the cap."""
    def launch(data, n, gates, base, max_distance, image):
        assert gates.dtype == torch.int32 and gates.shape[0] == 2
        assert torch.equal(image, torch.from_numpy(image_np))
        cap = max(n // 8 + 64, 1024)
        out = torch.full((2 + 2 * cap,), -7, dtype=torch.int32)
        g = gates.numpy().view(np.uint32)
        try:
            pos, pay = native.dict_probe_gated(data[:n].numpy(), g[0], g[1],
                                               base, max_distance)
        except ValueError:
            out[0] = cap + 1
            return out
        out[0], out[1] = len(pos), 0
        out[2:2 + len(pos)] = torch.from_numpy(pos.view(np.int32))
        out[2 + cap:2 + cap + len(pos)] = torch.from_numpy(pay.view(np.int32))
        return out
    return launch


@pytest.mark.parametrize("dense", [False, True])
def test_card_output_is_read_back_in_order(monkeypatch, image, bulk16m,
                                           dense):
    """_dict_probe_card reads K12's one buffer (the count, then the
    positions and payloads at the cap's offsets) into native's arrays,
    and a count past the cap into None."""
    monkeypatch.setattr(kernels, "dict_probe", _k12_stand_in(image))
    monkeypatch.setattr(O, "_DICT_IMAGE", {})
    if dense:
        arr = np.frombuffer(b" ".join(_words(np.random.default_rng(5),
                                             20_000)), np.uint8)
        z = np.zeros(0, np.int64)
        seed = (z, z)
    else:
        arr = bulk16m[0][:1 << 19]
        seed = _seed(arr)
    buf = torch.zeros(len(arr) + 100, dtype=torch.uint8)
    buf[:len(arr)] = torch.from_numpy(arr.copy())
    got = O._dict_probe_card(buf, len(arr), native.probe_gates(*seed[:2]), 0,
                             MAXD)
    want = _native(arr, seed[0], seed[1])
    if dense:
        assert got is None and want is None
        return
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
