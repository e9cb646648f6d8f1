"""The port's host matchers and the host helpers of base64 mode and the
serialized shared dictionaries, against the JAX package on the CPU.

  (a) enc/matcher: `hash4`, `distance_bit_cost`, `_dist_codes`,
      `_tz_bytes`, `find_matches_vectorized` (with and without the
      static dictionary, with a base, with a cost model),
      `find_matches_costmodel`, `find_matches_greedy`, and the numpy
      pass of `add_dictionary_matches` (below 16 KiB, with
      native_pass=False above it as the JAX package's
      BROTLI_TPU_NO_NATIVE_DICT, and where the native pass runs out of
      room);
  (b) enc/static_dict: `probe` and `dict_distance` at every position;
  (c) enc/base64_mode: `detect_regions`, `region_mask`,
      `drop_matches_in_regions`, `base64_code_lengths`;
  (d) format/shared_dictionary: `serialize` and `parse` (a round trip,
      and every blob the JAX package's tests build), `decode_reference`
      and `apply_transform`;
  (e) enc/custom_dict: `build_index` and `add_custom_matches`;
  (f) the tools optref, draw_histogram, draw_diff and dictgen.

Every array and every byte must be the JAX function's exactly (no
tolerance). Inputs are in-repo only: the port's corpus generator,
tests/fuzz_corpus/ and numpy-seeded bytes.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from brotli_tpu import native as JN
from brotli_tpu.enc import base64_mode as JB64
from brotli_tpu.enc import custom_dict as JCD
from brotli_tpu.enc import matcher as JM
from brotli_tpu.enc import static_dict as JSD
from brotli_tpu.format import context as JCTX
from brotli_tpu.format import shared_dictionary as JSHD
from brotli_tpu.tools import dictgen as JDG
from brotli_tpu.tools import draw_diff as JDD
from brotli_tpu.tools import draw_histogram as JDH
from brotli_tpu.tools import optref as JOR
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.enc import base64_mode as PB64
from brotli_tpu_torch.enc import custom_dict as PCD
from brotli_tpu_torch.enc import matcher as PM
from brotli_tpu_torch.enc import static_dict as PSD
from brotli_tpu_torch.format import constants as C
from brotli_tpu_torch.format import context as PCTX
from brotli_tpu_torch.format import shared_dictionary as PSHD
from brotli_tpu_torch.tools import dictgen as PDG
from brotli_tpu_torch.tools import draw_diff as PDD
from brotli_tpu_torch.tools import draw_histogram as PDH
from brotli_tpu_torch.tools import optref as POR
from brotli_tpu_torch.tools.corpus import base64_page, build_corpus

REPO = pathlib.Path(__file__).resolve().parent.parent
MAXD = C.max_backward_distance(22)
CORPUS = build_corpus(1 << 20)
FUZZ = sorted((REPO / "tests" / "fuzz_corpus").glob("*.bin"))


def _inputs():
    """name -> bytes: the corpus's C source, its dictionary text, its
    random tail, a small-alphabet seeded input (long repeats), and the
    largest fuzz-corpus file."""
    rng = np.random.default_rng(7)
    return {
        "source": CORPUS[20_000:60_000],
        "text": CORPUS[600_000:640_000],
        "random": CORPUS[-30_000:],
        "alphabet4": rng.integers(0, 4, 30_000).astype(np.uint8).tobytes(),
        "fuzz": max((p.read_bytes() for p in FUZZ), key=len),
    }


INPUTS = _inputs()


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _arr(name):
    return np.frombuffer(INPUTS[name], np.uint8)


# -- (a) enc/matcher -------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_matcher_helpers(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256 if seed else 3, 5000).astype(np.uint8)
    for bits in (12, 17, 18):
        np.testing.assert_array_equal(PM.hash4(data, bits),
                                      JM.hash4(data, bits))
    dists = rng.integers(1, 1 << 24, 3000)
    table = rng.integers(0, 16, 64)
    table[rng.random(64) < 0.3] = 0
    for t in (None, table):
        np.testing.assert_array_equal(PM.distance_bit_cost(dists, t),
                                      JM.distance_bit_cost(dists, t))
    np.testing.assert_array_equal(PM._dist_codes(dists),
                                  JM._dist_codes(dists))
    x = rng.integers(0, 1 << 63, 3000, dtype=np.uint64)
    x[::3] &= np.uint64(0xFFFFFF0000000000)
    x[::7] = 0
    np.testing.assert_array_equal(PM._tz_bytes(x), JM._tz_bytes(x))


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("kw", [
    dict(num_candidates=2), dict(num_candidates=4, use_dict=True),
    dict(num_candidates=4, use_dict=True, base=123_457),
    dict(num_candidates=3, hash_bits=14, max_match=64)],
    ids=["ncand2", "dict", "dict-base", "hash14-max64"])
def test_find_matches_vectorized(name, kw):
    arr = _arr(name)
    _same(PM.find_matches_vectorized(arr, MAXD, **kw),
          JM.find_matches_vectorized(arr, MAXD, **kw))


@pytest.mark.parametrize("name", list(INPUTS))
def test_find_matches_costmodel(name):
    arr = _arr(name)
    got = PM.find_matches_costmodel(arr, MAXD, num_candidates=6,
                                    use_dict=True)
    _same(got, JM.find_matches_costmodel(arr, MAXD, num_candidates=6,
                                         use_dict=True))
    assert len(got[0]) > 0 or name == "random"


@pytest.mark.parametrize("name", list(INPUTS))
def test_find_matches_greedy(name):
    arr = _arr(name)
    _same(PM.find_matches_greedy(arr, MAXD),
          JM.find_matches_greedy(arr, MAXD))
    _same(PM.find_matches_greedy(arr[:500], 1 << 10, hash_bits=10),
          JM.find_matches_greedy(arr[:500], 1 << 10, hash_bits=10))


def _greedy_parse(arr):
    m, lens, dists = JM.find_matches_greedy(arr, MAXD)
    return m, lens, dists, np.zeros(len(m), np.int64)


@pytest.mark.parametrize("size", [1000, (1 << 14) - 1])
def test_dictionary_pass_below_16k(size):
    """Below 16 KiB both packages take the numpy pass."""
    arr = np.frombuffer(INPUTS["text"][:size], np.uint8)
    parse = _greedy_parse(arr)
    for kw in (dict(), dict(base=5000, active_from=100)):
        got = PM.add_dictionary_matches(arr, *parse, MAXD, **kw)
        _same(got, JM.add_dictionary_matches(arr, *parse, MAXD, **kw))
        assert (got[3] >= 2000).any()


def test_dictionary_pass_numpy_above_16k(monkeypatch):
    """native_pass=False is the JAX package's BROTLI_TPU_NO_NATIVE_DICT;
    with the native pass both packages give the same arrays too."""
    arr = _arr("text")
    parse = _greedy_parse(arr)
    native = PM.add_dictionary_matches(arr, *parse, MAXD)
    _same(native, JM.add_dictionary_matches(arr, *parse, MAXD))
    monkeypatch.setenv("BROTLI_TPU_NO_NATIVE_DICT", "1")
    got = PM.add_dictionary_matches(arr, *parse, MAXD, native_pass=False)
    _same(got, JM.add_dictionary_matches(arr, *parse, MAXD))
    assert len(got[0]) != len(native[0]) or not all(
        np.array_equal(a, b) for a, b in zip(got, native))


def test_dictionary_pass_where_the_native_pass_runs_out():
    """Five-letter dictionary words back to back under a 1 KiB window
    (so each whole word passes the distance gate) hold more references
    than the native pass's room (one per 8 bytes): both packages then
    take the numpy pass."""
    from brotli_tpu_torch.tools.corpus import _dictionary_words
    words = [w for w in _dictionary_words()
             if len(w) == 5 and w.isalpha() and w.islower()]
    rng = np.random.default_rng(0)
    arr = np.frombuffer(b"".join(words[i] for i in rng.integers(
        0, len(words), 8000))[:1 << 15], np.uint8)
    maxd = C.max_backward_distance(10)
    z = np.zeros(0, np.int64)
    with pytest.raises(ValueError):
        PN.dict_post(arr.tobytes(), z, z, maxd)
    got = PM.add_dictionary_matches(arr, z, z, z, z, maxd)
    _same(got, JM.add_dictionary_matches(arr, z, z, z, z, maxd))
    assert len(got[0]) > len(arr) // 8


# -- (b) enc/static_dict ---------------------------------------------------

@pytest.mark.parametrize("name", ["source", "text", "random"])
def test_static_dict_probe(name):
    arr = _arr(name)[:20_000]
    pos = np.arange(len(arr) - 4, dtype=np.int64)
    got = PSD.probe(arr, pos)
    want = JSD.probe(arr, pos)
    _same(got, want)
    dlen, dwlen, didx, dtr = got
    assert (dlen > 0).any() or name == "random"
    for base in (0, 1 << 20):
        np.testing.assert_array_equal(
            PSD.dict_distance(pos + base, dwlen, didx, MAXD, dtr),
            JSD.dict_distance(pos + base, dwlen, didx, MAXD, dtr))


# -- (c) enc/base64_mode ---------------------------------------------------

def _b64_cases():
    page = base64_page(CORPUS, 1 << 18, seed=3)
    return {
        "page": page,
        "none": CORPUS[:5000],
        "trigger at the end": CORPUS[:100] + b"data:x;base64,",
        "padding": b"a;base64,QUJD==xyz;base64,QQ=;base64,",
        "many regions": b"".join(b"t%d;base64,QUJDRA+/%d " % (i, i)
                                 for i in range(40)),
    }


@pytest.mark.parametrize("case", list(_b64_cases()))
def test_base64_regions(case):
    data = _b64_cases()[case]
    arr = np.frombuffer(data, np.uint8)
    for mr in (PB64.MAX_REGIONS, 3):
        starts, lengths = PB64.detect_regions(arr, mr)
        _same((starts, lengths), JB64.detect_regions(arr, mr))
    mask = PB64.region_mask(arr, starts, lengths)
    np.testing.assert_array_equal(mask,
                                  JB64.region_mask(arr, starts, lengths))
    parse = JM.find_matches_vectorized(arr, MAXD, use_dict=True) \
        if len(arr) >= 8 else (np.zeros(0, np.int64),) * 4
    _same(PB64.drop_matches_in_regions(parse, mask),
          JB64.drop_matches_in_regions(parse, mask))
    if case == "page":
        assert mask.sum() > 10_000
    np.testing.assert_array_equal(PB64.base64_code_lengths(),
                                  JB64.base64_code_lengths())


# -- (d) format/shared_dictionary ------------------------------------------

def _blobs(shd):
    """The serialized dictionaries of the JAX package's own tests
    (tests/test_dictionary.py), built with `shd`, and one with two
    word lists, a shift parameter and a context map."""
    raw = CORPUS[:4096]
    words8 = [b"brotlitp", b"tpuchips", b"sharding", b"wavefrnt"]
    dw = b"".join(words8)
    wl = shd.WordList([0] * 8 + [2] + [0] * 16,
                      [0] * 8 + [0] + [len(dw)] * 16, dw)
    tl = shd.TransformList(
        [b"pre-", b"!", b""],
        [(2, shd.T_IDENTITY, 2), (0, shd.T_UPPERCASE_ALL, 1),
         (2, shd.T_SHIFT_FIRST, 2), (2, 2, 2)], [0, 0, 1, 0])
    rng = np.random.default_rng(9)
    base_words = [bytes(rng.integers(33, 127, 8).astype(np.uint8))
                  for _ in range(256)]
    dw2 = b"".join(base_words)
    wl2 = shd.WordList([0] * 8 + [8] + [0] * 16,
                       [0] * 8 + [0] + [len(dw2)] * 16, dw2)
    tl2 = shd.TransformList([b"<", b">", b""],
                            [(2, shd.T_IDENTITY, 2),
                             (0, shd.T_IDENTITY, 1)], [0, 0])
    rng = np.random.default_rng(15)
    w64 = b"".join(bytes(rng.integers(33, 127, 8).astype(np.uint8))
                   for _ in range(64))
    wl3 = shd.WordList([0] * 8 + [6] + [0] * 16,
                       [0] * 8 + [0] + [len(w64)] * 16, w64)
    tl3 = shd.TransformList([b""], [(0, shd.T_IDENTITY, 0)], [0])
    tl4 = shd.TransformList([b"x", b""],
                            [(1, shd.T_SHIFT_ALL, 0),
                             (0, shd.T_SHIFT_FIRST, 1)], [3, 0x1FF])
    return {
        "prefix": shd.serialize(prefixes=[raw]),
        "words+transforms": shd.serialize(
            word_lists=[wl], transform_lists=[tl], dictionaries=[(0, 0)]),
        "custom words": shd.serialize(
            word_lists=[wl2], transform_lists=[tl2], dictionaries=[(0, 0)]),
        "context based": shd.serialize(
            word_lists=[wl3], transform_lists=[tl3], dictionaries=[(0, 0)],
            context_based=True, context_map=[0] * 64),
        "two lists": shd.serialize(
            prefixes=[raw[:100]], word_lists=[wl, wl3],
            transform_lists=[tl, tl4],
            dictionaries=[(0, 0), (1, 1), (2, 2)], context_based=True,
            context_map=[i % 3 for i in range(64)]),
    }


@pytest.mark.parametrize("case", list(_blobs(JSHD)))
def test_shared_dictionary_parse_and_serialize(case):
    blob = _blobs(PSHD)[case]
    assert blob == _blobs(JSHD)[case]
    got, want = PSHD.parse(blob), JSHD.parse(blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the round trip: what parse gives serializes back to the same blob
    wl_ids = {id(w): i for i, w in enumerate(got.word_lists)}
    tl_ids = {id(t): i for i, t in enumerate(got.transform_lists)}
    dicts = [(wl_ids.get(id(w), len(got.word_lists)),
              tl_ids.get(id(t), len(got.transform_lists)))
             for w, t in got.dictionaries] if (
                 got.word_lists or got.transform_lists) else []
    again = PSHD.serialize(got.prefixes, got.word_lists,
                           got.transform_lists, dicts, got.context_based,
                           got.context_map)
    assert again == blob
    # every reference of every length and address the lists may hold
    lut_p, lut_j = PCTX.context_lut(2), JCTX.context_lut(2)
    for copy_len in (4, 5, 8, 12, 25):
        for address in range(0, 64, 3):
            for p1, p2 in ((0, 0), (ord("a"), ord(" ")), (200, 65)):
                assert PSHD.decode_reference(
                    got, copy_len, address, p1, p2, lut_p) == \
                    JSHD.decode_reference(want, copy_len, address, p1, p2,
                                          lut_j)


def test_shared_dictionary_refuses_bad_blobs():
    for blob in (b"\x91", b"\x92\x00\x00\x00\x00", b"\x91\x00\x05ab",
                 b"\x91\x00\x00\x41\x00"):
        with pytest.raises(ValueError) as got:
            PSHD.parse(blob)
        with pytest.raises(ValueError) as want:
            JSHD.parse(blob)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(3))
def test_apply_transform(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        word = bytes(rng.integers(0, 256, int(rng.integers(1, 12)))
                     .astype(np.uint8))
        triple = (b"ab"[:int(rng.integers(0, 3))],
                  int(rng.integers(0, PSHD.NUM_TRANSFORM_TYPES)),
                  b"!?"[:int(rng.integers(0, 3))])
        param = int(rng.integers(0, 1 << 16))
        assert PSHD.apply_transform(word, triple, param) == \
            JSHD.apply_transform(word, triple, param)


# -- (e) enc/custom_dict ---------------------------------------------------

def _payload(seed, words, wrap):
    rng = np.random.default_rng(seed)
    pieces = []
    for i, w in enumerate(words):
        pieces.append(b"<" + w + b">" if wrap and i % 2 == 0 else w)
        pieces.append(bytes(rng.integers(65, 91, int(rng.integers(3, 10)))
                            .astype(np.uint8)))
    return b" ".join(pieces)


@pytest.mark.parametrize("case", ["custom words", "context based",
                                  "two lists", "prefix"])
def test_custom_dict_index_and_matches(case):
    blob = _blobs(JSHD)[case]
    sp, sj = PSHD.parse(blob), JSHD.parse(blob)
    ip, ij = PCD.build_index(sp), JCD.build_index(sj)
    if case == "prefix":
        assert ip is None and ij is None
        return
    assert ip.keys() == ij.keys()
    for a, b in zip(ip["dicts"], ij["dicts"]):
        assert a == b
    if "context_map" in ij:
        np.testing.assert_array_equal(ip["context_map"], ij["context_map"])
    words = [w.data[i:i + 8] for w in sj.word_lists
             for i in range(0, len(w.data), 8)]
    data = np.frombuffer(_payload(3, words, case == "custom words"),
                         np.uint8)
    parse = JM.find_matches_vectorized(data, MAXD, use_dict=True)
    keep = (parse[3] < 2) | ((parse[3] >= 1000) & (parse[3] < 2000))
    parse = tuple(a[keep] for a in parse)
    for csize in (0, 4096):
        got = PCD.add_custom_matches(data, parse, ip, MAXD, csize)
        _same(got, JCD.add_custom_matches(data, parse, ij, MAXD, csize))
        assert ((got[3] >= 1000) & (got[3] < 2000)).any()


# -- (f) the tools -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_optref(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 4 if seed else 2, 400).astype(np.uint8)
    np.testing.assert_array_equal(POR.suffix_array(data),
                                  JOR.suffix_array(data))
    sa = JOR.suffix_array(data)
    np.testing.assert_array_equal(POR.lcp_array(data, sa),
                                  JOR.lcp_array(data, sa))
    _same(POR.longest_previous_factor(data),
          JOR.longest_previous_factor(data))
    _same(POR.find_references(data, 3), JOR.find_references(data, 3))


def test_histogram_and_diff_tools(tmp_path):
    data = _arr("text")[:8000]
    pos, dist, ln = JOR.find_references(data, min_length=4)
    rec = tmp_path / "refs.txt"
    rec.write_text("".join(f"{p} {d} {l2}\n"
                           for p, d, l2 in zip(pos, dist, ln)))
    args = ["--width", "120", "--height", "80"]
    PDH.main([str(rec), str(tmp_path / "p.pgm")] + args)
    JDH.main([str(rec), str(tmp_path / "j.pgm")] + args)
    assert (tmp_path / "p.pgm").read_bytes() == \
        (tmp_path / "j.pgm").read_bytes()
    img = PDH.read_pgm(str(tmp_path / "p.pgm"))
    assert img.shape == (80, 120) and (img < 255).any()
    # a second image from other references, and the diff of the two
    pos2, dist2, ln2 = JOR.find_references(_arr("source")[:8000], 4)
    rec2 = tmp_path / "refs2.txt"
    rec2.write_text("".join(f"{p} {d} {l2}\n"
                            for p, d, l2 in zip(pos2, dist2, ln2)))
    PDH.main([str(rec2), str(tmp_path / "p2.pgm")] + args)
    a, b = str(tmp_path / "p.pgm"), str(tmp_path / "p2.pgm")
    PDD.main([a, b, str(tmp_path / "pd.pgm")])
    JDD.main([a, b, str(tmp_path / "jd.pgm")])
    assert (tmp_path / "pd.pgm").read_bytes() == \
        (tmp_path / "jd.pgm").read_bytes()


def test_dictgen(tmp_path):
    sample = CORPUS[30_000:30_000 + (48 << 10)]
    for size in (4096, 10_000):
        assert PDG.generate(sample, size) == JDG.generate(sample, size)
        assert PDG.generate_mined(sample, size) == \
            JDG.generate_mined(sample, size)
    samples = [CORPUS[i:i + 3000] for i in range(0, 30_000, 3000)]
    assert PDG.distill(samples) == JDG.distill(samples)
    assert PDG.purify(samples) == JDG.purify(samples)
    files = []
    for i, s in enumerate(samples[:4]):
        f = tmp_path / f"s{i}.txt"
        f.write_bytes(s * 3)
        files.append(str(f))
    for engine in ("cover", "mined"):
        args = files + ["--size", "2048", "--engine", engine]
        assert PDG.main(args + ["-o", str(tmp_path / "p.bin")]) == 0
        assert JDG.main(args + ["-o", str(tmp_path / "j.bin")]) == 0
        assert (tmp_path / "p.bin").read_bytes() == \
            (tmp_path / "j.bin").read_bytes()
    assert PDG.main(files + ["-o", str(tmp_path / "c"), "--distill"]) == 0
    assert (tmp_path / "c.s0.txt").read_bytes() == \
        JDG.distill([(tmp_path / "s0.txt").read_bytes()] + [
            (tmp_path / f"s{i}.txt").read_bytes() for i in (1, 2, 3)])[0]


def test_native_dict_post_is_the_jax_packages():
    """The native pass itself (the port's copy of btpu_dict_post) on a
    parse with gaps, against the JAX package's library."""
    arr = _arr("text")
    m, lens, dists, flags = _greedy_parse(arr)
    _same(PN.dict_post(arr.tobytes(), m, lens, MAXD, 77, 10),
          JN.dict_post(arr.tobytes(), m, lens, MAXD, 77, 10))
