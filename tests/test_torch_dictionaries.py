"""Dictionaries and base64 mode through the port's public API, against
the JAX package on the CPU, byte for byte:

  (a) raw dictionaries with modes 1 and 2, beyond lgwin 24 and empty
      (`dictionary=b""`), through the Python pipeline;
  (b) serialized shared dictionaries: a prefix only (the native routes),
      custom word lists (the Python pipeline's custom-word pass, the
      Python decoder), context-based lists; `compress`, `decompress`
      and `Decompressor`;
  (c) `decompress(decoder="device", dictionary=...)`, which takes the
      Python decoder as in the JAX package;
  (d) base64 mode at q1, q5 and q9.

The port runs the card's routes with device="cpu" (the plain versions
of the kernels) against the JAX package's device branch on the CPU
(`backend_or_cpu` patched to report a GPU, the Pallas chain walk its
XLA twin, the matcher's buckets and the DP's segments shrunk in both
packages, as tests/test_torch_serializer.py does), and its host routes
with backend="numpy" against BROTLI_TPU_BACKEND=numpy. Every stream
also decodes through the JAX package's native decoder (where a
dictionary's words allow) and through the port's decoders. Inputs are
in-repo only.
"""

import os

import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import custom_dict as JCD
from brotli_tpu.enc import encoder as JE
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.dec.decoder import Decoder, FormatError
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.format import shared_dictionary as shd
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import (base64_page, build_corpus,
                                           custom_dictionary)

CORPUS = build_corpus(1 << 20)
SEG = 1 << 16
RAW = CORPUS[20_000:40_000]                 # C source
DATA = CORPUS[560_000:660_000]              # dictionary-word text
BLOB = custom_dictionary(CORPUS[400_000:400_000 + (64 << 10)])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and their OpenMP threads spinning on the same cores made
    these tests twenty times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def device_branch():
    """Both packages on their device branches on the CPU, with shrunk
    buckets and segments; no BROTLI_TPU_* variable but BROTLI_TPU_DP."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        mp.setenv("BROTLI_TPU_DP", "v3")
        mp.setattr(jaxcfg, "backend_or_cpu", lambda: "gpu")
        mp.setattr(CP, "chain_select", CP.chain_select_xla)
        for mod in (MJ, PM):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 17])
            mp.setattr(mod, "SEG_BYTES", 1 << 17)
        mp.setattr(OJ, "SEG_V3", SEG)
        mp.setattr(OJ, "_BUCKETS_V3", [SEG])
        mp.setattr(O, "SEG_V3", SEG)
        mp.setattr(O, "BUCKETS_V3", [SEG])
        yield mp


def _jax(monkeypatch, fn, **env):
    """fn() in the JAX package under the variables `env`."""
    with monkeypatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        return fn()


def _decodes(out, data, dictionary=None, large_window=False,
             native=True):
    """`out` decodes to `data` through the port's native, Python and
    streaming decoders (each with `dictionary`), and through the JAX
    package's native decoder where `native` (a raw dictionary or a
    serialized one's prefix)."""
    kw = dict(dictionary=dictionary, large_window=large_window)
    assert bt.decompress(out, **kw) == data
    assert bt.decompress(out, decoder="python", **kw) == data
    if not large_window:
        for decoder in ("native", "python"):
            d = bt.Decompressor(dictionary, decoder=decoder)
            assert d.process(out) == data and d.is_finished()
    if native:
        compound = dictionary or b""
        if dictionary and dictionary[:2] == b"\x91\x00":
            compound = b"".join(shd.parse(dictionary).prefixes)
        assert JN.decode(out, compound=compound,
                         large_window=large_window) == data


# -- (a) raw dictionaries ----------------------------------------------------

_RAW = {
    # mode, quality, what runs the match finding; input size
    "mode 1 q5 device matcher": (dict(mode=1, quality=5), {}, len(DATA)),
    "mode 2 q1 greedy": (dict(mode=2, quality=1), {}, 30_000),
    "mode 2 q9 vectorized": (dict(mode=2, quality=9, backend="numpy"),
                             {"BROTLI_TPU_BACKEND": "numpy"}, len(DATA)),
    "lgwin 25": (dict(quality=5, lgwin=25, large_window=True), {},
                 len(DATA)),
    "lgwin 25 mode 1 q9": (dict(quality=9, lgwin=25, large_window=True,
                                mode=1), {}, 60_000),
}


@pytest.mark.parametrize("case", list(_RAW))
def test_raw_dictionary(case, monkeypatch):
    kw, env, size = _RAW[case]
    data = DATA[:size]
    out = bt.compress(data, dictionary=RAW, device="cpu", **kw)
    kw.pop("backend", None)
    want = _jax(monkeypatch, lambda: brotli_tpu.compress(
        data, dictionary=RAW, **kw), **env)
    assert out == want
    _decodes(out, data, RAW, kw.get("large_window", False))


@pytest.mark.parametrize("quality", [1, 5])
def test_empty_dictionary(quality):
    """dictionary=b"": the Python pipeline with no compound data, as in
    the JAX package (neither native route takes it)."""
    out = bt.compress(DATA, quality=quality, dictionary=b"", device="cpu")
    assert out == brotli_tpu.compress(DATA, quality=quality, dictionary=b"")
    _decodes(out, DATA)


def test_empty_dictionary_q11_takes_the_cards_route(monkeypatch):
    """dictionary=b"" at q11 on 256 KiB: the device encode (the JAX
    package's _encode_q11_streamed), in the port too, by spies that
    stand in for it."""
    data = CORPUS[:1 << 18]
    called = []
    monkeypatch.setattr(PE, "_encode_on_card",
                        lambda raw, *a: called.append(("port", len(raw)))
                        or b"port")
    monkeypatch.setattr(JE, "_encode_q11_streamed",
                        lambda arr, n, *a: called.append(("jax", n))
                        or b"jax")
    assert bt.compress(data, dictionary=b"", device="cpu") == b"port"
    assert JE.encode(data, dictionary=b"") == b"jax"
    # encoder="python" never takes it
    monkeypatch.setattr(PE, "find_matches",
                        lambda arr, *a, **k: called.append(("finder",
                                                            len(arr)))
                        or (np.zeros(0, np.int64),) * 4)
    bt.compress(data, dictionary=b"", encoder="python", device="cpu")
    assert called == [("port", 1 << 18), ("jax", 1 << 18),
                      ("finder", 1 << 18)]


# -- (b) serialized shared dictionaries ----------------------------------

def _blob_words():
    """The JAX package's context-based test dictionary and payload
    (tests/test_dictionary.py)."""
    rng = np.random.default_rng(15)
    words = [bytes(rng.integers(33, 127, 8).astype(np.uint8))
             for _ in range(64)]
    dw = b"".join(words)
    wl = shd.WordList([0] * 8 + [6] + [0] * 16,
                      [0] * 8 + [0] + [len(dw)] * 16, dw)
    tl = shd.TransformList([b""], [(0, shd.T_IDENTITY, 0)], [0])
    blob = shd.serialize(word_lists=[wl], transform_lists=[tl],
                         dictionaries=[(0, 0)], context_based=True,
                         context_map=[0] * 64)
    pieces = []
    for w in words:
        pieces.append(w)
        pieces.append(bytes(rng.integers(65, 91, rng.integers(3, 9))
                            .astype(np.uint8)))
    return blob, b" ".join(pieces)


_SERIALIZED = {
    "prefix q5": (shd.serialize(prefixes=[RAW]), DATA, 5, True),
    "prefix q11": (shd.serialize(prefixes=[RAW]), DATA[:60_000], 11,
                   True),
    "prefix and words q5": (BLOB, DATA, 5, False),
    "context-based words q1": _blob_words() + (1, False),
    "context-based words q9": _blob_words() + (9, False),
    "context-based words q11": _blob_words() + (11, False),
}


def _stream_matches_only(monkeypatch):
    """The JAX package's custom-word pass given only the matches that
    start in the input, as the port's repair does
    (enc/encoder._custom_word_matches)."""
    real = JCD.add_custom_matches

    def stream_only(data, matches, *a):
        m, lens, dists, flags = matches
        k = m >= 0
        return real(data, (m[k], lens[k], dists[k], flags[k]), *a)
    monkeypatch.setattr(JCD, "add_custom_matches", stream_only)


@pytest.mark.parametrize("case", list(_SERIALIZED))
def test_serialized_dictionary(case, monkeypatch):
    """The JAX package's bytes; with a prefix and custom words, those of
    its encoder with the port's repair (see
    test_serialized_prefix_and_words_jax_fault)."""
    blob, data, quality, native = _SERIALIZED[case]
    out = bt.compress(data, quality=quality, dictionary=blob, device="cpu")
    parsed = shd.parse(blob)
    if parsed.prefixes and parsed.word_lists:
        _stream_matches_only(monkeypatch)
    assert out == brotli_tpu.compress(data, quality=quality,
                                      dictionary=blob)
    _decodes(out, data, blob, native=native)
    assert brotli_tpu.decompress(out, dictionary=blob) == data
    if not native:
        # the custom words were used, and only the Python decoders take
        # them (their references address the custom list)
        f = Decoder(shared=parsed)
        assert f.decompress(out) == data
        prefix = b"".join(parsed.prefixes) or None
        try:
            other = bt.decompress(out, dictionary=prefix)
        except bt.error:
            other = None
        assert other != data


def test_serialized_prefix_and_words_jax_fault():
    """A serialized dictionary with a prefix and custom words: the JAX
    package's encoder passes the matches found inside the prefix to its
    custom-word pass at negative positions, which wrap around in the
    pass's gap map, so it places words over other matches and raises
    OverflowError or writes a stream that decodes to other bytes on
    many inputs. The port leaves those matches out (they are never
    serialized) and decodes on every one of four seeded inputs; the
    JAX package fails on some of them."""
    jax_bad = 0
    for seed in range(2):
        rng = np.random.default_rng(seed)
        lo, dlo = (int(x) for x in rng.integers(300_000, 900_000, 2))
        blob = custom_dictionary(CORPUS[dlo:dlo + (64 << 10)])
        for size in (60_000, 100_000):
            data = CORPUS[lo:lo + size]
            out = bt.compress(data, quality=5, dictionary=blob,
                              backend="numpy")
            assert bt.decompress(out, dictionary=blob) == data
            try:
                want = brotli_tpu.compress(data, quality=5, dictionary=blob)
                jax_bad += Decoder(shared=shd.parse(blob)).decompress(
                    want) != data
            except (OverflowError, FormatError, ValueError):
                jax_bad += 1
    assert jax_bad > 0


def test_serialized_dictionary_decompressor_back_pressure():
    """Decompressor with a word-list dictionary: the Python core, fed in
    pieces under an output limit, as the JAX package's."""
    out = bt.compress(DATA, quality=5, dictionary=BLOB, device="cpu")
    got = []
    d = bt.Decompressor(BLOB)
    want = brotli_tpu.Decompressor(BLOB)
    pos, jgot = 0, []
    for piece in (out[i:i + 7000] for i in range(0, len(out), 7000)):
        got.append(d.process(piece, output_buffer_limit=16 << 10))
        jgot.append(want.process(piece, output_buffer_limit=16 << 10))
        while not d.can_accept_more_data() and not d.is_finished():
            got.append(d.process(b"", output_buffer_limit=16 << 10))
        while not want.can_accept_more_data() and not want.is_finished():
            jgot.append(want.process(b"", output_buffer_limit=16 << 10))
        pos += len(piece)
    assert b"".join(got) == b"".join(jgot) == DATA
    assert max(map(len, got)) <= 16 << 10
    assert d.is_finished()


# -- (c) the device decoder with a dictionary -------------------------------

@pytest.mark.parametrize("dictionary", [RAW, BLOB],
                         ids=["raw", "serialized"])
def test_device_decoder_with_a_dictionary(dictionary, monkeypatch):
    out = brotli_tpu.compress(DATA, quality=5, dictionary=dictionary)
    got = bt.decompress(out, dictionary=dictionary, decoder="device",
                        device="cpu")
    want = _jax(monkeypatch, lambda: brotli_tpu.decompress(
        out, dictionary=dictionary), BROTLI_TPU_DECODER="device")
    assert got == want == DATA


# -- (d) base64 mode -------------------------------------------------------

@pytest.mark.parametrize("quality,size,backend", [
    (1, 60_000, "auto"), (5, 200_000, "auto"), (9, 120_000, "numpy")])
def test_base64_mode(quality, size, backend, monkeypatch):
    page = base64_page(CORPUS, size, seed=quality)
    out = bt.compress(page, quality=quality, base64_mode=True,
                      backend=backend, device="cpu")
    env = {"BROTLI_TPU_BACKEND": backend} if backend == "numpy" else {}
    want = _jax(monkeypatch, lambda: brotli_tpu.compress(
        page, quality=quality, base64_mode=True), **env)
    assert out == want
    _decodes(out, page)
    # the flat code took the payload: smaller than its base64 at 8 bits
    assert out != bt.compress(page, quality=quality, encoder="python",
                              backend=backend, device="cpu")
