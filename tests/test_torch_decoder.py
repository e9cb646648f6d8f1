"""The port's Python decoder (dec/decoder.py, dec/stream.py) against the
JAX package's, on the CPU.

  (a) `Decoder` on native streams at q0-q11 in modes 0-2, at lgwin 10-24
      and with a large window (26): the same bytes as the JAX decoder
      and the input back;
  (b) every file of tests/fuzz_corpus/ through `Decoder`,
      `IncrementalDecoder` and `StreamDecoder` of both packages: the
      same bytes, or the same error class and code;
  (c) metadata callbacks, `decompress_prefix` with trailing bytes;
  (d) `IncrementalDecoder` fed in seeded random pieces, `StreamDecoder`
      and `Decompressor(decoder="python")` under output limits;
  (e) the deferred parse (`defer_lz`): the JAX deferred parse's graph,
      the native parse's copy list (ops/lz_resolve.copy_list), and
      `lz_resolve.resolve(..., device="cpu")` of it gives the bytes.

Every stream decoder runs its worker thread inside a thread of the test
that is joined with a timeout, and each test asserts that both threads
ended: a hang fails the test instead of the suite. Inputs are in-repo
only: the port's corpus generator, the fuzz corpus and numpy seeds.
"""

import pathlib
import threading

import numpy as np
import pytest

import brotli_tpu_torch as bt
from brotli_tpu.dec import decoder as JD
from brotli_tpu.dec import stream as JS
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.dec import decoder as PD
from brotli_tpu_torch.dec import stream as PS
from brotli_tpu_torch.ops import lz_resolve as LZ
from brotli_tpu_torch.tools.corpus import build_corpus

REPO = pathlib.Path(__file__).resolve().parent.parent
FUZZ = sorted((REPO / "tests" / "fuzz_corpus").glob("*.bin"))
TEXT = build_corpus(1 << 20)[200_000:248_000]
JOIN_S = 60


def _native_stream(q, mode=0, lgwin=22, large=False):
    return bt.compress(TEXT, mode=mode, quality=q, lgwin=lgwin,
                       large_window=large, encoder="native")


STREAMS = {f"q{q} mode{m}": (q, m, 22, False)
           for q in range(12) for m in range(3)}
STREAMS.update({f"q5 lgwin{w}": (5, 0, w, False) for w in (10, 16, 20, 24)})
STREAMS["q5 large window 26"] = (5, 0, 26, True)


def _outcome(fn):
    """("ok", bytes) or (error class name, error code or None)."""
    try:
        return "ok", fn()
    except Exception as e:
        code = getattr(e, "code", None)
        return type(e).__name__, None if code is None else int(code)


def _incremental(mod, data, pieces, large=False):
    dec = mod.IncrementalDecoder(large_window=large)
    out = bytearray()
    for p in pieces:
        out += dec.feed(p)
    return dec.finished, bytes(out)


def _stream(mod, data, pieces, limit=None, large=False, callback=None):
    """StreamDecoder of `mod` fed `pieces` under an output limit,
    draining while output is pending; run on a thread joined with a
    timeout. Returns (outcome, largest chunk returned)."""
    sd = mod.StreamDecoder(large_window=large)
    if callback is not None:
        sd.metadata_callback = callback
    res = {}

    def body():
        def run():
            out, most = [], 0
            sd.set_output_limit(limit)
            for p in pieces:
                out.append(sd.feed(p))
                most = max(most, len(out[-1]))
                while sd.pending_output:
                    out.append(sd.feed(b""))
                    most = max(most, len(out[-1]))
            out.append(sd.finish())
            return b"".join(out), most
        try:
            res["out"] = _outcome(run)
        finally:
            sd.close()

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "stream decoder hung"
    assert not sd._thread.is_alive()
    kind, val = res["out"]
    if kind == "ok":
        return ("ok", val[0]), val[1]
    return (kind, val), 0


def _doubling(data):
    """Pieces of 1, 2, 4, ... bytes plus the reference decode fuzzer's
    data-derived addend (its last byte & 7). IncrementalDecoder parses
    a metablock again from its start at every feed, so pieces that
    double keep its work within a few whole parses."""
    addend = (data[-1] & 7) if data else 0
    out, pos, step = [], 0, 1
    while pos < len(data):
        out.append(data[pos:pos + step + addend])
        pos += step + addend
        step *= 2
    return out


def _pieces(data, seed, most=16384):
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < len(data):
        k = int(rng.integers(1, most + 1))
        out.append(data[pos:pos + k])
        pos += k
    return out


@pytest.fixture(scope="module")
def streams():
    return {k: _native_stream(*v) for k, v in STREAMS.items()}


@pytest.mark.parametrize("case", list(STREAMS))
def test_decoder_on_native_streams(streams, case):
    large = STREAMS[case][3]
    s = streams[case]
    got = PD.Decoder(large_window=large).decompress(s)
    assert got == JD.Decoder(large_window=large).decompress(s) == TEXT
    assert bt.decompress(s, large_window=large, decoder="python") == TEXT
    assert PD.decompress(s, large_window=large) == TEXT


@pytest.mark.parametrize("path", FUZZ, ids=[p.name for p in FUZZ])
def test_fuzz_corpus_three_decoders(path):
    """Bytes, or error class and code, equal to the JAX package's for
    the one-shot, the incremental and the streaming decoder."""
    data = path.read_bytes()
    one = _outcome(lambda: PD.Decoder().decompress(data))
    assert one == _outcome(lambda: JD.Decoder().decompress(data))
    pieces = _doubling(data)
    assert _outcome(lambda: _incremental(PD, data, pieces)) == \
        _outcome(lambda: _incremental(JD, data, pieces))
    got, _ = _stream(PS, data, [data])
    want, _ = _stream(JS, data, [data])
    assert got == want
    if one[0] == "ok":
        assert got == one
        assert bt.decompress(data, decoder="python") == one[1]
    else:
        with pytest.raises(bt.error):
            bt.decompress(data, decoder="python")


def test_fuzz_corpus_has_both_outcomes():
    """The corpus holds streams both decoders take and streams they
    refuse, so the test above compares both kinds of result."""
    kinds = {_outcome(lambda: PD.Decoder().decompress(p.read_bytes()))[0]
             for p in FUZZ}
    assert len(FUZZ) == 102
    assert "ok" in kinds and "FormatError" in kinds


def test_metadata_callbacks():
    c = bt.Compressor(quality=5)
    s = (c.emit_metadata(b"first comment") + c.process(TEXT[:20_000])
         + c.emit_metadata(b"") + c.emit_metadata(bytes(range(256)) * 3)
         + c.process(TEXT[20_000:]) + c.finish())
    seen = {}
    for label, mod in (("torch", PD), ("jax", JD)):
        got = []
        d = mod.Decoder()
        d.metadata_callback = got.append
        assert d.decompress(s) == TEXT
        seen[label] = [bytes(g) for g in got]
    assert seen["torch"] == seen["jax"]
    assert b"first comment" in seen["torch"]
    got = []
    out, _ = _stream(PS, s, _pieces(s, 3), callback=got.append)
    assert out == ("ok", TEXT)
    assert [bytes(g) for g in got] == seen["jax"]


@pytest.mark.parametrize("trailing", [b"", b"\x00", b"trailing bytes",
                                      bytes(1000)])
def test_decompress_prefix_with_trailing_bytes(streams, trailing):
    s = streams["q5 mode0"]
    got = PD.Decoder().decompress_prefix(s + trailing)
    assert got == JD.Decoder().decompress_prefix(s + trailing)
    assert got == (TEXT, len(s))
    if trailing:
        with pytest.raises(PD.FormatError) as e:
            PD.Decoder().decompress(s + bytes(8) + trailing)
        assert int(e.value.code) == int(JD.E.PADDING_2)


@pytest.mark.parametrize("case", ["q1 mode0", "q5 mode1", "q9 mode2",
                                  "q11 mode0", "q5 lgwin10",
                                  "q5 large window 26"])
@pytest.mark.parametrize("seed", [0, 1])
def test_incremental_in_seeded_pieces(streams, case, seed):
    large = STREAMS[case][3]
    s = streams[case]
    pieces = _pieces(s, seed)
    got = _incremental(PD, s, pieces, large)
    assert got == _incremental(JD, s, pieces, large) == (True, TEXT)
    truncated = _pieces(s[:len(s) // 2], seed)
    assert _outcome(lambda: _incremental(PD, s, truncated, large)) == \
        _outcome(lambda: _incremental(JD, s, truncated, large))


@pytest.mark.parametrize("limit", [None, 1000, 4096, 1 << 16])
@pytest.mark.parametrize("case", ["q5 mode0", "q11 mode1", "bomb"])
def test_stream_decoder_under_output_limits(streams, case, limit):
    """The bytes of the JAX StreamDecoder under the same limit; no chunk
    above the limit or one 64 KiB piece of a copy (the gate's overshoot
    of dec/stream.py)."""
    if case == "bomb":
        want = bytes(3 << 20)
        s = bt.compress(want, quality=5)
    else:
        want, s = TEXT, streams[case]
    pieces = _pieces(s, 7, most=2048)
    got, most = _stream(PS, s, pieces, limit)
    ref, _ = _stream(JS, s, pieces, limit)
    assert got == ref == ("ok", want)
    if limit:
        assert most <= max(limit, 1 << 16)


def test_stream_ends_without_closing_the_feed():
    """The port's repair of the streaming reader: with a stream's every
    byte fed, its decoder finishes before finish() closes the feed,
    also where the last symbol's code is shorter than its table's
    longest, which the JAX package's copy waits for."""
    corpus = build_corpus(1 << 20)
    unfinished = 0
    for i in range(24):
        data = corpus[i * 1000:i * 1000 + 3000 + i * 37]
        s = bt.compress(data, quality=1 + i % 9)
        out = {}
        for mod in (PS, JS):
            sd = mod.StreamDecoder()
            try:
                out[mod] = (sd.feed(s), sd.finished)
            finally:
                sd.close()
            assert not sd._thread.is_alive()
        assert out[PS] == (data, True)
        unfinished += not out[JS][1]
    assert unfinished > 0


def test_decompressor_python_pieces_and_limit():
    want = bytes(2 << 20) + TEXT
    s = bt.compress(want, quality=5)
    res = {}

    def body():
        # the core decodes on a worker thread: with all input fed,
        # process(b"") waits for it, and returns nothing only when the
        # stream ends short
        d = bt.Decompressor(decoder="python")
        back, pos = [], 0
        while not d.is_finished():
            piece = b""
            if d.can_accept_more_data() and pos < len(s):
                piece = s[pos:pos + 1000]
                pos += len(piece)
            back.append(d.process(piece, output_buffer_limit=100_000))
            assert len(back[-1]) <= 100_000
            assert pos < len(s) or piece or back[-1] or d.is_finished(), \
                "Decompressor did not finish"
        res["out"] = b"".join(back)
        res["thread"] = d._inc._thread

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "Decompressor hung"
    res["thread"].join(JOIN_S)
    assert not res["thread"].is_alive()
    assert res["out"] == want
    with pytest.raises(ValueError, match="decoder"):
        bt.Decompressor(decoder="device")


def _deferred(mod, s):
    d = mod.Decoder()
    d.defer_lz = {"lits": bytearray(), "nlit": [], "ncopy": [], "dist": []}
    assert d.decompress(s) == b""  # the output stays deferred
    g = d.defer_lz
    return bytes(g["lits"]), g["nlit"], g["ncopy"], g["dist"]


@pytest.mark.parametrize("case", [f"q{q} mode{m}" for q in (1, 5, 9, 11)
                                  for m in range(3)])
def test_deferred_parse(streams, case):
    s = streams[case]
    got = _deferred(PD, s)
    assert got == _deferred(JD, s)
    lits, cn, cc, cd, _ = PN.parse_stream(s)
    assert got[0] == lits
    np.testing.assert_array_equal(LZ.copy_list(*got[1:]),
                                  LZ.copy_list(cn, cc, cd))
    assert LZ.resolve(*got, device="cpu") == TEXT


def test_deferred_parse_refuses_a_dictionary():
    dic = TEXT[:10_000]
    s = bt.compress(TEXT[10_000:], quality=5, dictionary=dic)
    d = PD.Decoder(dictionary=dic)
    assert d.decompress(s) == TEXT[10_000:]
    d = PD.Decoder(dictionary=dic)
    d.defer_lz = {"lits": bytearray(), "nlit": [], "ncopy": [], "dist": []}
    with pytest.raises(PD.UnsupportedForDevice):
        d.decompress(s)
    assert bt.decompress(s, dictionary=dic, decoder="python") == \
        TEXT[10_000:]
