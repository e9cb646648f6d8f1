"""The port's public surface against brotli_tpu's, byte for byte, on the
CPU: `compress` on every route the native runtime serves (every
quality, window, mode, raw dictionaries, large windows), `decompress`
with dictionaries and large windows, `decompress_concatenated`, the
streaming `Compressor`/`Decompressor`, `estimate_peak_memory`, the
reporting hooks, `compress_sharded` below its shard threshold, and the
error messages of every failing decode. The card's route of `compress`
(q10/q11 on 256 KiB or more) is held to the JAX package in
tests/test_torch_encode.py; here it must raise without a card and never
give way to the native encoder.

Both packages run at their defaults: no BROTLI_TPU_* variable is set.
Inputs are in-repo only: the port's corpus generator and
tests/fuzz_corpus/.
"""

import os
import pathlib

import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as bt
from brotli_tpu.parallel import shard as JS
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import build_corpus

FUZZ = sorted((pathlib.Path(__file__).parent / "fuzz_corpus").iterdir())
CORPUS = build_corpus(1 << 20)
SLICE_64K = CORPUS[120_000:120_000 + (1 << 16)]
SLICE_200K = CORPUS[300_000:300_000 + 200 * 1024]
DICT = CORPUS[80_000:120_000]  # the 40 KB before SLICE_64K
INPUTS = {"empty": b"", "a": b"a",
          **{f"fuzz {p.name}": p.read_bytes()
             for p in (FUZZ[0], FUZZ[len(FUZZ) // 2], FUZZ[-1])},
          "64K": SLICE_64K, "200K": SLICE_200K}


@pytest.fixture(scope="module", autouse=True)
def jax_defaults():
    """The JAX package at its defaults (native encoder and decoder)."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        yield


def _outcome(fn):
    """("ok", result) or (exception type name, message)."""
    try:
        return "ok", fn()
    except Exception as e:  # compared across the packages
        return type(e).__name__, str(e)


def test_exports_match_jax():
    names = ("set_reporting_callbacks", "MODE_GENERIC", "MODE_TEXT",
             "MODE_FONT", "Compressor", "Decompressor", "compress",
             "decompress", "decompress_concatenated", "error",
             "estimate_peak_memory", "version", "__version__")
    for name in names:
        assert hasattr(bt, name), name
    for name in ("MODE_GENERIC", "MODE_TEXT", "MODE_FONT"):
        assert getattr(bt, name) == getattr(brotli_tpu, name)
    assert bt.version == bt.__version__


# ---------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("quality", range(12))
def test_compress_matches_jax(quality, name):
    data = INPUTS[name]
    out = bt.compress(data, quality=quality)
    assert out == brotli_tpu.compress(data, quality=quality)
    assert bt.decompress(out) == data


@pytest.mark.parametrize("lgwin", [10, 16, 22, 24])
@pytest.mark.parametrize("quality", [1, 5, 9, 11])
def test_compress_lgwin_matches_jax(quality, lgwin):
    out = bt.compress(SLICE_64K, quality=quality, lgwin=lgwin)
    assert out == brotli_tpu.compress(SLICE_64K, quality=quality,
                                      lgwin=lgwin)
    assert bt.decompress(out) == SLICE_64K


@pytest.mark.parametrize("mode", [bt.MODE_TEXT, bt.MODE_FONT])
@pytest.mark.parametrize("quality", [1, 5, 11])
def test_compress_modes_match_jax(quality, mode):
    out = bt.compress(SLICE_64K, mode=mode, quality=quality)
    assert out == brotli_tpu.compress(SLICE_64K, mode=mode,
                                      quality=quality)
    assert bt.decompress(out) == SLICE_64K


@pytest.mark.parametrize("lgwin", [25, 30])
@pytest.mark.parametrize("quality", [5, 11])
def test_large_window_matches_jax(quality, lgwin):
    out = bt.compress(SLICE_64K, quality=quality, lgwin=lgwin,
                      large_window=True)
    assert out == brotli_tpu.compress(SLICE_64K, quality=quality,
                                      lgwin=lgwin, large_window=True)
    assert bt.decompress(out, large_window=True) == SLICE_64K == \
        brotli_tpu.decompress(out, large_window=True)
    # without the opt-in both decoders refuse the header alike
    want = _outcome(lambda: brotli_tpu.decompress(out))
    assert want[0] == "error"
    assert _outcome(lambda: bt.decompress(out)) == want


@pytest.mark.parametrize("quality", [1, 5, 11])
def test_raw_dictionary_matches_jax(quality):
    """A dictionary 60 KB before the input: no copy runs past the
    dictionary's end, and both packages give the same bytes."""
    dic = CORPUS[20_000:60_000]
    out = bt.compress(SLICE_64K, quality=quality, dictionary=dic)
    assert out == brotli_tpu.compress(SLICE_64K, quality=quality,
                                      dictionary=dic)
    assert len(out) < len(bt.compress(SLICE_64K, quality=quality))
    assert bt.decompress(out, dictionary=dic) == SLICE_64K == \
        brotli_tpu.decompress(out, dictionary=dic)
    # a dictionary-encoded stream without its dictionary
    assert _outcome(lambda: bt.decompress(out)) == \
        _outcome(lambda: brotli_tpu.decompress(out))


@pytest.mark.parametrize("quality", range(12))
def test_raw_dictionary_split_at_its_end(quality):
    """The dictionary right before the input: copies that start in the
    dictionary run on into the input. The decoders (both packages', and
    the reference's) refuse a compound reference past the dictionary's
    end, so the port's native encoder splits such a copy there; the JAX
    package's does not, and its stream fails to decode. Both packages
    decode the port's stream."""
    out = bt.compress(SLICE_64K, quality=quality, dictionary=DICT)
    assert bt.decompress(out, dictionary=DICT) == SLICE_64K == \
        brotli_tpu.decompress(out, dictionary=DICT)
    ref = brotli_tpu.compress(SLICE_64K, quality=quality, dictionary=DICT)
    assert _outcome(lambda: brotli_tpu.decompress(ref, dictionary=DICT)) \
        == ("error", "decode error COMPOUND_DICTIONARY (-18)")


def test_native_encoder_on_the_cards_inputs():
    """encoder="native" at q11 on 320 KiB: the native q11 tier, the JAX
    package's default bytes; no card needed."""
    data = CORPUS[500_000:500_000 + 320 * 1024]
    out = bt.compress(data, quality=11, encoder="native")
    assert out == brotli_tpu.compress(data, quality=11)
    assert bt.decompress(out) == data


def test_cards_route_never_gives_way(monkeypatch):
    """q10/q11 on 256 KiB or more: without CUDA, device=None raises and
    the native encoder is never called; a failure on the card's route
    surfaces as `error`, not as the native bytes. Every other route
    needs no card."""
    big = CORPUS[:1 << 18]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    native_encode = PN.encode

    def no_native(*args, **kwargs):
        raise AssertionError("the native encoder was called")

    monkeypatch.setattr(PN, "encode", no_native)
    for encoder in ("auto", "device"):
        for quality in (10, 11):
            with pytest.raises(RuntimeError, match="CUDA"):
                bt.compress(big, quality=quality, encoder=encoder)

    def failing_dp(*args, **kwargs):
        raise ValueError("the device route failed")

    monkeypatch.setattr(PE, "_encode_q11_streamed", failing_dp)
    with pytest.raises(bt.error, match="device route failed"):
        bt.compress(big, quality=11, device="cpu")
    monkeypatch.setattr(PN, "encode", native_encode)
    assert bt.compress(b"hello") == brotli_tpu.compress(b"hello")
    assert bt.compress(big, quality=9) == brotli_tpu.compress(big,
                                                              quality=9)


def test_unknown_encoder_raises():
    with pytest.raises(bt.error, match="encoder"):
        bt.compress(b"hello", encoder="gpu")


# ---------------------------------------------------------------------
# decompress, decompress_concatenated, error messages
# ---------------------------------------------------------------------

@pytest.mark.parametrize("path", FUZZ, ids=[p.name for p in FUZZ])
def test_fuzz_corpus_outcomes_match_jax(path):
    """Every fuzz-corpus stream decodes to the same bytes or fails with
    the JAX package's exact message (the error's name and code)."""
    data = path.read_bytes()
    assert _outcome(lambda: bt.decompress(data)) == \
        _outcome(lambda: brotli_tpu.decompress(data))


def test_error_names_match_jax():
    for stream, name in ((b"\x1b\x03\x00\x00garbage", "TRUNCATED (-102)"),
                         (b"\xff\xff\xff\xff not brotli", None)):
        got = _outcome(lambda: bt.decompress(stream))
        assert got == _outcome(lambda: brotli_tpu.decompress(stream))
        assert got[0] == "error"
        if name:
            assert got[1] == f"decode error {name}"
    try:
        PN.decode(b"\x1b\x03\x00\x00garbage")
    except PN.DecodeError as e:
        assert e.code == -102
    else:
        raise AssertionError("no DecodeError")


@pytest.mark.parametrize("cut", [1, 2, 10, 1000, "half", "last"])
def test_truncation_messages_match_jax(cut):
    stream = bt.compress(SLICE_64K, quality=5)
    n = {"half": len(stream) // 2, "last": len(stream) - 1}.get(cut, cut)
    part = stream[:n]
    want = _outcome(lambda: brotli_tpu.decompress(part))
    assert want[0] == "error"
    assert _outcome(lambda: bt.decompress(part)) == want


@pytest.fixture(scope="module")
def streams():
    parts = (SLICE_64K, SLICE_200K[:50_000], b"")
    return parts, [bt.compress(p, quality=q)
                   for p, q in zip(parts, (5, 1, 9))]


@pytest.mark.parametrize("k", [2, 3])
def test_decompress_concatenated_matches_jax(streams, k):
    parts, comp = streams
    joined = b"".join(comp[:k])
    out = bt.decompress_concatenated(joined)
    assert out == brotli_tpu.decompress_concatenated(joined) == \
        b"".join(parts[:k])


@pytest.mark.parametrize("tail", ["truncated", "garbage"])
def test_decompress_concatenated_errors_match_jax(streams, tail):
    comp = streams[1]
    joined = comp[0] + (comp[1][:-3] if tail == "truncated"
                        else b"\xff\xfe garbage")
    want = _outcome(lambda: brotli_tpu.decompress_concatenated(joined))
    assert want[0] == "error"
    assert _outcome(lambda: bt.decompress_concatenated(joined)) == want


# ---------------------------------------------------------------------
# Compressor, Decompressor
# ---------------------------------------------------------------------

def _compressor_script(mod, quality):
    """Every call's output of a process/flush/emit_metadata/finish
    script, then the outcome of each call after finish."""
    c = mod.Compressor(quality=quality)
    a, b, d = SLICE_64K[:10_000], SLICE_64K[10_000:30_000], \
        SLICE_64K[30_000:35_000]
    outs = [c.process(a), c.flush(), c.process(b), c.emit_metadata(b"meta"),
            c.process(d), c.flush(), c.process(b""), c.finish(), c.flush(),
            c.finish()]
    outs += [_outcome(lambda: c.process(b"x")),
             _outcome(lambda: c.emit_metadata(b"m"))]
    return outs


@pytest.mark.parametrize("quality", [1, 5, 9])
def test_compressor_matches_jax(quality):
    got = _compressor_script(bt, quality)
    assert got == _compressor_script(brotli_tpu, quality)
    assert got[-2] == ("ValueError", "encoder already finished")
    stream = b"".join(got[:-2])
    assert bt.decompress(stream) == SLICE_64K[:35_000]


def test_compressor_q11_script():
    """q10/q11 streaming walks a binary tree of earlier positions, and
    the port's tree drops what it cannot order against input not yet
    seen (see test_streaming_pieces_decode), so its bytes may differ
    from the JAX package's: the same calls return output, the stream
    decodes, the calls after finish fail alike."""
    got = _compressor_script(bt, 11)
    want = _compressor_script(brotli_tpu, 11)
    assert [bool(x) for x in got[:-2]] == [bool(x) for x in want[:-2]]
    assert got[-2:] == want[-2:]
    assert bt.decompress(b"".join(got[:-2])) == SLICE_64K[:35_000]


def _pieces(mod, data, quality, piece):
    c = mod.Compressor(quality=quality)
    out = []
    for i in range(0, len(data), piece):
        out += [c.process(data[i:i + piece]), c.flush()]
    return b"".join(out) + c.finish()


@pytest.mark.parametrize("quality", [10, 11])
def test_streaming_pieces_decode(quality):
    """The JAX package's q10/q11 stream encoder inserts each position
    into its binary tree comparing only up to the end of the input so
    far; where that prefix equals an older position's, the new node
    takes the old one's children, which may belong on its other side
    once more input arrives, and a later walk then reports a longer
    match than there is. Fed in 500-byte pieces with flushes, this
    input decodes to other bytes from the JAX package's stream. The
    port's tree drops the unordered subtree instead, and its stream
    decodes to the input through both packages."""
    data = CORPUS[100_000:130_000]
    out = _pieces(bt, data, quality, 500)
    assert bt.decompress(out) == data == brotli_tpu.decompress(out)
    ref = _pieces(brotli_tpu, data, quality, 500)
    assert brotli_tpu.decompress(ref) != data


def _drain(mod, stream, chunk, limit, dictionary=None):
    """Feed `stream` to a Decompressor in `chunk`-byte pieces while it
    accepts data, else drain with process(b""); every call's output
    slice and the is_finished/can_accept_more_data sequence."""
    d = mod.Decompressor(dictionary=dictionary)
    events, pos = [], 0
    while not d.is_finished():
        piece = b""
        if d.can_accept_more_data():
            if pos == len(stream):
                break  # the stream ended early
            piece = stream[pos:pos + chunk]
            pos += len(piece)
        out = d.process(piece, output_buffer_limit=limit)
        events.append((out, d.is_finished(), d.can_accept_more_data()))
    return events


@pytest.mark.parametrize("chunk", [1, 4096, 65536])
@pytest.mark.parametrize("limit", [1, 4096, None])
def test_decompressor_matches_jax(limit, chunk):
    data = SLICE_64K[:3000] if 1 in (limit, chunk) else SLICE_200K[:131_072]
    stream = bt.compress(data, quality=5)
    got = _drain(bt, stream, chunk, limit)
    assert got == _drain(brotli_tpu, stream, chunk, limit)
    assert b"".join(e[0] for e in got) == data
    assert got[-1][1:] == (True, False)
    if limit:
        assert max(len(e[0]) for e in got) <= limit


def test_decompressor_dictionary_matches_jax():
    stream = bt.compress(SLICE_64K, quality=5, dictionary=DICT)
    got = _drain(bt, stream, 4096, 4096, dictionary=DICT)
    assert got == _drain(brotli_tpu, stream, 4096, 4096, dictionary=DICT)
    assert b"".join(e[0] for e in got) == SLICE_64K


def test_decompressor_errors_match_jax():
    """Data while output is pending, and a corrupt stream."""
    stream = bt.compress(SLICE_64K, quality=5)
    bad = bytearray(stream)
    bad[len(bad) // 3] ^= 0xFF

    def run(mod):
        d = mod.Decompressor()
        first = d.process(stream, output_buffer_limit=1)
        pending = _outcome(lambda: d.process(b"x"))
        corrupt = _outcome(lambda: mod.Decompressor().process(bytes(bad)))
        return first, pending, corrupt

    got = run(bt)
    assert got == run(brotli_tpu)
    assert got[1][0] == "error" and got[2][0] == "error"


# ---------------------------------------------------------------------
# estimate_peak_memory, reporting hooks, compress_sharded
# ---------------------------------------------------------------------

@pytest.mark.parametrize("quality", [0, 1, 4, 5, 9, 10, 11])
def test_estimate_peak_memory_matches_jax(quality):
    for size in (0, 1, 1000, 1 << 16, 1 << 20, 1 << 24, 1 << 30):
        for lgwin in (10, 16, 22, 24):
            assert bt.estimate_peak_memory(size, quality, lgwin) == \
                brotli_tpu.estimate_peak_memory(size, quality, lgwin)


def test_reporting_callbacks_match_jax():
    def record(mod):
        events = []
        mod.set_reporting_callbacks(
            lambda op, n: events.append(("start", op, n)),
            lambda op, n, m: events.append(("finish", op, n, m)))
        try:
            mod.compress(b"hello")
            mod.compress(b"", quality=1)
            mod.compress(SLICE_64K, quality=5)
            mod.compress(SLICE_64K, quality=3,
                         dictionary=CORPUS[20_000:60_000])
        finally:
            mod.set_reporting_callbacks()
        return events

    got = record(bt)
    assert got == record(brotli_tpu)
    assert len(got) == 8
    bt.compress(b"hello")  # the hooks are gone


@pytest.mark.parametrize("quality,n_shards,size", [
    (5, 2, 100_000), (1, 4, 200_000), (11, 4, 200_000), (9, 2, 0)])
def test_compress_sharded_small_matches_jax(quality, n_shards, size):
    data = SLICE_200K[:size]
    out = PS.compress_sharded(data, quality=quality, n_shards=n_shards,
                              device="cpu")
    assert out == JS.compress_sharded(data, quality=quality,
                                      n_shards=n_shards)
    assert bt.decompress(out) == data
