"""The Python half of the port's streaming encoder, `encoder="python"`
and `compress_sharded(use_device=False)`, against the JAX package on
the CPU, byte for byte:

  (a) `Compressor` and `StreamingEncoder` in modes 1 and 2 (and mode 0
      with encoder="python"), fed pieces with flushes, with
      emit_metadata, and beyond lgwin 24: the host matchers under
      backend="numpy" against BROTLI_TPU_BACKEND=numpy, and the card's
      routes with device="cpu" (the device matcher at q5, the device DP
      at q11 on 256 KiB) against the JAX package's device branch; every
      flushed prefix decodes on its own;
  (b) `compress(encoder="python")` at q1, q5 and q9 on the card's route
      (device="cpu") and on the host (backend="numpy");
  (c) `compress_sharded(use_device=False)`: the host vectorized matcher
      per shard, with each serializer.

The JAX package's device branch is reported by patching
`backend_or_cpu` (with the Pallas chain walk its XLA twin and the
matcher's buckets and the DP's segments shrunk in both packages), as in
tests/test_torch_serializer.py. Inputs are in-repo only.
"""

import os

import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import encoder as JE
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.parallel import shard as JS
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import build_corpus

CORPUS = build_corpus(1 << 20)
SEG = 1 << 16
DATA = CORPUS[200_000:350_000]   # the end of the C source, then text


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


def _feed(enc, data, pieces, metadata=None):
    """(stream, flushed prefixes): `data` cut at `pieces` (offsets),
    each piece flushed; `metadata` emitted after the first piece."""
    out, prefixes, lo = b"", [], 0
    for i, hi in enumerate(list(pieces) + [len(data)]):
        out += enc.process(data[lo:hi])
        if metadata is not None and i == 0:
            out += enc.emit_metadata(metadata)
        out += enc.flush()
        prefixes.append((out, data[:hi]))
        lo = hi
    return out + enc.finish(), prefixes


def _check(got, want, data, large_window=False):
    out, prefixes = got
    assert out == want[0]
    for prefix, expect in prefixes:  # each flushed prefix on its own
        assert bt.decompress(prefix + b"\x03", large_window=large_window) \
            == expect
    assert JN.decode(out, large_window=large_window) == data
    assert bt.decompress(out, decoder="python",
                         large_window=large_window) == data


# -- (a) the Python half of the streaming encoder -------------------------

_STREAMS = {
    # (the port's keywords, the JAX package's variables, mode, quality,
    #  piece offsets)
    "mode 1 q5 host": (dict(backend="numpy"),
                       {"BROTLI_TPU_BACKEND": "numpy"}, 1, 5,
                       (40_000, 100_000)),
    "mode 2 q9 host": (dict(backend="numpy"),
                       {"BROTLI_TPU_BACKEND": "numpy"}, 2, 9,
                       (70_000,)),
    "mode 2 q5 card": (dict(device="cpu"), {}, 2, 5, (50_000, 100_000)),
    "mode 1 q1 card": (dict(device="cpu"), {}, 1, 1, (80_000,)),
    "mode 0 q5 python": (dict(encoder="python", device="cpu"),
                         {"BROTLI_TPU_ENCODER": "python"}, 0, 5,
                         (30_000, 90_000)),
}


@pytest.mark.parametrize("case", list(_STREAMS))
def test_compressor_python_half(case, monkeypatch):
    kw, env, mode, quality, pieces = _STREAMS[case]
    got = _feed(bt.Compressor(mode=mode, quality=quality, **kw), DATA,
                pieces)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = _feed(brotli_tpu.Compressor(mode=mode, quality=quality), DATA,
                 pieces)
    _check(got, want, DATA)


def test_compressor_q11_card_route():
    """q11 in mode 1 on 256 KiB, flushed: the device DP over the whole
    buffer (the JAX package's find_matches_optimal_jax), then the Python
    serializer; an empty finish."""
    data = CORPUS[:1 << 18]
    got = _feed(bt.Compressor(mode=1, quality=11, device="cpu"), data, ())
    want = _feed(brotli_tpu.Compressor(mode=1, quality=11), data, ())
    _check(got, want, data)


def test_compressor_emit_metadata(monkeypatch):
    got = _feed(bt.Compressor(mode=2, quality=5, backend="numpy"), DATA,
                (60_000,), metadata=b"hello, metadata")
    monkeypatch.setenv("BROTLI_TPU_BACKEND", "numpy")
    want = _feed(brotli_tpu.Compressor(mode=2, quality=5), DATA, (60_000,),
                 metadata=b"hello, metadata")
    _check(got, want, DATA)


def test_streaming_encoder_large_window():
    """StreamingEncoder beyond lgwin 24 in mode 1: the host vectorized
    matcher over the history and the buffer at each flush."""
    def make(mod):
        return mod.StreamingEncoder(quality=5, lgwin=25, mode=1,
                                    large_window=True)
    got = _feed(make(PE), DATA, (70_000,))
    want = _feed(make(JE), DATA, (70_000,))
    _check(got, want, DATA, large_window=True)


def test_streaming_encoder_history_is_the_window(monkeypatch):
    """A window of 64 KiB (lgwin 16) keeps 64 KiB of history between
    flushes: pieces longer than the window, in both packages."""
    got = _feed(PE.StreamingEncoder(quality=5, lgwin=16, mode=1,
                                    backend="numpy"), DATA,
                (10_000, 90_000))
    monkeypatch.setenv("BROTLI_TPU_BACKEND", "numpy")
    want = _feed(JE.StreamingEncoder(quality=5, lgwin=16, mode=1), DATA,
                 (10_000, 90_000))
    _check(got, want, DATA)


def test_finished_encoder_refuses_input():
    enc = bt.Compressor(mode=1, quality=5, backend="numpy")
    out = enc.process(DATA[:5000]) + enc.finish()
    assert bt.decompress(out) == DATA[:5000]
    assert enc.finish() == b"" and enc.flush() == b""
    with pytest.raises(ValueError):
        enc.process(b"more")


# -- (b) encoder="python" -----------------------------------------------------

@pytest.mark.parametrize("quality", [1, 5, 9])
@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_encoder_python(quality, backend, monkeypatch):
    out = bt.compress(DATA, quality=quality, encoder="python",
                      backend=backend, device="cpu")
    monkeypatch.setenv("BROTLI_TPU_ENCODER", "python")
    if backend == "numpy":
        monkeypatch.setenv("BROTLI_TPU_BACKEND", "numpy")
    assert out == brotli_tpu.compress(DATA, quality=quality)
    assert JN.decode(out) == DATA
    assert bt.decompress(out, decoder="python") == DATA


# -- (c) compress_sharded(use_device=False) --------------------------------

@pytest.mark.parametrize("kw", [
    dict(quality=1, n_shards=2), dict(quality=9, n_shards=3),
    dict(quality=11, n_shards=2), dict(quality=5, serializer="python")],
    ids=["q1-2", "q9-3", "q11-2", "q5-python"])
def test_compress_sharded_on_the_host(kw, monkeypatch):
    data = CORPUS[:300_000]
    out = PS.compress_sharded(data, use_device=False, **kw)
    if kw.get("serializer") == "python":
        monkeypatch.setenv("BROTLI_TPU_SERIALIZER", "python")
    jkw = {k: v for k, v in kw.items() if k != "serializer"}
    assert out == JS.compress_sharded(data, use_device=False, **jkw)
    assert JN.decode(out) == data
    assert bt.decompress(out) == data
