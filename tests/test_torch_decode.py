"""The port's device decoder against the JAX package's, bit for bit, on
the CPU.

  (a) `native.parse_stream` against brotli_tpu.native.parse_stream on
      every stream of tests/fuzz_corpus/ (the command list, literals and
      depth bound, or the same error code) and on in-repo encodes;
  (b) `resolve_plain` against `lz_resolve._resolve` on every parse of
      (a), with the JAX package's round count and with fewer rounds
      than the copy chains are deep (the doubling is out of place, so a
      cut-short resolve gives the same bytes);
  (c) `decompress(decoder="device", device="cpu")` against
      brotli_tpu.dec.device_decode.decompress_device; the errors: no
      CUDA, a corrupt stream, the Python decoder, a copy from before
      the output.

Inputs are in-repo only: the fuzz corpus, and streams of the JAX
package's native encoder over the port's corpus generator and over an
RLE-heavy input whose copy chains run deep.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.dec import device_decode as JDD
from brotli_tpu.ops import lz_resolve as JL
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.dec import device_decode as PDD
from brotli_tpu_torch.ops import kernels
from brotli_tpu_torch.ops import lz_resolve as PL
from brotli_tpu_torch.tools.corpus import build_corpus

FUZZ = sorted((pathlib.Path(__file__).parent / "fuzz_corpus").iterdir())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_shard.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rle_input():
    """Runs of one byte and of short periods, with literals between:
    copies at distances 1..4 whose chains run thousands deep."""
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(40):
        period = rng.integers(0, 256, int(rng.integers(1, 5)),
                              dtype=np.uint8)
        parts.append(np.tile(period, int(rng.integers(500, 8000))))
        parts.append(rng.integers(0, 256, int(rng.integers(0, 40)),
                                  dtype=np.uint8))
    return np.concatenate(parts).tobytes()


ENCODES = {
    "corpus q5": lambda: brotli_tpu.compress(
        build_corpus(1 << 20)[:300_000], quality=5),
    "corpus q9": lambda: brotli_tpu.compress(
        build_corpus(1 << 20)[300_000:500_000], quality=9),
    "corpus q11": lambda: brotli_tpu.compress(
        build_corpus(1 << 20)[500_000:620_000], quality=11),
    "rle q5": lambda: brotli_tpu.compress(_rle_input(), quality=5),
    "rle q1": lambda: brotli_tpu.compress(_rle_input(), quality=1),
}


def _resolve_both(parse, n_steps):
    lits, cn, cc, cd, _ = parse
    n_out = int(cn.sum(dtype=np.int64) + cc.sum(dtype=np.int64))
    la = np.frombuffer(lits, np.uint8)
    if len(la) == 0:
        la = np.zeros(1, np.uint8)
    cmds = [c.astype(np.int32) for c in (cn, cc, cd)]
    ref = np.asarray(JL._resolve(jnp.asarray(la), *map(jnp.asarray, cmds),
                                 n_out, n_steps))
    got = PL.resolve_plain(torch.from_numpy(la.copy()),
                           *map(torch.from_numpy, cmds), n_out, n_steps)
    np.testing.assert_array_equal(got.numpy(), ref)
    return ref


def _same_parse(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:4], b[1:4]):
        assert x.dtype == y.dtype == np.uint32
        np.testing.assert_array_equal(x, y)
    assert a[4] == b[4]


@pytest.mark.parametrize("path", FUZZ, ids=[p.name for p in FUZZ])
def test_fuzz_stream_parse_and_resolve(path):
    """A fuzz stream parses to the same command list in both packages
    (or fails with the same code in both); one that parses resolves to
    the bytes the JAX package's resolve and native decoder give."""
    data = path.read_bytes()
    try:
        ref = JN.parse_stream(data)
    except JN.DecodeError as e:
        with pytest.raises(PN.DecodeError) as got:
            PN.parse_stream(data)
        assert got.value.code == e.code
        with pytest.raises(bt.error):
            bt.decompress(data, decoder="device", device="cpu")
        return
    parse = PN.parse_stream(data)
    _same_parse(parse, ref)
    n_out = int(ref[1].sum(dtype=np.int64) + ref[2].sum(dtype=np.int64))
    if n_out == 0:
        assert bt.decompress(data, decoder="device", device="cpu") == b""
        return
    out = _resolve_both(parse, PL.n_steps_for(n_out, ref[4]))
    assert out.tobytes() == JN.decode(data)
    assert bt.decompress(data, decoder="device", device="cpu") == \
        out.tobytes()


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_encoded_stream_resolve_matches_jax(name):
    """In-repo encodes: the parse, the resolve at the JAX package's
    round count, and every cut-short count below the chains' depth."""
    data = ENCODES[name]()
    parse = PN.parse_stream(data)
    _same_parse(parse, JN.parse_stream(data))
    n_out = int(parse[1].sum(dtype=np.int64) + parse[2].sum(dtype=np.int64))
    depth = parse[4]
    full = PL.n_steps_for(n_out, depth)
    assert _resolve_both(parse, full).tobytes() == JN.decode(data)
    cuts = range(0, full) if full <= 6 else (0, 1, full // 2, full - 1)
    for n_steps in cuts:
        _resolve_both(parse, n_steps)
    if name.startswith("rle"):
        assert depth > 1000


@pytest.mark.parametrize("name", sorted(ENCODES))
def test_decompress_device_matches_jax(name):
    data = ENCODES[name]()
    ref = JDD.decompress_device(data)
    assert PDD.decompress_device(data, device="cpu") == ref
    assert bt.decompress(data, decoder="device", device="cpu") == ref
    assert bt.decompress(data) == ref


def test_decompress_device_large_window():
    """large_window reaches the parse: a stream with a 2**25 window
    decodes only when it is set."""
    raw = build_corpus(1 << 20)[:200_000]
    data = brotli_tpu.compress(raw, quality=5, lgwin=25, large_window=True)
    with pytest.raises(PN.DecodeError):
        PDD.decompress_device(data, device="cpu")
    assert PDD.decompress_device(data, large_window=True,
                                 device="cpu") == raw
    assert JDD.decompress_device(data, large_window=True) == raw


def test_device_decoder_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = ENCODES["corpus q5"]()
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.decompress(stream, decoder="device")
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.resolve(b"a", [1], [0], [0])


@pytest.mark.parametrize("cut", ["truncated", "flipped"])
def test_corrupt_stream_raises(cut):
    stream = bytearray(ENCODES["corpus q5"]())
    if cut == "truncated":
        stream = stream[:len(stream) // 2]
    else:
        stream[len(stream) // 3] ^= 0xFF
        stream[len(stream) // 3 + 1] ^= 0x5A
    with pytest.raises(bt.error):
        bt.decompress(bytes(stream), decoder="device", device="cpu")


def test_decoder_choices():
    stream = ENCODES["corpus q5"]()
    with pytest.raises(NotImplementedError, match="M13"):
        bt.decompress(stream, decoder="python")
    with pytest.raises(ValueError, match="decoder"):
        bt.decompress(stream, decoder="gpu")


def test_copy_from_before_the_output_raises():
    """A copy that reaches before the output never comes out of the
    native parse; the plain resolve refuses it, K5's wrapper refuses a
    CPU tensor."""
    one = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="before the output"):
        PL.resolve_plain(torch.tensor([7], dtype=torch.uint8), one,
                         torch.tensor([5], dtype=torch.int32),
                         torch.tensor([2], dtype=torch.int32), 6, 3)
    with pytest.raises(ValueError, match="before the output"):
        PL.resolve(b"\x07", [1], [5], [2], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.lz_resolve(torch.tensor([7], dtype=torch.uint8), one, one,
                           one, 2, 1)


@pytest.mark.parametrize("lits,cmds", [
    (b"", ([], [], [])), (b"", ([0, 3], [0, 0], [0, 0])),
    (b"z", ([1], [0], [0])), (b"ab", ([2, 0], [6, 3], [2, 1])),
    (b"xyz", ([3, 0, 0], [0, 0, 40], [0, 0, 3]))])
def test_resolve_edges(lits, cmds):
    """No output; literals from an empty literal stream (the one-byte
    gather base: zeros); n_out 1; overlapping copies at 1 and 2."""
    out = PL.resolve(lits, *cmds, device="cpu")
    assert out == JL.resolve(lits, *cmds)
    assert len(out) == sum(cmds[0]) + sum(cmds[1])


def test_round_count():
    assert PL.n_steps_for(1) == 1
    assert PL.n_steps_for(1 << 20, max_depth=5) == 3
    assert PL.n_steps_for(1 << 20, max_depth=1 << 30) == 20
