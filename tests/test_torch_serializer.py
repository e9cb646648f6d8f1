"""The port's Python serializer and the encode routes it opens, against
the JAX package on the CPU.

  (a) `bitstream.store_metablock` bit for bit on the same commands (the
      device matcher's, dictionary references included) at every
      quality, with the context mode chosen and forced to 2 and 3, from
      the stream start and with a distance ring carried in; and each of
      its helpers on seeded inputs;
  (b) `quality.policy` for every quality;
  (c) `compress(encoder="device", device="cpu")` at q1, q5 and q9 in
      modes 0-2 on 64 KiB and 300 KiB, and at q11 in mode 1 on 256 KiB:
      the JAX package's bytes under BROTLI_TPU_ENCODER=device on its
      device branch, and the input back through both of the port's
      decoders;
  (d) `compress_sharded(serializer="python", device="cpu")` against the
      JAX package under BROTLI_TPU_SERIALIZER=python;
  (e) encoder="device" off those inputs (under 64 KiB, q11 under
      256 KiB, beyond lgwin 24, with a dictionary, base64 mode) and a
      base64 mask in `store_metablock`, which raised until the host
      matchers and base64 mode were ported.

The JAX package runs its device branches on the CPU with nothing in it
edited, as in tests/test_torch_matcher.py and test_torch_encode.py:
`backend_or_cpu` reports a GPU, the Pallas chain walk is its XLA twin,
the matcher's buckets and the DP's segments are shrunk in both
packages, and the JAX DP runs v3 (the port's default). Inputs are
in-repo only.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import base64_mode as JB64
from brotli_tpu.enc import bitstream as JB
from brotli_tpu.enc import block_split as JBS
from brotli_tpu.enc import context_model as JCM
from brotli_tpu.enc import encoder as JE
from brotli_tpu.enc import entropy as JEN
from brotli_tpu.enc import literal_cost as JLC
from brotli_tpu.enc import quality as JQ
from brotli_tpu.format.bitio import BitWriter as JBW
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.parallel import shard as JS
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.dec.decoder import Decoder
from brotli_tpu_torch.enc import bitstream as PB
from brotli_tpu_torch.enc import block_split as PBS
from brotli_tpu_torch.enc import context_model as PCM
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.enc import entropy as PEN
from brotli_tpu_torch.enc import literal_cost as PLC
from brotli_tpu_torch.enc import matcher as PM_
from brotli_tpu_torch.enc import quality as PQ
from brotli_tpu_torch.format.bitio import BitWriter as PBW
from brotli_tpu_torch.format import constants as C
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import base64_page, build_corpus

MAXD = C.max_backward_distance(22)
SEG = 1 << 16
CORPUS = build_corpus(1 << 20)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and their OpenMP threads spinning on the same cores made
    these tests twenty times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
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


# -- (a) store_metablock and its helpers ---------------------------------

@pytest.fixture(scope="module")
def parse(device_branch):
    """128 KiB of the corpus and the device matcher's q5 parse of it
    (dictionary references included)."""
    arr = np.frombuffer(CORPUS[300_000:300_000 + (1 << 17)], np.uint8)
    m = PM.find_matches_device(arr, MAXD, 5, device="cpu")
    assert (m[3] >= 2).any(), "no dictionary reference in the parse"
    return arr, m


def _store(B, BW, arr, matches, lo, hi, ring, quality, mode, is_last):
    bw = BW()
    if lo == 0:
        B.write_stream_header(bw, 22)
    cmds = PM_.matches_to_commands(*matches, lo, hi)
    ring = B.store_metablock(bw, arr, lo, hi - lo, cmds, is_last, ring,
                             quality=quality, context_mode=mode)
    bw.align_to_byte()
    return bw.getvalue(), None if ring is None else np.asarray(ring)


@pytest.mark.parametrize("carried", [False, True], ids=["start", "ring"])
@pytest.mark.parametrize("mode", [None, 2, 3])
@pytest.mark.parametrize("quality", range(12))
def test_store_metablock_matches_jax(parse, quality, mode, carried):
    arr, matches = parse
    half = len(arr) // 2
    matches = PM_.split_matches_at(*matches, [half, len(arr)])
    ring = None
    lo, hi = 0, half
    if carried:
        _, ring = _store(JB, JBW, arr, matches, 0, half, None, quality,
                         mode, False)
        lo, hi = half, len(arr)
    got = _store(PB, PBW, arr, matches, lo, hi, ring, quality, mode, True)
    want = _store(JB, JBW, arr, matches, lo, hi, ring, quality, mode, True)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    if not carried:
        assert Decoder().decompress(got[0]) == arr[:half].tobytes()


def test_store_metablock_refuses_a_base64_mask():
    """A base64 mask (base64 mode's regions) forces a flat 6-bit literal
    code on the literals it covers; each metablock equals the JAX
    package's at every quality, for a block that starts in text and one
    that starts inside a region (where the first block type is swapped
    to 0), and the two-block stream decodes."""
    page = base64_page(CORPUS, 1 << 16, seed=1)
    arr = np.frombuffer(page, np.uint8)
    starts, lengths = JB64.detect_regions(arr)
    mask = JB64.region_mask(arr, starts, lengths)
    matches = JB64.drop_matches_in_regions(
        PM_.find_matches_vectorized(arr, MAXD, num_candidates=4,
                                    use_dict=True), mask)
    cut = int(starts[0]) + 10  # the second block starts in a region
    matches = PM_.split_matches_at(*matches, [cut, len(arr)])
    for quality in (1, 5, 9, 10):
        streams = []
        for B, BW in ((PB, PBW), (JB, JBW)):
            bw, ring = BW(), None
            B.write_stream_header(bw, 22)
            for lo, hi in ((0, cut), (cut, len(arr))):
                cmds = PM_.matches_to_commands(*matches, lo, hi)
                ring = B.store_metablock(bw, arr, lo, hi - lo, cmds,
                                         hi == len(arr), ring,
                                         quality=quality, b64_mask=mask)
            bw.align_to_byte()
            streams.append(bw.getvalue())
        assert streams[0] == streams[1]
        assert JN.decode(streams[0]) == page
        assert Decoder().decompress(streams[0]) == page


@pytest.mark.parametrize("seed", range(4))
def test_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    ntrees = int(rng.integers(2, 40))
    cmap = rng.integers(0, ntrees, 64 * int(rng.integers(1, 5)))
    cmap[rng.random(len(cmap)) < 0.5] = 0  # zero runs: the RLE path
    bws = PBW(), JBW()
    PB.write_context_map(bws[0], cmap, ntrees)
    JB.write_context_map(bws[1], cmap, ntrees)
    payload = rng.bytes(int(rng.integers(0, 3000)))
    PB.write_metadata_block(bws[0], payload)
    JB.write_metadata_block(bws[1], payload)
    lens = rng.integers(1, 5000, 3000)
    types = rng.integers(0, 5, len(lens))
    types[0] = 0
    for B, bw in zip((PB, JB), bws):
        sw = B._plan_block_switches(types, lens, 5)
        B._write_block_header(bw, sw, 5)
    assert bws[0].getvalue() == bws[1].getvalue()
    dists = rng.integers(1, 1 << 20, 40_000) if seed % 2 else \
        np.repeat(rng.integers(1, 64, 300), 100)
    assert PB.choose_distance_params(dists) == \
        JB.choose_distance_params(dists)
    freqs = rng.integers(0, 1000, 704)
    lengths = PEN.package_merge(freqs, 15)
    np.testing.assert_array_equal(lengths, JEN.package_merge(freqs, 15))
    assert PEN.code_bit_cost(freqs, lengths) == \
        JEN.code_bit_cost(freqs, lengths)


@pytest.mark.parametrize("seed", range(3))
def test_context_model_block_split_literal_cost_match_jax(seed):
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(0, len(CORPUS) - 70_000))
    data = np.frombuffer(CORPUS[lo:lo + 65_536], np.uint8)
    assert PCM.choose_context_mode(data) == JCM.choose_context_mode(data)
    pos = np.sort(rng.choice(len(data), 20_000, replace=False))
    for mode in range(4):
        np.testing.assert_array_equal(
            PCM.literal_context_ids(data, pos, mode, 0),
            JCM.literal_context_ids(data, pos, mode, 0))
    ids = PCM.literal_context_ids(data, pos, 2, 0)
    hists = PCM.context_histograms(data[pos], ids, 64, 256)
    np.testing.assert_array_equal(
        hists, JCM.context_histograms(data[pos], ids, 64, 256))
    for table_cost in (60.0, 180.0):
        got = PCM.cluster_histograms(hists, max_trees=12,
                                     table_cost_bits=table_cost)
        want = JCM.cluster_histograms(hists, max_trees=12,
                                      table_cost_bits=table_cost)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    vals = rng.integers(0, 9, 500)
    np.testing.assert_array_equal(PCM.mtf_transform(vals),
                                  JCM.mtf_transform(vals))
    for chunk, alphabet, symbols in ((512, 256, data),
                                     (256, 704, rng.integers(0, 704,
                                                             9000))):
        got = PBS.split_symbols(symbols, alphabet, chunk=chunk)
        want = JBS.split_symbols(symbols, alphabet, chunk=chunk)
        assert (got is None) == (want is None)
        for g, w in zip(got or (), want or ()):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(PLC.estimate_literal_bits(data),
                                  JLC.estimate_literal_bits(data))
    assert PLC.is_mostly_utf8(data) == JLC.is_mostly_utf8(data)


# -- (b) the quality policy ----------------------------------------------

@pytest.mark.parametrize("quality", range(-1, 13))
def test_quality_policy_matches_jax(quality):
    assert dataclasses.asdict(PQ.policy(quality)) == \
        dataclasses.asdict(JQ.policy(quality))


# -- (c) encoder="device" ------------------------------------------------

def _check_device_route(device_branch, data, quality, mode):
    device_branch.setenv("BROTLI_TPU_ENCODER", "device")
    try:
        want = JE.encode(data, quality=quality, mode=mode)
    finally:
        device_branch.delenv("BROTLI_TPU_ENCODER")
    got = bt.compress(data, mode=mode, quality=quality, encoder="device",
                      device="cpu")
    assert got == want
    assert bt.decompress(got) == data
    assert bt.decompress(got, decoder="python") == data
    assert JN.decode(got) == data
    return got


@pytest.mark.parametrize("size", [1 << 16, 300_000], ids=["64K", "300K"])
@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("quality", [1, 5, 9])
def test_encoder_device_below_q10(device_branch, quality, mode, size):
    data = CORPUS[50_000:50_000 + size]
    got = _check_device_route(device_branch, data, quality, mode)
    assert got != bt.compress(data, mode=mode, quality=quality)


def test_encoder_device_q11_mode1(device_branch):
    _check_device_route(device_branch, CORPUS[50_000:50_000 + (1 << 18)],
                        11, 1)


def test_encoder_device_stores_incompressible_input(device_branch):
    """The uncompressed fallback of the route, as in the JAX package."""
    data = np.random.default_rng(5).integers(
        0, 256, 1 << 16, dtype=np.uint8).tobytes()
    got = _check_device_route(device_branch, data, 5, 0)
    assert len(got) <= len(data) + 16


# -- (d) compress_sharded(serializer="python") ----------------------------

@pytest.mark.parametrize("quality", [1, 5, 9])
def test_compress_sharded_python_serializer(device_branch, quality):
    data = CORPUS[50_000:350_000]
    devs = jax.devices()
    device_branch.setattr(jax, "devices", lambda *a: devs[:1])
    device_branch.setenv("BROTLI_TPU_SERIALIZER", "python")
    try:
        want = JS.compress_sharded(data, quality=quality, n_shards=2)
    finally:
        device_branch.delenv("BROTLI_TPU_SERIALIZER")
        device_branch.setattr(jax, "devices", lambda *a: devs)
    got = PS.compress_sharded(data, quality=quality, n_shards=2,
                              serializer="python", device="cpu")
    assert got == want
    assert got != PS.compress_sharded(data, quality=quality, n_shards=2,
                                      device="cpu")
    assert bt.decompress(got) == data
    assert bt.decompress(got, decoder="python") == data


# -- (e) what raised before the host matchers were ported ---------------

_UNPORTED = {
    "q5 under 64 KiB": dict(size=(1 << 16) - 1, quality=5),
    "q11 under 256 KiB in mode 1": dict(size=32 << 10, quality=11,
                                        mode=1),
    "beyond lgwin 24": dict(quality=5, lgwin=25, large_window=True),
    "raw dictionary": dict(quality=5, mode=1, dictionary=b"abcdef"),
    "raw dictionary mode 0": dict(quality=5, dictionary=b"abcdef"),
    "raw dictionary q11": dict(size=1 << 18, quality=11,
                               dictionary=b"abcdef"),
    "empty dictionary": dict(quality=5, dictionary=b""),
    "base64 mode": dict(quality=5, base64_mode=True),
}


@pytest.mark.parametrize("case", list(_UNPORTED))
def test_encoder_device_off_its_inputs_raises(device_branch, case,
                                              monkeypatch):
    """encoder="device" off the inputs of the device finders alone
    (which raised NotImplementedError until the host matchers were
    ported) gives the JAX package's bytes under
    BROTLI_TPU_ENCODER=device on its device branch, and decodes through the JAX package's native decoder and
    both of the port's. "q11 under 256 KiB in mode 1" runs the host DP
    on 32 KiB; just under 256 KiB it is the same finder, which the spy
    below checks. "raw dictionary q11" takes the port's card route with
    the dictionary as history (RFC 9842 dcb), which the JAX package
    lacks: its Python pipeline (encoder="python") gives the JAX bytes,
    and the card route's stream decodes and is at most 1% larger."""
    kw = dict(_UNPORTED[case])
    data = CORPUS[:kw.pop("size", 1 << 17)]
    if kw.get("base64_mode"):
        data = base64_page(CORPUS, len(data))
    out = bt.compress(data, encoder="device", device="cpu", **kw)
    device_branch.setenv("BROTLI_TPU_ENCODER", "device")
    try:
        want = JE.encode(data, **kw)
    finally:
        device_branch.delenv("BROTLI_TPU_ENCODER")
    if case == "raw dictionary q11":
        pipeline = bt.compress(data, encoder="python", device="cpu", **kw)
        assert pipeline == want and len(out) <= 1.01 * len(want)
        assert JN.decode(pipeline, compound=kw["dictionary"]) == data
    else:
        assert out == want
    dic = kw.get("dictionary") or b""
    assert JN.decode(out, compound=dic,
                     large_window=kw.get("large_window", False)) == data
    assert bt.decompress(out, dictionary=dic,
                         large_window=kw.get("large_window", False)) == data
    if case == "q11 under 256 KiB in mode 1":
        assert Decoder().decompress(out) == data
        # just under 256 KiB the finder is the same, the host DP (a spy
        # that finds no match; the device DP must not run)
        called = []

        def host_dp(arr, *a, **k):
            called.append(len(arr))
            z = np.zeros(0, np.int64)
            return z, z, z, z

        def device_dp(*a, **k):
            raise AssertionError("the device DP ran under 256 KiB")

        monkeypatch.setattr(PE.host_dp, "find_matches_optimal", host_dp)
        monkeypatch.setattr(PE, "find_matches_optimal", device_dp)
        under = CORPUS[:(1 << 18) - 1]
        out = bt.compress(under, quality=11, mode=1, encoder="device",
                          device="cpu")
        assert called == [len(under)]
        assert bt.decompress(out) == under
