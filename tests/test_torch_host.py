"""The host half of brotli_tpu_torch against brotli_tpu, bit for bit.

The port copies what it needs of the JAX package's host code (cost
tables, seed parse, segment prep, match post-processing, command
planning) instead of importing it; every copy must give the same
arrays as the original on the same inputs. Also: the 32-bit lane
helpers, the port's import isolation, its device rule (no quiet CPU
fallback) and the errors of its public API.

Inputs are in-repo only: the port's corpus generator (its copies of the
native C sources, RFC 7932 dictionary words, numpy-seeded bytes).
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import bitstream as JB
from brotli_tpu.enc import encoder as JE
from brotli_tpu.enc import matcher as JM
from brotli_tpu.enc import optimal as JO
from brotli_tpu.format import constants as C
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.enc import bitstream as PB
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.enc import matcher as PM
from brotli_tpu_torch.enc import optimal as PO
from brotli_tpu_torch.ops import kernels
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus
from brotli_tpu_torch.utils import u32
from brotli_tpu_torch.utils.device import resolve

REPO = pathlib.Path(__file__).resolve().parent.parent
MAXD = C.max_backward_distance(22)
SEG = 1 << 16


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
def v3():
    """Both packages at the JAX package's defaults: no BROTLI_TPU_*
    variable but BROTLI_TPU_DP=v3, and 64 KiB segments."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        mp.setenv("BROTLI_TPU_DP", "v3")
        mp.setattr(OJ, "SEG_V3", SEG)
        mp.setattr(OJ, "_BUCKETS_V3", [SEG])
        mp.setattr(O, "SEG_V3", SEG)
        mp.setattr(O, "BUCKETS_V3", [SEG])
        yield


@pytest.fixture(scope="module")
def arr():
    """200 KB: C source, then dictionary-word text (dense enough in
    words to exercise the dictionary paths, sparse enough that the
    dictionary probe stays under its cap of one hit per 8 bytes)."""
    data = build_corpus(1 << 20)[120_000:320_000]
    return np.frombuffer(data, np.uint8)


@pytest.fixture(scope="module")
def seeds(v3, arr):
    seed = O._seed_parse(arr, MAXD, 0)
    return seed, OJ._seed_parse(arr, MAXD, 0)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _eq_all(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        _eq(x, y)


# ---------------------------------------------------------------------
# 32-bit lane helpers
# ---------------------------------------------------------------------

_EDGE_U32 = np.array([0, 1, 2, 3, 255, 256, 65535, 65536, (1 << 31) - 1,
                      1 << 31, (1 << 32) - 2, (1 << 32) - 1], np.uint64)


@pytest.mark.parametrize("const", [int(OJ.HASH_MUL), int(OJ.HASH_MUL2),
                                   0xFFFFFFFF])
def test_u32_mul_wraps_like_uint32(const):
    rng = np.random.default_rng(1)
    a = np.concatenate([_EDGE_U32.astype(np.uint32),
                        rng.integers(0, 1 << 32, 4096, dtype=np.uint32)])
    want = a * np.uint32(const)
    got = u32.mul(torch.from_numpy(a.astype(np.int64)), const)
    _eq(got.numpy(), want.astype(np.int64))


def test_u32_bit_length_exact():
    rng = np.random.default_rng(2)
    v = np.concatenate([_EDGE_U32, rng.integers(0, 1 << 32, 4096,
                                                dtype=np.uint64)])
    want = np.array([int(x).bit_length() for x in v], np.int64)
    got = u32.bit_length(torch.from_numpy(v.astype(np.int64)))
    _eq(got.numpy(), want)


@pytest.mark.parametrize("k", [0, 1, 14, 15, 31])
def test_u32_shr_is_logical(k):
    v = _EDGE_U32.astype(np.uint32)
    got = u32.shr(torch.from_numpy(v.astype(np.int64)), k)
    _eq(got.numpy(), (v >> np.uint32(k)).astype(np.int64))


def test_dist_cost_q_matches_jax():
    rng = np.random.default_rng(3)
    dist = np.concatenate([np.arange(0, 300), 1 << np.arange(25),
                           (1 << np.arange(1, 26)) - 1,
                           rng.integers(1, 1 << 25, 4096)]).astype(np.int32)
    tab = rng.integers(0, 400, 64).astype(np.int32)
    want = OJ._dist_cost_q(jnp.asarray(dist), jnp.asarray(tab))
    got = O._dist_cost_q(torch.from_numpy(dist), torch.from_numpy(tab))
    _eq(got.numpy(), np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------
# (a) copied host helpers
# ---------------------------------------------------------------------

def test_seed_parse_matches(seeds):
    port, ref = seeds
    _eq_all(port, ref)
    assert len(port[0]) > 1000


@pytest.mark.parametrize("sample", [None, 1 << 16])
def test_cost_tables_match(seeds, arr, sample, monkeypatch):
    """lit_table=True branch, whole input and bounded sample, with the
    implicit-cell row."""
    seed = seeds[0]
    cfg = O.DPConfig()
    if sample is not None:
        cfg = O.DPConfig(cost_sample=sample)
        monkeypatch.setenv("BROTLI_TPU_COST_SAMPLE", str(sample))
    port = O._cost_tables(arr, seed, lit_table=True, cfg=cfg)
    ref = OJ._cost_tables(arr, seed, lit_table=True)
    _eq_all(port, ref)
    assert port[0].shape == (64, 256) and port[2].shape == (64,)


@pytest.mark.parametrize("lo,hi,cap", [(0, SEG, SEG // 128),
                                       (SEG, 2 * SEG, SEG // 128),
                                       (3 * SEG, 200_000, SEG // 128),
                                       (SEG, 2 * SEG, 8)])
def test_seg_seed_edges_match(seeds, lo, hi, cap):
    seed = seeds[0]
    _eq_all(O._seg_seed_edges([seed], lo, hi, cap),
            OJ._seg_seed_edges([seed], lo, hi, cap))


@pytest.fixture(scope="module")
def dict_g(seeds, arr):
    port = O._dict_probe_global(arr, [seeds[0]], 0, MAXD)
    ref = OJ._dict_probe_global(arr, [seeds[0]], 0, MAXD)
    return port, ref


def test_dict_probe_global_matches(dict_g):
    port, ref = dict_g
    _eq_all(port, ref)
    assert len(port[0]) > 100


@pytest.mark.parametrize("lo,hi,b", [(0, SEG, SEG), (SEG, 2 * SEG, SEG),
                                     (3 * SEG, 200_000, SEG),
                                     (2 * SEG, 3 * SEG, 1 << 12)])
def test_prep_segment_v3_matches(seeds, dict_g, arr, lo, hi, b):
    dpos, dpay, _ = dict_g[0]
    port = O._prep_segment_v3(arr, [seeds[0]], dpos, dpay, lo, hi, b)
    ref = OJ._prep_segment_v3(arr, [seeds[0]], dpos, dpay, lo, hi, b)
    assert port[0] == ref[0]
    _eq_all(port[1:], ref[1:])


def _chunked(seed, piece, hole_every):
    """The seed parse cut into `piece`-byte chunks (as the DP emits long
    matches), every `hole_every`-th chunk one byte short: input for
    _coalesce and bridge_matches."""
    m, lens, dists, flags = seed
    out = [[], [], [], []]
    k = 0
    for p, ln, d, f in zip(m.tolist(), lens.tolist(), dists.tolist(),
                           flags.tolist()):
        off = 0
        while ln - off >= 2:
            step = min(piece, ln - off)
            k += 1
            cut = 1 if (k % hole_every == 0 and step > 3) else 0
            for o, v in zip(out, (p + off, step - cut, d, f)):
                o.append(v)
            off += step
    return tuple(np.array(o, np.int64) for o in out)


@pytest.mark.parametrize("piece,hole_every", [(7, 1 << 30), (16, 3),
                                              (63, 2)])
def test_coalesce_and_bridge_match(seeds, arr, piece, hole_every):
    mats = _chunked(seeds[0], piece, hole_every)
    _eq_all(PO._coalesce(*mats), JO._coalesce(*mats))
    port = PO.bridge_matches(arr, *mats)
    _eq_all(port, JO.bridge_matches(arr, *mats))
    assert len(port[0]) < len(mats[0])


@pytest.fixture(scope="module")
def with_dict(seeds, arr):
    """The seed parse plus the dictionary post-pass (flags 2000+)."""
    port = PM.add_dictionary_matches(arr, *seeds[0], MAXD)
    _eq_all(port, JM.add_dictionary_matches(arr, *seeds[0], MAXD))
    assert (port[3] >= 2000).sum() > 10
    return port


@pytest.mark.parametrize("active_from,base", [(0, 0), (70_000, 0),
                                              (0, 1 << 20)])
def test_add_dictionary_matches_matches(seeds, arr, active_from, base):
    m, lens, dists, flags = seeds[0]
    _eq_all(PM.add_dictionary_matches(arr, m, lens, dists, flags, MAXD,
                                      base, active_from),
            JM.add_dictionary_matches(arr, m, lens, dists, flags, MAXD,
                                      base, active_from))


@pytest.mark.parametrize("bounds", [[1 << 16, 200_001],
                                    [50_000, 100_000, 150_000, 200_001]])
def test_split_matches_at_matches(with_dict, bounds):
    _eq_all(PM.split_matches_at(*with_dict, bounds),
            JM.split_matches_at(*with_dict, bounds))


@pytest.mark.parametrize("lo,hi", [(0, 200_000), (65_536, 131_072)])
def test_matches_to_commands_matches(with_dict, lo, hi):
    _eq_all(PM.matches_to_commands(*with_dict, lo, hi),
            JM.matches_to_commands(*with_dict, lo, hi))


@pytest.mark.parametrize("ring", [None, [17, 4, 11, 16]])
def test_plan_commands_matches(with_dict, ring):
    ins, cpy, dist, flag = PM.matches_to_commands(*with_dict, 0, 200_000)
    ring = None if ring is None else np.array(ring, np.int64)
    port, pring = PB.plan_commands(ins, cpy, dist, ring, flag)
    ref, rring = JB.plan_commands(ins, cpy, dist, ring, flag)
    assert port.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], tuple):
            _eq_all(port[k], ref[k])
        else:
            _eq(port[k], ref[k])
    _eq(pring, rring)


def test_store_uncompressed_matches(arr):
    _eq(np.frombuffer(PE._store_uncompressed(arr, 22), np.uint8),
        np.frombuffer(JE._store_uncompressed(arr, 22), np.uint8))


def test_native_decode_matches(arr):
    comp = JN.encode(arr.tobytes(), 5, 22)
    assert PN.decode(comp) == JN.decode(comp) == arr.tobytes()


def test_native_serialize_region_matches(with_dict, arr):
    data = arr.tobytes()
    port = PN.serialize_region(data, 0, len(data), with_dict, 11, 22,
                               write_header=True, is_last=True)
    ref = JN.serialize_region(data, 0, len(data), with_dict, 11, 22,
                              write_header=True, is_last=True)
    assert port[0] == ref[0]
    _eq(port[1], ref[1])
    assert bt.decompress(port[0]) == data


# ---------------------------------------------------------------------
# the corpus, the device rule, the API, the import isolation
# ---------------------------------------------------------------------

def test_corpus_is_deterministic():
    a = build_corpus(1 << 19, seed=0)
    assert len(a) == 1 << 19
    assert a == build_corpus(1 << 19, seed=0)
    assert a != build_corpus(1 << 19, seed=1)
    src = (REPO / "brotli_tpu_torch" / "native" / "btpu_enc.c").read_bytes()
    assert a.startswith(src)
    big = build_corpus(1 << 20)
    text = big[len(src) + 70_000:-(1 << 20) // 20]
    assert text.count(b" ") > len(text) // 20  # words, then spaces


def test_resolve_device():
    assert resolve("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve("meta")


def test_no_cuda_raises(monkeypatch, arr):
    """(i) device=None means the card; without CUDA that raises and
    never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.compress(build_corpus(1 << 18))
    with pytest.raises(RuntimeError, match="CUDA"):
        O.find_matches_optimal(arr, MAXD)


_SMALL = 16 << 10  # q11 under 256 KiB takes the host DP: seconds a call


def _serialized_prefix():
    """A serialized dictionary holding one raw prefix."""
    from brotli_tpu_torch.format import shared_dictionary as shd
    return shd.serialize(prefixes=[build_corpus(1 << 20)[600_000:608_192]])


def _flushed(make, data):
    """A stream of two pieces, flushed after each."""
    c = make(mode=1)
    half = len(data) // 2
    return (c.process(data[:half]) + c.flush() + c.process(data[half:])
            + c.flush() + c.finish())


def _sharded(pkg, data):
    return __import__(f"{pkg}.parallel.shard", fromlist=["shard"]) \
        .compress_sharded(data, use_device=False)


def _page(data):
    """`data` with inline base64 images, as long as `data`."""
    from brotli_tpu_torch.tools.corpus import base64_page
    return base64_page(build_corpus(1 << 20), len(data))


def _device_decode(dec, d, **kw):
    return dec(JN.encode(d, 1, 22), dictionary=b"raw", **kw)


# case -> (the port's call, the JAX package's call, its variables, the
# dictionary the output decodes with, or "plain" for a decoded output)
_CONVERTED = {
    "serialized dictionary": (
        lambda d: bt.compress(d, dictionary=_serialized_prefix()),
        lambda d: brotli_tpu.compress(d, dictionary=_serialized_prefix()),
        {}, "serialized"),
    "base64 mode": (
        lambda d: bt.compress(_page(d), quality=5, base64_mode=True,
                              backend="numpy"),
        lambda d: brotli_tpu.compress(_page(d), quality=5,
                                      base64_mode=True),
        {"BROTLI_TPU_BACKEND": "numpy"}, None),
    "dictionary with mode 1": (
        lambda d: bt.compress(d[:_SMALL], mode=1, dictionary=b"abc"),
        lambda d: brotli_tpu.compress(d[:_SMALL], mode=1,
                                      dictionary=b"abc"), {}, b"abc"),
    "encoder python": (
        lambda d: bt.compress(d[:_SMALL], encoder="python"),
        lambda d: brotli_tpu.compress(d[:_SMALL]),
        {"BROTLI_TPU_ENCODER": "python"}, None),
    "encoder device at q5 under 64 KiB": (
        lambda d: bt.compress(d[:-1], quality=5, encoder="device",
                              device="cpu"),
        lambda d: brotli_tpu.compress(d[:-1], quality=5),
        {"BROTLI_TPU_ENCODER": "device"}, None),
    "Compressor mode 1": (
        lambda d: _flushed(bt.Compressor, d[:_SMALL]),
        lambda d: _flushed(brotli_tpu.Compressor, d[:_SMALL]), {}, None),
    "Decompressor serialized": (
        lambda d: bt.Decompressor(_serialized_prefix()).process(
            brotli_tpu.compress(d, dictionary=_serialized_prefix())),
        lambda d: brotli_tpu.Decompressor(_serialized_prefix()).process(
            brotli_tpu.compress(d, dictionary=_serialized_prefix())),
        {}, "plain"),
    "device decoder with a dictionary": (
        lambda d: _device_decode(bt.decompress, d, decoder="device",
                                 device="cpu"),
        lambda d: _device_decode(brotli_tpu.decompress, d),
        {"BROTLI_TPU_DECODER": "device"}, "plain"),
    "compress_sharded use_device=False": (
        lambda d: _sharded("brotli_tpu_torch", d),
        lambda d: _sharded("brotli_tpu", d), {}, None),
}


@pytest.mark.parametrize("case", list(_CONVERTED))
def test_unported_options_raise(case, monkeypatch):
    """What only the JAX package's Python pipeline, Python decoder and
    host matchers served (and raised NotImplementedError here until
    they were ported) gives the JAX package's bytes under its
    variables, and each stream decodes. q11 runs on 16 KiB, where the
    host DP takes it as it does under 256 KiB (tests/test_torch_host_dp
    checks that threshold by a spy)."""
    port, jax, env, dictionary = _CONVERTED[case]
    data = build_corpus(1 << 16)
    for k in list(os.environ):
        if k.startswith("BROTLI_TPU_"):
            monkeypatch.delenv(k)
    got = port(data)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert got == jax(data)
    if dictionary == "plain":
        assert got == data
        return
    if dictionary == "serialized":
        back = bt.decompress(got, dictionary=_serialized_prefix())
        assert back == brotli_tpu.decompress(
            got, dictionary=_serialized_prefix())
    else:
        back = bt.decompress(got, dictionary=dictionary)
        assert JN.decode(got, compound=dictionary or b"") == back
        assert bt.decompress(got, dictionary=dictionary,
                             decoder="python") == back
    assert back in (data, data[:-1], data[:_SMALL], _page(data))


def test_decompress_rejects_garbage():
    with pytest.raises(bt.error):
        bt.decompress(b"\xff\xff\xff\xff not brotli")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers of ops/kernels.py launch or raise: a tensor on the
    CPU is refused there (ops/optimal.py takes the plain version for
    it before reaching them)."""
    pd = torch.zeros((29, 4096), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.suffix_min(pd, pd, torch.zeros(64, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.dp_scan(torch.zeros((4096, 128), dtype=torch.int32),
                        torch.zeros(4096, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.dp_backtrack(torch.zeros((1, 4097), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.chain_select_launch(torch.ones(4096, dtype=torch.int32),
                                    4096, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.dp_scan_v1(pd, pd, torch.zeros(4096, dtype=torch.int32),
                           torch.zeros(64, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.dp_scan_ring(
            torch.zeros((4096, 128), dtype=torch.int32),
            torch.zeros(4096, dtype=torch.int32),
            torch.zeros(4096, dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32), None, 4093)
    data = torch.zeros(4096, dtype=torch.uint8)
    key = torch.zeros(4096, dtype=torch.int64)
    cand = torch.zeros((4096, 27), dtype=torch.int32)
    seeds = [torch.zeros(8, dtype=torch.int64)] * 3
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.edge_keys(data, 4093, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.edge_ranks(key.to(torch.int32), key, data, 4093, 1 << 20,
                           (1, 2), torch.zeros((4096, 16), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.edge_rows(torch.zeros((2, 4096, 16), dtype=torch.int32),
                          [13, 14])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.edge_slots(cand, data, 1 << 20,
                           torch.zeros(64, dtype=torch.int32), *seeds,
                           torch.zeros(1 << 16, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.dict_probe(data, 4096, torch.zeros((2, 0), dtype=torch.int32),
                           0, 1 << 20, torch.zeros(16, dtype=torch.uint8))
    assert kernels.LAUNCHES == {"suffix_min": 0, "dp_scan": 0,
                                "dp_backtrack": 0, "chain_select": 0,
                                "bitpack": 0, "lz_resolve": 0,
                                "dp_scan_v1": 0, "dp_scan_ring": 0,
                                "edge_keys": 0, "edge_ranks": 0,
                                "edge_rows": 0, "edge_slots": 0,
                                "dict_probe": 0}


def test_import_isolation():
    """(h) importing the port, one CPU compress, one CPU
    compress_sharded at q5 with each serializer, one CPU device decode,
    a native compress, a Compressor/Decompressor round trip, the CLI,
    every module of the host matchers, the host DP, base64 mode and the
    serialized dictionaries with a run of each (encoder="python" at q1,
    q5 and q11, base64 mode, a serialized dictionary with custom words,
    Compressor in mode 1, compress_sharded(use_device=False)) and the
    tools leave no JAX and no module of the JAX package behind."""
    code = "\n".join([
        "import sys",
        "import brotli_tpu_torch as bt",
        "from brotli_tpu_torch import cli",
        "from brotli_tpu_torch.ops import matcher as M, optimal as O",
        "from brotli_tpu_torch.parallel.shard import compress_sharded",
        "from brotli_tpu_torch.tools.corpus import build_corpus",
        "O.SEG_V3, O.BUCKETS_V3 = 1 << 16, [1 << 16]",
        "M._BUCKETS, M.SEG_BYTES = [1 << 16, 1 << 17], 1 << 17",
        "data = build_corpus(1 << 20)[50_000:50_000 + (1 << 18)]",
        "out = bt.compress(data, device='cpu')",
        "assert bt.decompress(out) == data",
        "out = compress_sharded(data, quality=5, n_shards=2, device='cpu')",
        "assert bt.decompress(out) == data",
        "out = compress_sharded(data, quality=5, n_shards=2, device='cpu',",
        "                       serializer='device')",
        "assert bt.decompress(out, decoder='device', device='cpu') == data",
        "assert bt.decompress(bt.compress(data, quality=5)) == data",
        "c = bt.Compressor(quality=5)",
        "out = c.process(data[:100_000]) + c.flush() + c.process(data[100_000:])",
        "out += c.finish()",
        "d = bt.Decompressor()",
        "assert d.process(out) == data and d.is_finished()",
        "assert cli.main(['-V']) == 0",
        "from brotli_tpu_torch.enc import (base64_mode, custom_dict,",
        "                                  optimal, static_dict)",
        "from brotli_tpu_torch.format import shared_dictionary",
        "from brotli_tpu_torch.tools import (dictgen, draw_diff,",
        "                                    draw_histogram, optref)",
        "from brotli_tpu_torch.tools.corpus import (base64_page,",
        "                                           custom_dictionary)",
        "small = data[:20_000]",
        "for q in (1, 5, 11):",
        "    out = bt.compress(small, quality=q, encoder='python')",
        "    assert bt.decompress(out) == small",
        "page = base64_page(data, 60_000)",
        "out = bt.compress(page, quality=5, base64_mode=True)",
        "assert bt.decompress(out, decoder='python') == page",
        "blob = custom_dictionary(data[150_000:200_000], 4096, 64)",
        "out = bt.compress(small, quality=5, dictionary=blob)",
        "assert bt.decompress(out, dictionary=blob) == small",
        "c = bt.Compressor(mode=1, quality=5, backend='numpy')",
        "out = c.process(data[:100_000]) + c.flush() + c.finish()",
        "assert bt.Decompressor(decoder='python').process(out) == "
        "data[:100_000]",
        "out = compress_sharded(data, quality=5, use_device=False)",
        "assert bt.decompress(out) == data",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'brotli_tpu')))",
    ])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BROTLI_TPU_")}
    env["OMP_NUM_THREADS"] = "1"  # see one_torch_thread
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
