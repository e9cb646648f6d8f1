"""The port's sharded compression on one device against the JAX
package's, byte for byte, on the CPU.

  (e) `compress_sharded` at q5 with one and two shards: the device
      matcher per shard (base = the shard's offset), metablock splits,
      entry rings across shard seams and native serialization;
  (f) `compress_sharded` at q11 with two shards: the optimal-parse DP
      per shard, whose second shard seeds through the device matcher;
  (g) the device rule, the routing to the mesh and the gather without
      one, and what is not ported yet (serializer="device" is held to
      the JAX package in tests/test_torch_bitpack.py, the mesh in
      tests/test_torch_mesh.py).

The JAX package takes its single-device device branch on the CPU with
nothing in it edited: `backend_or_cpu` reports a GPU, the Pallas chain
walk is its XLA twin, and `jax.devices` lists one device, so
`_find_matches_sharded` runs its shards one after another. Every stream
must also decode through both packages' decoders. Inputs are in-repo
only (the port's corpus generator).
"""

import os

import jax
import numpy as np
import pytest
import torch

import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.format import constants as C
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.parallel import shard as JS
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import build_corpus

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
def one_device():
    """The JAX package's single-device device branch on the CPU, with
    both packages' matcher buckets shrunk to 64/128 KiB (several
    segments per shard) and the DP's segments to 64 KiB; no
    BROTLI_TPU_* variable but BROTLI_TPU_DP=v3, the DP the port has."""
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        mp.setenv("BROTLI_TPU_DP", "v3")
        mp.setattr(jaxcfg, "backend_or_cpu", lambda: "gpu")
        mp.setattr(CP, "chain_select", CP.chain_select_xla)
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        for mod in (MJ, PM):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 17])
            mp.setattr(mod, "SEG_BYTES", 1 << 17)
        mp.setattr(OJ, "SEG_V3", SEG)
        mp.setattr(OJ, "_BUCKETS_V3", [SEG])
        mp.setattr(O, "SEG_V3", SEG)
        mp.setattr(O, "BUCKETS_V3", [SEG])
        yield


@pytest.fixture(scope="module")
def data():
    return build_corpus(1 << 20)[50_000:350_000]


def _decodes(out, data):
    assert JN.decode(out) == data
    assert bt.decompress(out) == data


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_compress_sharded_q5_matches_jax(one_device, data, n_shards):
    out = PS.compress_sharded(data, quality=5, n_shards=n_shards,
                              device="cpu")
    ref = JS.compress_sharded(data, quality=5, n_shards=n_shards)
    assert out == ref
    assert len(out) < len(data) // 3
    _decodes(out, data)


def test_compress_sharded_q5_default_buckets(data):
    """The real 1 MiB bucket, one segment; n_shards=None is one shard
    on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxcfg, "backend_or_cpu", lambda: "gpu")
        mp.setattr(CP, "chain_select", CP.chain_select_xla)
        ref = JS.compress_sharded(data, quality=5, n_shards=1)
    out = PS.compress_sharded(data, device="cpu")
    assert out == ref
    _decodes(out, data)


def test_second_shard_parse_matches_jax(one_device, data):
    """(f) the q11 parse of a shard that does not start the stream: its
    seed comes from the device matcher, not the native one."""
    arr = np.frombuffer(data, np.uint8)
    lo = len(arr) // 2
    shard = arr[lo:]
    seed = O._seed_parse(shard, MAXD, lo, "cpu")
    ref_seed = OJ._seed_parse(shard, MAXD, lo)
    for a, b in zip(seed, ref_seed):
        np.testing.assert_array_equal(a, b)
    port = O.find_matches_optimal(shard, MAXD, base=lo, device="cpu")
    ref = OJ.find_matches_optimal_jax(shard, MAXD, 11, base=lo)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert len(port[0]) > 5000


def test_compress_sharded_q11_matches_jax(one_device, data):
    out = PS.compress_sharded(data, quality=11, n_shards=2, device="cpu")
    ref = JS.compress_sharded(data, quality=11, n_shards=2)
    assert out == ref
    _decodes(out, data)


def test_compress_sharded_needs_cuda(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.compress_sharded(data)


@pytest.mark.parametrize("kwargs", [
    dict(use_device=False), dict(size=100_000, n_shards=2,
                                 use_device=False)])
def test_unported_options_raise(data, kwargs, monkeypatch):
    """use_device=False (which raised until the host matchers were
    ported): the host vectorized matcher per shard, 4 shards by default,
    the JAX package's bytes; no device is resolved, so it runs without
    CUDA."""
    kwargs = dict(kwargs)
    size = kwargs.pop("size", len(data))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    real = PS._find_matches_host
    monkeypatch.setattr(PS, "_find_matches_host",
                        lambda arr, bounds, *a: called.append(len(bounds))
                        or real(arr, bounds, *a))
    out = PS.compress_sharded(data[:size], **kwargs)
    assert out == JS.compress_sharded(data[:size], **kwargs)
    n_shards = kwargs.get("n_shards", 4)
    # under n_shards * 64 KiB, one stream of the one-shot encoder
    assert called == ([n_shards + 1] if size >= n_shards << 16 else [])
    _decodes(out, data[:size])


@pytest.mark.parametrize("kwargs", [dict(), dict(size=0)])
def test_collective_gather_joins(data, kwargs):
    """gather="collective" without a mesh (one device; an empty input)
    joins the shards' bytes, as the JAX package does with fewer devices
    than shards (tests/test_torch_mesh.py holds the mesh's gather)."""
    size = kwargs.pop("size", len(data))
    out = PS.compress_sharded(data[:size], device="cpu", gather="collective")
    assert out == PS.compress_sharded(data[:size], device="cpu")
    assert bt.decompress(out) == data[:size]


def test_mesh_branch_is_taken(monkeypatch, data):
    """More CUDA devices than one and n_shards > 1 is the mesh: the
    shards go to cuda:0 and cuda:1, decided before any device is
    touched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = []
    monkeypatch.setattr(PS, "_compress_sharded",
                        lambda *a, **k: seen.append(a[5]) or b"")
    PS.compress_sharded(data, n_shards=2)
    assert seen == [[torch.device("cuda", 0), torch.device("cuda", 1)]]
