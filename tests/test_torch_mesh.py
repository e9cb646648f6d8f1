"""The port's mesh (several devices, one shard each) against the JAX
package's shard_map mesh, byte for byte, on the CPU.

The port runs its mesh functions on a device list that names the CPU
once per shard; the JAX package runs its own on the 8-device virtual
CPU mesh of tests/conftest.py, whose `jax.devices()` list satisfies its
mesh condition. Both packages' matcher buckets shrink to 64/128 KiB and
their DP segments to 64 KiB; the JAX package's device branch of the
matcher (the seeds of the q11 shards that do not start the stream) runs
through `backend_or_cpu` reporting a GPU and the Pallas chain walk's
XLA twin, nothing in it edited. Cases:

  (a) the q5 mesh's matches for 2, 4 and 8 shards, with matches whose
      source lies before their shard's start (the halo's purpose);
  (b) compress_sharded streams on the mesh at q5, and at q11 with the
      default DP, ring_scan=True, and DPConfig(mode="v1") held against
      the JAX package's BROTLI_TPU_DP=v1: the mesh runs v3 in both;
  (c) serializer="device" on the mesh; gather="collective";
  (d) the routing: the mesh exactly where the JAX package takes it.

Every stream decodes through the port's native decoder.
"""

import os

import jax
import numpy as np
import pytest
import torch

from brotli_tpu.format import constants as C
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.parallel import device_serialize as JD
from brotli_tpu.parallel import shard as JS
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch import native
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel import device_serialize as PD
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
SEG = 1 << 16
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_shard.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """Both packages with no BROTLI_TPU_* variable, the JAX package's
    matcher on its device branch, and the buckets shrunk; the JAX
    package keeps its eight devices."""
    assert len(jax.devices()) == 8
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
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


@pytest.fixture(scope="module")
def corpus():
    return build_corpus(1 << 20)


def _data(corpus, n_shards):
    """80,000 bytes a shard: over the 64 KiB minimum, inside the 128
    KiB bucket with a halo of 48 KiB."""
    return corpus[50_000:50_000 + 80_000 * n_shards]


def _bounds(n, n_shards):
    return np.linspace(0, n, n_shards + 1).astype(np.int64)


def _eq_all(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mesh_matches_match_jax(mesh, corpus, n_shards):
    data = _data(corpus, n_shards)
    arr = np.frombuffer(data, np.uint8)
    bounds = _bounds(len(arr), n_shards)
    port = PS._find_matches_mesh(arr, bounds, MAXD, 5, [CPU] * n_shards)
    ref = JS._find_matches_mesh(arr, bounds, MAXD, 5)
    assert len(port) == len(ref) == n_shards
    for p, r in zip(port, ref):
        _eq_all(p, r)
    # the halo's purpose: matches whose source lies before their shard
    seam = sum(int(((m < d) & (f < 2)).sum()) for m, _, d, f in port[1:])
    assert seam > 0


def test_mesh_shard_too_large_raises(mesh, corpus):
    """A shard over the largest bucket raises in both packages."""
    arr = np.frombuffer(corpus[:300_000], np.uint8)
    bounds = _bounds(len(arr), 2)
    with pytest.raises(ValueError, match="too large"):
        PS._find_matches_mesh(arr, bounds, MAXD, 5, [CPU] * 2)
    with pytest.raises(ValueError, match="too large"):
        JS._find_matches_mesh(arr, bounds, MAXD, 5)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_compress_sharded_q5_mesh_matches_jax(mesh, corpus, n_shards):
    data = _data(corpus, n_shards)
    out = PS._compress_sharded(data, 5, 22, n_shards, CPU, [CPU] * n_shards)
    ref = JS.compress_sharded(data, quality=5, n_shards=n_shards)
    assert out == ref
    assert native.decode(out) == data
    # the halos pay: the one-device route, each shard from its own first
    # byte, is larger
    single = PS.compress_sharded(data, quality=5, n_shards=n_shards,
                                 device="cpu")
    assert len(out) < len(single)


_Q11 = {
    "default": ({}, O.DPConfig()),
    "ring_scan": ({"BROTLI_TPU_RING_SCAN": "1"}, O.DPConfig(ring_scan=True)),
    "v1": ({"BROTLI_TPU_DP": "v1"}, O.DPConfig(mode="v1")),
}


@pytest.mark.parametrize("name", list(_Q11))
def test_compress_sharded_q11_mesh_matches_jax(mesh, corpus, name):
    """Two 64 KiB shards: the first one DP segment, the second (with its
    64 KiB halo) two, so the JAX mesh runs a zero segment for the first
    in round 2 and the port runs none: the bytes are the same. The
    JAX package reads its variables while tracing: every jit cache is
    cleared inside their scope."""
    env, cfg = _Q11[name]
    data = corpus[200_000:200_000 + 2 * SEG]
    out = PS._compress_sharded(data, 11, 22, 2, CPU, [CPU] * 2, dp=cfg)
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        for k, v in env.items():
            mp.setenv(k, v)
        try:
            ref = JS.compress_sharded(data, quality=11, n_shards=2)
        finally:
            jax.clear_caches()
    assert out == ref
    assert native.decode(out) == data


def test_optimal_sharded_ignores_mode_and_iterations(mesh, monkeypatch,
                                                     corpus):
    """mode, iterations and fast_first do not reach the mesh's DP: with
    the DP per segment stubbed (a count of calls and their config), v1,
    two iterations and no fast first run the same v3 segments as the
    default."""
    calls = []

    def stub(data, npos, *args, capm, cfg, icell_q):
        calls.append((int(npos), cfg.ring_scan, cfg.levels))
        z = torch.zeros((2, capm + 8), dtype=torch.int64)
        return z, z
    monkeypatch.setattr(O, "dp_v3_segment", stub)
    arr = np.frombuffer(corpus[200_000:200_000 + 2 * SEG], np.uint8)
    bounds = _bounds(len(arr), 2)
    runs = []
    for cfg in (None, O.DPConfig(mode="v1"),
                O.DPConfig(iterations=2, fast_first=False)):
        calls.clear()
        out = O.find_matches_optimal_sharded(arr, bounds, MAXD, [CPU] * 2,
                                             dp=cfg)
        runs.append((list(calls), [tuple(map(len, s)) for s in out]))
    assert runs[0] == runs[1] == runs[2]
    # two rounds of two shards; the first shard holds one segment, so
    # the second round runs the second shard's alone (no zero segment)
    assert [c[0] for c in runs[0][0]] == [SEG - 3, SEG - 3, SEG - 3]


def test_device_serializer_on_mesh_matches_jax(mesh, corpus):
    data = _data(corpus, 4)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JD, PD):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 19])
        before = PD.HOST_SHARDS
        out = PS._compress_sharded(data, 5, 22, 4, CPU, [CPU] * 4,
                                   serializer="device")
        ref = JS.compress_sharded(data, quality=5, n_shards=4,
                                  serializer="device")
    assert out == ref
    assert PD.HOST_SHARDS == before
    assert native.decode(out) == data


def test_collective_gather_matches_jax(mesh, corpus):
    """gather="collective": the JAX package all-gathers over its eight
    devices; the port's list names one device, so it joins, and its
    copy path (every row onto the first device) gives the join as well."""
    data = _data(corpus, 8)
    out = PS._compress_sharded(data, 5, 22, 8, CPU, [CPU] * 8,
                               gather="collective")
    ref = JS.compress_sharded(data, quality=5, n_shards=8,
                              gather="collective")
    assert out == ref == PS._compress_sharded(data, 5, 22, 8, CPU, [CPU] * 8)
    assert native.decode(out) == data
    parts = [data[k * 1000:k * 1000 + 100 + 37 * k] for k in range(8)]
    assert PS._all_gather_join(parts, [CPU] * 8) == b"".join(parts)
    # without a mesh the public route joins as well
    assert PS.compress_sharded(data, quality=5, n_shards=2, device="cpu",
                               gather="collective") == \
        PS.compress_sharded(data, quality=5, n_shards=2, device="cpu")


@pytest.mark.parametrize("device,count,n_shards,mesh_size", [
    ("cuda", 8, 8, 8), ("cuda", 8, 4, 4), ("cuda", 2, 4, None),
    ("cuda", 1, 1, None), ("cuda", 4, 1, None), ("cpu", 8, 8, None)])
def test_mesh_routing(monkeypatch, device, count, n_shards, mesh_size):
    """The JAX package's condition: CUDA, and at least n_shards > 1
    cards visible, one shard on each of the first n_shards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    got = PS._mesh_devices(torch.device(device), n_shards)
    if mesh_size is None:
        assert got is None
    else:
        assert got == [torch.device("cuda", i) for i in range(mesh_size)]


@pytest.mark.parametrize("quality", [5, 11])
def test_compress_sharded_takes_the_mesh(monkeypatch, corpus, quality):
    """With two cards visible and n_shards=None, compress_sharded routes
    two shards to cuda:0 and cuda:1 (stopped before any device work),
    where it used to raise NotImplementedError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = {}

    def stop(raw, q, lgwin, n_shards, device, mesh, **kw):
        seen.update(q=q, n_shards=n_shards, mesh=mesh, kw=kw)
        return b"stopped"
    monkeypatch.setattr(PS, "_compress_sharded", stop)
    data = _data(corpus, 2)
    assert PS.compress_sharded(data, quality=quality,
                               gather="collective") == b"stopped"
    assert seen["q"] == quality and seen["n_shards"] == 2
    assert seen["mesh"] == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert seen["kw"]["gather"] == "collective"
