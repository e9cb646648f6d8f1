"""The port's host DP (enc/optimal.py, the blocked NumPy optimal parse)
and the quality dispatch of enc/encoder.find_matches, against the JAX
package on the CPU.

  (a) `candidates_topk`, `cache_probes`, `_ring_history`,
      `_dist_sym_extra`, `CostModel`, `_blocked_dp` and `_backtrack`,
      array for array;
  (b) `find_matches_optimal` on 16, 40 and 64 KiB (the host DP takes
      seconds a call in each package, so the sizes stay small);
  (c) the dispatch of `find_matches` (which finder runs, for each
      quality, size, backend and window) against the JAX package's
      under BROTLI_TPU_BACKEND, by spies on both packages' finders, so
      the thresholds (1 KiB, 64 KiB, 256 KiB, 8 MiB) are checked
      without running a finder at those sizes;
  (d) `compress(encoder="python", backend="numpy")` on the host DP at
      q10, and what backend="auto" and "numpy" change in `encode`.

Every array and every byte must be the JAX package's exactly. The JAX
package's device branch is reported by patching `backend_or_cpu`, as in
tests/test_torch_serializer.py. Inputs are in-repo only.
"""

import numpy as np
import pytest
import torch

import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import encoder as JE
from brotli_tpu.enc import matcher as JM
from brotli_tpu.enc import optimal as JO
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.enc import matcher as PM
from brotli_tpu_torch.enc import optimal as PO
from brotli_tpu_torch.format import constants as C
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
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


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


SLICES = {"source": slice(20_000, 60_000), "text": slice(600_000, 640_000),
          "tail": slice(-40_000, None)}


def _arr(name, size=None):
    a = np.frombuffer(CORPUS[SLICES[name]], np.uint8)
    return a if size is None else a[:size]


# -- (a) the DP's parts ----------------------------------------------------

@pytest.mark.parametrize("name", list(SLICES))
def test_candidates_and_cache_probes(name):
    arr = _arr(name, 20_000)
    for nc in (8, 32):
        _same(PO.candidates_topk(arr, MAXD, nc),
              JO.candidates_topk(arr, MAXD, nc))
    seed = JM.find_matches_vectorized(arr, MAXD, num_candidates=4,
                                      use_dict=True)
    ring = PO._ring_history(seed[0], seed[2], seed[3], len(arr))
    np.testing.assert_array_equal(
        ring, JO._ring_history(seed[0], seed[2], seed[3], len(arr)))
    cache = np.concatenate([ring, np.where(ring[:1] > 0, ring[:1] + 1, 0)])
    np.testing.assert_array_equal(PO.cache_probes(arr, cache),
                                  JO.cache_probes(arr, cache))
    d = np.maximum(seed[2], 1)
    _same(PO._dist_sym_extra(d), JO._dist_sym_extra(d))


@pytest.mark.parametrize("name", list(SLICES))
@pytest.mark.parametrize("mode", [None, 3])
def test_cost_model(name, mode):
    arr = _arr(name, 20_000)
    seed = JM.find_matches_vectorized(arr, MAXD, num_candidates=4,
                                      use_dict=True)
    got = PO.CostModel(arr, *seed, context_mode=mode)
    want = JO.CostModel(arr, *seed, context_mode=mode)
    for k in ("litq", "cc_bits", "cq", "copyq", "dist_sym_bits"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    d = np.arange(1, 5000, 7)
    np.testing.assert_array_equal(got.dist_cost_q(d), want.dist_cost_q(d))
    ln = np.arange(0, 300)
    np.testing.assert_array_equal(got.copy_cost_q(ln), want.copy_cost_q(ln))


def test_blocked_dp_and_backtrack():
    """Seeded edges over two and a half blocks: every slot kind (short,
    long, atomic with its own copy code, empty), then the backtrack."""
    rng = np.random.default_rng(4)
    n = 2 * PO.B + PO.B // 2
    nb = (n + PO.B - 1) // PO.B
    nslots = 6
    edge_len = np.zeros((nslots, nb * PO.B), np.int32)
    edge_len[:, :n] = rng.integers(0, 40, (nslots, n))
    edge_len[1, :n] = np.where(rng.random(n) < 0.02,
                               rng.integers(100, PO.MAX_EDGE, n), 0)
    edge_len[5] = 0
    edge_cost = rng.integers(16, 400, edge_len.shape).astype(np.int32)
    edge_ccode = rng.integers(0, 24, edge_len.shape).astype(np.uint8)
    atomic = np.zeros(nslots, bool)
    atomic[3] = True
    litq = rng.integers(20, 160, n).astype(np.int64)
    cq = rng.integers(30, 200, 24).astype(np.int64)
    got = PO._blocked_dp(n, litq, edge_len, edge_cost, atomic, edge_ccode,
                         cq)
    want = JO._blocked_dp(n, litq, edge_len, edge_cost, atomic, edge_ccode,
                          cq)
    np.testing.assert_array_equal(got, want)
    path = PO._backtrack(got, n)
    _same(path, JO._backtrack(want, n))
    assert len(path[0]) > 20


# -- (b) the whole host DP ----------------------------------------------------

@pytest.mark.parametrize("case", [
    ("text", 16 << 10, 0), ("source", 40_000, 123_456),
    ("mixed", 64 << 10, 0)], ids=["16k", "40k-base", "64k-mixed"])
def test_find_matches_optimal(case):
    name, size, base = case
    if name == "mixed":  # C source, dictionary text and random bytes
        arr = np.concatenate([_arr("source", 24_000), _arr("text", 24_000),
                              _arr("tail", size - 48_000)])
    else:
        arr = _arr(name, size)
    got = PO.find_matches_optimal(arr, MAXD, base=base)
    _same(got, JO.find_matches_optimal(arr, MAXD, base=base))
    assert (got[3] >= 2000).any() and (got[3] == 0).any()


# -- (c) the dispatch of find_matches ---------------------------------------

_PORT_FINDERS = {
    "device DP": (PE, "find_matches_optimal"),
    "host DP": (PO, "find_matches_optimal"),
    "cost model": (PM, "find_matches_costmodel"),
    "device matcher": (PE, "find_matches_device"),
    "vectorized": (PM, "find_matches_vectorized"),
    "greedy": (PM, "find_matches_greedy"),
}
_JAX_FINDERS = {
    "device DP": (OJ, "find_matches_optimal_jax"),
    "host DP": (JO, "find_matches_optimal"),
    "cost model": (JM, "find_matches_costmodel"),
    "device matcher": (MJ, "find_matches_jax"),
    "vectorized": (JM, "find_matches_vectorized"),
    "greedy": (JM, "find_matches_greedy"),
}


def _spy(mp, finders, dict_pass):
    called = []
    z = np.zeros(0, np.int64)
    for name, (mod, attr) in finders.items():
        def stub(*a, _name=name, **k):
            called.append((_name, a[2:], k))
            return (z, z, z) if _name == "greedy" else (z, z, z, z)
        mp.setattr(mod, attr, stub)
    mp.setattr(dict_pass[0], dict_pass[1],
               lambda *a, **k: called.append(("dictionary pass", (), {}))
               or (z, z, z, z))
    return called


_SIZES = [16, 1023, 1 << 10, (1 << 16) - 1, 1 << 16, (1 << 18) - 1,
          1 << 18, 8 << 20, (8 << 20) + 1]


@pytest.mark.parametrize("backend", ["auto", "numpy"])
@pytest.mark.parametrize("quality", [1, 5, 9, 10, 11])
def test_find_matches_dispatch(monkeypatch, quality, backend):
    """Which finder runs (and with which arguments), for every size on
    both sides of each threshold, in the port and in the JAX package on
    its device branch with BROTLI_TPU_BACKEND set."""
    monkeypatch.setattr(jaxcfg, "backend_or_cpu", lambda: "gpu")
    monkeypatch.setenv("BROTLI_TPU_BACKEND", backend)
    big = np.zeros((8 << 20) + 1, np.uint8)
    port = _spy(monkeypatch, _PORT_FINDERS, (PM, "add_dictionary_matches"))
    jax = _spy(monkeypatch, _JAX_FINDERS, (JM, "add_dictionary_matches"))
    for n in _SIZES:
        for large in (False, True):
            del port[:], jax[:]
            PE.find_matches(big[:n], MAXD, quality, large=large,
                            backend=backend, device="cpu")
            JE.find_matches(big[:n], MAXD, quality, large=large)
            names = [c[0] for c in port]
            assert names == [c[0] for c in jax], (n, large)
            # the host finders get the JAX package's arguments
            if names[0] not in ("device DP", "device matcher"):
                assert port[0][1:] == jax[0][1:], (n, large)
    if backend == "numpy":
        assert all(c[0] not in ("device DP", "device matcher")
                   for c in port)


# -- (d) the host DP through encode --------------------------------------

def test_encoder_python_q10_numpy(monkeypatch):
    """q10 under backend="numpy": the host DP with q10's candidate count,
    then the Python serializer, against the JAX package under
    BROTLI_TPU_ENCODER=python and BROTLI_TPU_BACKEND=numpy."""
    data = CORPUS[SLICES["text"]][:24_000]
    monkeypatch.setenv("BROTLI_TPU_ENCODER", "python")
    monkeypatch.setenv("BROTLI_TPU_BACKEND", "numpy")
    out = bt.compress(data, quality=10, encoder="python", backend="numpy")
    assert out == JE.encode(data, quality=10)
    assert JN.decode(out) == data
    assert bt.decompress(out) == data
    assert bt.decompress(out, decoder="python") == data


def test_backend_numpy_takes_no_device(monkeypatch):
    """backend="numpy" never resolves a device: without CUDA it runs
    where backend="auto" raises (the card's q11 route, the device
    matcher of the Python pipeline)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = CORPUS[:1 << 18]
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.compress(data, quality=11)
    with pytest.raises(RuntimeError, match="CUDA"):
        bt.compress(data[:1 << 16], quality=5, encoder="python")
    monkeypatch.setenv("BROTLI_TPU_BACKEND", "numpy")
    out = bt.compress(data, quality=11, backend="numpy")
    assert out == JE.encode(data, quality=11)  # both native
    out = bt.compress(data[:1 << 16], quality=5, encoder="python",
                      backend="numpy")
    monkeypatch.setenv("BROTLI_TPU_ENCODER", "python")
    assert out == JE.encode(data[:1 << 16], quality=5)
    assert bt.decompress(out) == data[:1 << 16]


def test_unknown_backend_and_encoder_raise():
    with pytest.raises(bt.error, match="backend"):
        bt.compress(b"abc", backend="jax")
    with pytest.raises(bt.error, match="encoder"):
        bt.compress(b"abc", encoder="host")
    with pytest.raises(ValueError, match="backend"):
        bt.Compressor(backend="gpu")
