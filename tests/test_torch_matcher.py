"""The port's device LZ matcher against the JAX package's, bit for bit,
on the CPU.

  (a) the chain walk: `chain_select_plain` against `chain_select_host`,
      `chain_select_xla` and the Pallas kernel itself in interpret mode;
  (b) `match_block`: `count` and the whole `packed` table;
  (c) `find_matches_device` against `find_matches_jax`'s device branch,
      on one segment and, with shrunk buckets, on several segments with
      window history; also the DP's seed route (base != 0, no
      dictionary);
  (d) the host helpers the matcher and the shards use:
      `_extend_capped` and `ring_after`.

The JAX package runs its device branch on the CPU with nothing in it
edited: `backend_or_cpu` is patched to report a GPU and the Pallas
chain walk to its XLA twin (the JAX package's own CPU route), so
`find_matches_jax` goes through `match_block` instead of its NumPy
matcher. Inputs are in-repo only: the port's corpus generator and
numpy-seeded bytes.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.enc import bitstream as JB
from brotli_tpu.enc import matcher as JM
from brotli_tpu.format import constants as C
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.enc import bitstream as PB
from brotli_tpu_torch.enc import matcher as PEM
from brotli_tpu_torch.ops import chain
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
SHRUNK = dict(_BUCKETS=[1 << 16, 1 << 17], SEG_BYTES=1 << 17)


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
    """The JAX package on its device branch, on the CPU; no
    BROTLI_TPU_* variable."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        mp.setattr(jaxcfg, "backend_or_cpu", lambda: "gpu")
        mp.setattr(CP, "chain_select", CP.chain_select_xla)
        yield


@pytest.fixture
def shrunk(device_branch, monkeypatch):
    """64 and 128 KiB buckets in both packages: several segments."""
    for mod in (MJ, PM):
        for k, v in SHRUNK.items():
            monkeypatch.setattr(mod, k, v)


@pytest.fixture(scope="module")
def corpus():
    return np.frombuffer(build_corpus(1 << 20), np.uint8)


def _eq_all(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, (x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------
# (a) the chain walk
# ---------------------------------------------------------------------

def _skips(seed, n):
    return np.random.default_rng(seed).integers(1, 17, n).astype(np.int32)


@pytest.mark.parametrize("start", [0, 1, 16383, 20000])
def test_chain_select_plain_matches_jax(start, monkeypatch):
    n = 2 * CP.SEG
    skip = _skips(start, n)
    got = chain.chain_select_plain(torch.from_numpy(skip), n, start)
    assert got.dtype == torch.int32 and got.shape == (n,)
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(CP.chain_select_xla(jnp.asarray(skip), n, start)))
    monkeypatch.setattr(CP.pl, "pallas_call", functools.partial(
        CP.pl.pallas_call, interpret=True))
    pallas = CP.chain_select.__wrapped__(jnp.asarray(skip), n, start)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    if start == 0:
        np.testing.assert_array_equal(got, CP.chain_select_host(skip))
    assert got.sum() > 1000
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        chain.chain_select(torch.from_numpy(skip), n, start).numpy(), got)


@pytest.mark.parametrize("fill,start", [(1, 0), (16, 5), (16, 1 << 20)])
def test_chain_select_plain_edges(fill, start):
    """All literals mark nothing; all 16 marks every 16th position from
    start; a start past the end marks nothing."""
    n = 1 << 16
    sel = chain.chain_select_plain(torch.full((n,), fill, dtype=torch.int32),
                                   n, start).numpy()
    want = np.zeros(n, np.int32)
    if fill > 1:
        want[start:n:fill] = 1
    np.testing.assert_array_equal(sel, want)


# ---------------------------------------------------------------------
# (b) match_block
# ---------------------------------------------------------------------

@pytest.mark.parametrize("b,ncand,start,off", [
    (1 << 16, 2, 0, 0), (1 << 16, 4, 30_000, 280_000),
    (1 << 20, 2, 1 << 19, 0), (1 << 20, 4, 0, 0)])
def test_match_block_matches_jax(device_branch, corpus, b, ncand, start,
                                 off):
    buf = corpus[off:off + b - 1000]  # a padded tail: the npos clamp
    padded = np.zeros(b, np.uint8)
    padded[:len(buf)] = buf
    npos = len(buf) - 3
    count, packed = MJ.match_block(
        jnp.asarray(padded), jnp.int32(npos), jnp.int32(MAXD),
        num_candidates=ncand, start=jnp.int32(start))
    pc, pp = PM.match_block(torch.from_numpy(padded), npos, MAXD, ncand,
                            start)
    assert int(pc) == int(count) > 1000
    assert pp.shape == (2, b // 4) and pp.dtype == torch.int64
    np.testing.assert_array_equal(pp.numpy(),
                                  np.asarray(packed).astype(np.int64))


def test_match_skip_in_range(corpus):
    """The skip K2 is given lies in [1, 16] (its contract), and is the
    match length exactly where it exceeds 1."""
    b = 1 << 16
    data = torch.from_numpy(corpus[:b].copy())
    best_len, _, skip = PM.match_skip(data, b - 3, MAXD, 4)
    assert int(skip.min()) >= 1 and int(skip.max()) <= PM.CAP
    big = skip > 1
    assert bool((skip[big] == best_len[big]).all()) and int(big.sum()) > 100


# ---------------------------------------------------------------------
# (c) find_matches_device
# ---------------------------------------------------------------------

@pytest.mark.parametrize("quality,segments,base,use_dict", [
    (1, "one", 0, None), (5, "one", 0, None), (9, "several", 0, None),
    (5, "several", 0, None), (5, "several", 150_000, False)])
def test_find_matches_device_matches_jax(device_branch, corpus, quality,
                                         segments, base, use_dict,
                                         request):
    if segments == "several":
        request.getfixturevalue("shrunk")
    arr = corpus[20_000:320_000]
    port = PM.find_matches_device(arr, MAXD, quality, base=base,
                                  use_dict=use_dict, device="cpu")
    runs = []
    orig = MJ._run_segment
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MJ, "_run_segment",
                   lambda *a, **k: runs.append(1) or orig(*a, **k))
        ref = MJ.find_matches_jax(arr, MAXD, quality, base=base,
                                  use_dict=use_dict)
    # the JAX package took its device branch, segment by segment
    assert len(runs) == (1 if segments == "one" else 5)
    _eq_all(port, ref)
    m, lens, dists, flags = port
    assert len(m) > 10_000 and (lens > PM.CAP).any()
    assert ((flags >= 2000).sum() > 0) == (quality >= 5 and
                                           use_dict is None)
    lz = flags == 0
    assert np.all(m[lz] - dists[lz] >= 0) and np.all(np.diff(m) > 0)


def test_find_matches_device_needs_cuda(monkeypatch, corpus):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.find_matches_device(corpus[:1 << 17], MAXD, 5)


# ---------------------------------------------------------------------
# (d) host helpers
# ---------------------------------------------------------------------

def test_extend_capped_matches(corpus):
    """Cap-hit matches of a real parse, extended serially."""
    arr = corpus[:300_000]
    b = 1 << 19
    padded = np.zeros(b, np.uint8)
    padded[:len(arr)] = arr
    count, packed = PM.match_block(torch.from_numpy(padded),
                                   len(arr) - 3, MAXD, 4, 0)
    cnt = int(count)
    m = packed[0, :cnt].numpy()
    lens = packed[1, :cnt].numpy() >> 25
    dists = packed[1, :cnt].numpy() & PM.MASK25
    flags = np.where(np.arange(cnt) % 97 == 0, 2004, 0)  # some words
    args = (arr, m, lens, dists, flags, PM.CAP, 1 << 24)
    port = PEM._extend_capped(*args)
    _eq_all(port, JM._extend_capped(*args))
    assert len(port[0]) < cnt and port[1].max() > 1000
    for a, b_, c in [(0, 5000, 64), (100, 100_000, 1 << 20)]:
        assert PEM._match_len(arr, a, b_, c) == JM._match_len(arr, a, b_, c)


@pytest.mark.parametrize("ring", [None, [17, 4, 11, 16]])
def test_ring_after_matches(ring):
    rng = np.random.default_rng(7)
    dists = rng.integers(0, 40, 500)
    dists[100:110] = 9  # consecutive repeats collapse
    flags = np.where(rng.random(500) < 0.1, 2005, 0)
    for d, f in [(dists, flags), (dists[:0], flags[:0]),
                 (np.array([4, 4, 0]), np.zeros(3, np.int64))]:
        r = None if ring is None else np.array(ring, np.int64)
        np.testing.assert_array_equal(PB.ring_after(d, f, r),
                                      JB.ring_after(d, f, r))
