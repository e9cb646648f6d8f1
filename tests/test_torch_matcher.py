"""The port's device LZ matcher against the JAX package's, bit for bit,
on the CPU.

  (a) the chain walk: `chain_select_plain` against `chain_select_host`,
      `chain_select_xla` and the Pallas kernel itself in interpret mode;
      a numpy model of K2's design (csrc/chain_select.cu) against both;
      the error flag for skips outside [1, 16];
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
    sel, err = chain.chain_select(torch.from_numpy(skip), n, start)
    np.testing.assert_array_equal(sel.numpy(), got)
    assert err.tolist() == [0]


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


# K2's design (csrc/chain_select.cu) as a numpy model: sub-chunk walks
# from the 16 entry offsets, nibble-packed maps, and a decoupled
# look-back with chunks interleaved in a seeded random order

_AGG, _INCL, _NOTV = 1, 2, 3  # descriptor kinds, as in the kernel
_NIBBLES = 0x1111111111111111


def _nib(m, x):
    return (m >> 4 * x) & 15


def _pack(f):
    return sum(int(x) << 4 * i for i, x in enumerate(f))


def _compose(g, f):
    """The packed map g o f."""
    return _pack([_nib(g, _nib(f, i)) for i in range(16)])


def _k2_walks(sk, lo, p, S):
    """Walk every walker i from position p[i] to the end of its
    sub-chunk [lo[i], lo[i] + S), all at once. Returns the exit offsets
    into the next sub-chunk and the visit masks, (walkers, S // 8) bytes
    (the kernel's 32-bit words, little-endian): bit (p - lo) & 7 of byte
    (p - lo) >> 3 set where the walk visits p."""
    p = p.copy()
    seen = np.zeros((len(p), S), bool)
    live = np.nonzero(p < lo + S)[0]
    while len(live):
        seen[live, p[live] - lo[live]] = True
        p[live] += sk[p[live]]
        live = live[p[live] < lo[live] + S]
    return p - lo - S, np.packbits(seen, axis=1, bitorder="little")


def _k2_model(skip, start, L, S, window=32, seed=0):
    """-> (sel, err, look-back rounds per chunk) of the kernel's design
    with chunks of L positions, sub-chunks of S and look-back rounds of
    `window` predecessors."""
    n = len(skip)
    nch, nsub = n // L, L // S
    out = (skip < 1) | (skip > 16)
    sk = np.where(out, 1, skip).astype(np.int64)
    sc = start // L
    c, s, o = np.meshgrid(np.arange(nch), np.arange(nsub), np.arange(16),
                          indexing="ij")
    lo = (c * L + s * S).ravel()
    p = lo + o.ravel()
    if sc < nch:
        # in the chunk that holds start, walker (s0, 0) walks from start
        s0 = (start - sc * L) // S
        p[(sc * nsub + s0) * 16] = start
    exits, masks = _k2_walks(sk, lo, p, S)
    ex = exits.reshape(nch, nsub, 16)
    masks = masks.reshape(nch, nsub, 16, -1)

    def chain_from(cc, x, first=0):
        for s_ in range(first, nsub):
            x = ex[cc, s_, x]
        return int(x)

    maps = [_pack([chain_from(cc, o_) for o_ in range(16)])
            for cc in range(nch)]
    kind = np.zeros(nch, np.int64)  # a descriptor's word 0, its kind
    agg, entry, rounds = [0] * nch, {}, {}

    def chunk(cc):  # one CTA; each yield lets the others run
        if cc < sc:
            kind[cc] = _NOTV
            return
        if cc == sc:
            kind[cc] = _INCL | chain_from(cc, int(ex[cc, s0, 0]), s0 + 1) << 8
            return
        agg[cc], kind[cc] = maps[cc], _AGG
        yield
        acc, hi, rounds[cc] = list(range(16)), cc - 1, 0
        while True:
            qs = [q for q in range(hi, hi - window, -1) if q >= sc]
            while (kind[qs] == 0).any():
                yield  # spin
            rounds[cc] += 1
            incl = [j for j, q in enumerate(qs) if kind[q] & 3 == _INCL]
            ms = [agg[q] if kind[q] & 3 == _AGG
                  else (int(kind[q]) >> 8) * _NIBBLES for q in qs]
            t = list(range(16))
            for j in range(incl[0] if incl else len(qs) - 1, -1, -1):
                t = [_nib(ms[j], x) for x in t]
            acc = [acc[x] for x in t]
            if incl:
                assert len(set(acc)) == 1  # a constant map: the entry
                break
            hi -= window
            yield
        entry[cc] = acc[0]
        kind[cc] = _INCL | _nib(maps[cc], acc[0]) << 8

    # tickets: the visited chunks first, in order, then the others
    live = [chunk(cc) for cc in [*range(sc, nch), *range(min(sc, nch))]]
    rng = np.random.default_rng(seed)
    while live:
        k = int(rng.integers(len(live)))
        try:
            next(live[k])
        except StopIteration:
            live.pop(k)
    assert all(kind[:min(sc, nch)] == _NOTV)

    seen = np.zeros(n, np.int32)
    for cc in range(sc, nch):
        x, first = entry.get(cc, 0), 0
        if cc == sc:
            first = s0
        for s_ in range(first, nsub):
            a = cc * L + s_ * S
            seen[a:a + S] = np.unpackbits(masks[cc, s_, x],
                                          bitorder="little")[:S]
            x = ex[cc, s_, x]
        assert kind[cc] == _INCL | int(x) << 8
    return seen * (sk > 1), int(out.any()), rounds


K2_N = 2 * CP.SEG
# 0; a chunk boundary; a sub-chunk's last offset (at both sizes below);
# the last position; past the end
K2_STARTS = [0, 3 * 4096, 2 * 4096 + 5 * 256 + 255, K2_N - 1, K2_N]


def _k2_skips(fill):
    if fill == "uniform":
        return _skips(11, K2_N)
    if fill == "alternating":
        return np.where(np.arange(K2_N) % 2 == 0, 16, 1).astype(np.int32)
    return np.full(K2_N, int(fill), np.int32)


@functools.lru_cache(maxsize=None)
def _k2_reference(fill, start):
    """The plain walk, held against the Pallas kernel in interpret
    mode."""
    skip = _k2_skips(fill)
    plain = chain.chain_select_plain(torch.from_numpy(skip), K2_N,
                                     start).numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CP.pl, "pallas_call", functools.partial(
            CP.pl.pallas_call, interpret=True))
        pallas = CP.chain_select.__wrapped__(jnp.asarray(skip), K2_N, start)
    np.testing.assert_array_equal(plain, np.asarray(pallas))
    return skip, plain


@pytest.mark.parametrize("L,S", [(4096, 256), (256, 16)])
@pytest.mark.parametrize("start", K2_STARTS)
@pytest.mark.parametrize("fill", ["1", "16", "uniform", "alternating"])
def test_chain_select_model_matches(fill, start, L, S):
    """The design of csrc/chain_select.cu, at its real chunk (L = 4096,
    sub-chunks of 256) and shrunk (L = 256, sub-chunks of 16), with
    look-back rounds of 32 predecessors (the kernel's warp) and of one,
    gives the plain walk's and the Pallas kernel's sel bit for bit."""
    skip, want = _k2_reference(fill, start)
    for window in (32, 1):
        sel, err, rounds = _k2_model(skip, start, L, S, window, seed=start)
        np.testing.assert_array_equal(sel, want)
        assert err == 0
        if window == 1 and len(rounds) > 16:
            # some chunk composed aggregates before an inclusive one
            assert max(rounds.values()) > 1
    # the packed maps compose associatively
    rng = np.random.default_rng(start)
    f, g, h = (_pack(rng.integers(0, 16, 16)) for _ in range(3))
    assert _compose(h, _compose(g, f)) == _compose(_compose(h, g), f)
    assert _compose(f, 3 * _NIBBLES) == _nib(f, 3) * _NIBBLES


def test_chain_select_flags_bad_skips():
    """A skip of 0 or 17 sets the error flag, on the CPU as in the
    model (which walks it as 1, as the kernel does)."""
    skip = _skips(5, 4096 * 4)
    for bad in (0, 17):
        skip2 = skip.copy()
        skip2[5000] = bad
        sel, err = chain.chain_select(torch.from_numpy(skip2), len(skip2))
        assert err.dtype == torch.int32 and err.tolist() == [1]
        msel, merr, _ = _k2_model(skip2, 0, 4096, 256)
        assert merr == 1
        if bad == 0:  # both walk it as 1
            np.testing.assert_array_equal(msel, sel.numpy())


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
    pc, pp, perr = PM.match_block(torch.from_numpy(padded), npos, MAXD,
                                  ncand, start)
    assert int(pc) == int(count) > 1000 and int(perr) == 0
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


def test_find_matches_device_raises_on_bad_skip(monkeypatch, corpus):
    """K2's error flag is read with the segment's count, at the
    collect: one skip of 0 from match_skip raises there."""
    orig = PM.match_skip
    collected = []

    def bad_skip(*a, **k):
        best_len, best_dist, skip = orig(*a, **k)
        skip = skip.clone()
        skip[1000] = 0
        return best_len, best_dist, skip

    def collect(handles):
        collected.append(1)
        return orig_collect(handles)

    orig_collect = PM._collect_segment
    monkeypatch.setattr(PM, "match_skip", bad_skip)
    monkeypatch.setattr(PM, "_collect_segment", collect)
    with pytest.raises(ValueError, match=r"outside \[1, 16\]"):
        PM.find_matches_device(corpus[:1 << 16], MAXD, 5, device="cpu")
    assert collected == [1]


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
    count, packed, _ = PM.match_block(torch.from_numpy(padded),
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


# The q5 cell's traffic parameters (benchmark/traffic/logs16m.json as of
# the cell's first release), pinned here so that a later change to the
# traffic file leaves this input as it is.
_LOGS16M = dict(
    site_seed=0, host="www.example.com", size_mu=9.357, size_sigma=1.318,
    tail_k=133000, tail_alpha=1.1, file_zipf=1.0, embedded_k=1.0,
    embedded_alpha=2.43, active_shape=1.46, active_scale=0.382,
    inactive_k=1.0, inactive_alpha=1.5, addresses=20000, client_zipf=1.2,
    status_shares=[0.88, 0.08, 0.02, 0.015, 0.005], pages=500,
    objects=1500, agents=400, pages_per_session=5, session_rate=2.0,
    external_shares=[0.4, 0.3, 0.05, 0.05, 0.05, 0.05, 0.04, 0.03, 0.03],
    method_shares=[0.97, 0.02, 0.01], protocol_shares=[0.6, 0.38, 0.02],
    user_share=0.02)


@pytest.fixture(scope="module")
def access_log_parse():
    """The port's device parse (`match_block`, on the CPU) of 1 MiB of
    access-log lines from the q5 cell's generator
    (`benchmark/gen/access_log.py`, seed 7, at `_LOGS16M`), before
    cap-hit extension: (data, pos, len, dist, flag) with every flag 0.
    The generator's code is the benchmark's; its parameters are pinned
    above."""
    from benchmark import core
    gen = core.load_module("gen", "access_log")
    data = np.frombuffer(gen.document(1 << 20, 7, **_LOGS16M), np.uint8)
    padded = np.zeros(PM._bucket(len(data)), np.uint8)
    padded[:len(data)] = data
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        count, packed, _ = PM.match_block(
            torch.from_numpy(padded), len(data) - 3, MAXD, 4, 0)
    finally:
        torch.set_num_threads(n)
    cnt = int(count)
    pay = packed[1, :cnt].numpy()
    return (data, packed[0, :cnt].numpy().astype(np.int64),
            (pay >> 25).astype(np.int64),
            (pay & PM.MASK25).astype(np.int64), np.zeros(cnt, np.int64))


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _extend_case(name, request):
    """(data, pos, len, dist, flag, max_match) of one case of
    `test_extend_capped_is_the_reference_loop`."""
    def arrays(*cols):
        return tuple(np.array(c, np.int64) for c in zip(*cols))

    if name == "access_log":
        data, m, lens, dists, flags = request.getfixturevalue(
            "access_log_parse")
        return data, m, lens, dists, flags, 1 << 24
    if name in ("run_d1", "int32"):
        # a 5,000-byte run of one byte, copied at distance 1
        data = np.concatenate([_rand(1000, 1), np.full(5000, 7, np.uint8),
                               _rand(1000, 2)])
        cols = arrays((500, 6, 100, 0), (1001, 16, 1, 0), (1100, 16, 1, 0),
                      (2000, 8, 50, 0), (5990, 5, 1, 0), (6010, 16, 300, 0),
                      (6500, 4, 9, 0))
        if name == "int32":
            cols = tuple(c.astype(np.int32) for c in cols)
        return (data, *cols, 1 << 24)
    if name == "run_over_1mib":
        # past the reference's largest stride of 1 MiB
        data = np.concatenate([_rand(100, 3),
                               np.zeros((1 << 20) + 300_000, np.uint8),
                               _rand(100, 4)])
        n = len(data)
        return (data, *arrays((101, 16, 1, 0), (5000, 16, 1, 0),
                              (600_000, 10, 7, 0), (1_200_000, 16, 1, 0),
                              (n - 50, 16, 1000, 0)), 1 << 24)
    x = _rand(3000, 5)
    data = np.concatenate([x, x])
    if name == "max_match_below_cap":
        # room = 8 - 16 < 0: the reference's length is cap + room
        return (data, *arrays((2000, 16, 2000, 0), (2004, 16, 2000, 0),
                              (2010, 16, 2000, 0), (2020, 5, 2000, 0),
                              (2030, 17, 2000, 0)), 8)
    if name == "ends_at_last_byte":
        return (data, *arrays((1000, 6, 500, 0), (3000, 16, 3000, 0),
                              (3500, 16, 3000, 0), (5990, 6, 7, 0)),
                1 << 24)
    if name == "zero_room_at_end":
        return (data, *arrays((1000, 6, 500, 0), (3000, 16, 2999, 0),
                              (5984, 16, 3000, 0)), 1 << 24)
    if name == "dict_at_cap":
        return (data, *arrays((100, 20, 9000, 2010), (500, 16, 9000, 2016),
                              (3000, 16, 3000, 0), (3100, 18, 9000, 2018),
                              (5000, 5, 40, 0)), 1 << 24)
    if name == "no_caphit":
        return (data, *arrays((100, 20, 9000, 2010), (3000, 15, 3000, 0),
                              (4000, 4, 3000, 0)), 1 << 24)
    assert name == "empty"
    z = np.zeros(0, np.int64)
    return data, z, z, z, z, 1 << 24


@pytest.mark.parametrize("name", [
    "access_log", "run_d1", "run_over_1mib", "max_match_below_cap",
    "ends_at_last_byte", "zero_room_at_end", "dict_at_cap", "no_caphit",
    "empty", "int32"])
def test_extend_capped_is_the_reference_loop(name, request):
    """The port's native cap-hit extension gives the JAX package's
    Python loop's four arrays, dtypes included; with no cap hit or no
    match it hands back the arrays it was given."""
    data, *cols, max_match = _extend_case(name, request)
    m, lens, _, flags = cols
    args = (data, *cols, PM.CAP, max_match)
    port = PEM._extend_capped(*args)
    ref = JM._extend_capped(*args)
    _eq_all(port, ref)
    assert [a.dtype for a in port] == [a.dtype for a in ref]
    caphits = np.count_nonzero((lens >= PM.CAP) & (flags == 0))
    if caphits == 0:
        assert all(a is b for a, b in zip(port, cols))
    else:
        assert all(a.dtype == np.int64 for a in port)
    if name == "access_log":  # the mechanism at the q5 cell's rate
        assert caphits / (len(data) / (1 << 20)) >= 40_000


@pytest.mark.parametrize("d", [1000 + PM.CAP + 1, 1 << 22])
def test_extend_capped_refuses_source_before_data(d):
    """A cap hit at p whose distance passes p + cap would compare bytes
    before the buffer. The reference loop reads them through numpy's
    negative indices; no valid parse has one, and the port refuses it.
    A distance of p + cap still compares from the first byte."""
    data = _rand(4000, 6)
    m, lens, flags = (np.array([v], np.int64) for v in (1000, PM.CAP, 0))
    with pytest.raises(ValueError, match="outside"):
        PEM._extend_capped(data, m, lens, np.array([d], np.int64), flags,
                           PM.CAP, 1 << 24)
    edge = np.array([1000 + PM.CAP], np.int64)
    assert PEM._extend_capped(data, m, lens, edge, flags, PM.CAP,
                              1 << 24)[1][0] >= PM.CAP


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
