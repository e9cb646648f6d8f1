"""The candidate edges and slot tables of one DP segment (K9 `edge_keys`,
K10 `edge_ranks`, K11 `edge_slots` in brotli_tpu_torch.ops.optimal)
against the JAX package, bit for bit, on the CPU.

  (a) K9 then a stable sort then K10, per level (4, 8 and the 16-byte
      level), against `optimal_jax._level_candidates`: K9's int32 key is
      the JAX key - 2**31 and its stable sort lax.sort's permutation;
  (a2) numpy models of edge_ranks.cu's two launches (the CTA walk over
      tiles of sorted rows with a kmax halo and the windows it stages,
      writing 16-word rows at their positions; the row pass that sets
      the levels' rows side by side) against the plain versions;
  (b) the composed `edge_slots_plain` against `_edges_slots`, against
      the slot rows and literal costs of `_dp_v3_impl` (captured where
      they enter the suffix-min and the scan) through `segment_tables`,
      and against `_edges_kernel` for v1, transposed;
  (c) seeded seeds and dictionary hits: duplicate starts (a max per
      field), overlaps, clamped positions, a dictionary length whose
      << 25 wraps int32, a payload with bit 31 set;
  (d) a numpy model of edge_slots.cu's fill (the scatter's per-tile
      records, the walk back over them, the in-tile scan) against the
      plain fill;
  (e) dispatch: a CPU tensor never reaches a kernel launch, the
      kernels' wrappers refuse CPU tensors, and K9's and K10's refuse
      bytes off the 16-byte grid.

Cases cover full, text-only and tail-padded segments (the cyclic words
that the npos + 3 guard relies on), a (1 << 10) - 16 window, npos of 0,
of n and off the 4,096 grid. The JAX side runs Pallas-free code, jitted
on the CPU (the segment's capture eagerly). Inputs come from the port's
corpus and from numpy seeds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.format import constants as C
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu_torch.ops import kernels
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
SMALL_WINDOW = (1 << 10) - 16
SEG = 1 << 16
B, W = O.B, O.W
LEVEL3 = O.LEVELS + (O.LEVEL3,)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and their OpenMP threads spinning on the same cores slow
    each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def v3():
    """Both packages with no BROTLI_TPU_* variable but BROTLI_TPU_DP=v3,
    and 64 KiB segments."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        mp.setenv("BROTLI_TPU_DP", "v3")
        for mod, names in ((OJ, ("SEG", "_BUCKETS", "SEG_V3", "_BUCKETS_V3")),
                           (O, ("SEG", "BUCKETS", "SEG_V3", "BUCKETS_V3"))):
            mp.setattr(mod, names[0], SEG)
            mp.setattr(mod, names[1], [SEG])
            mp.setattr(mod, names[2], SEG)
            mp.setattr(mod, names[3], [SEG])
        yield


@pytest.fixture(scope="module")
def host(v3):
    """200 KB of the corpus (C source, then dictionary-word text), its
    seed parse, v3 cost tables and dictionary probe."""
    arr = np.frombuffer(build_corpus(1 << 20)[120_000:320_000], np.uint8)
    seed = O._seed_parse(arr, MAXD, 0)
    tables = O._cost_tables(arr, seed, lit_table=True, cfg=O.DPConfig())
    dict_g = O._dict_probe_global(arr, [seed], 0, MAXD)
    assert len(dict_g[0]) > 100
    return arr, seed, tables, dict_g


# the segments: full (C source), text (the dictionary's), tail (3,392
# live bytes, then zeros to the bucket's end)
SEGMENTS = {"full": 0, "text": 2 * SEG, "tail": 3 * SEG}


def _segment(host, lo):
    """The v3 inputs of [lo, lo + SEG) as numpy arrays: data (zero
    padded), npos, the seeds and the dictionary hits (int32)."""
    arr, seed, _, dict_g = host
    hi = min(lo + SEG, len(arr))
    npos, spos, slen, sdist, dloc, dval = O._prep_segment_v3(
        arr, [seed], dict_g[0], dict_g[1], lo, hi, SEG)
    data = np.zeros(SEG, np.uint8)
    data[:hi - lo] = arr[lo:hi]
    return dict(data=data, npos=npos, seeds=(spos, slen, sdist),
                dict=(dloc, dval), lo=lo)


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# (a) K9, the sort, K10 against _level_candidates
# ---------------------------------------------------------------------

def _jax_words_hash(data, plen):
    """The words and the level's hash, as optimal_jax._edges_slots
    builds them for _level_candidates."""
    d32 = jnp.asarray(data).astype(jnp.uint32)
    w0 = d32 | jnp.roll(d32, -1) << 8 | jnp.roll(d32, -2) << 16 | \
        jnp.roll(d32, -3) << 24
    w = [w0] + [jnp.roll(w0, -4 * r) for r in range(1, OJ.CAPD // 4)]
    h = w[0] * OJ.HASH_MUL
    if plen >= 8:
        h = h ^ (w[1] * OJ.HASH_MUL2)
    if plen >= 16:
        h = h ^ (w[2] * jnp.uint32(0x85EBCA77)) ^ \
            (w[3] * jnp.uint32(0xC2B2AE3D))
    return w, h >> jnp.uint32(15)


_level_ref = jax.jit(OJ._level_candidates, static_argnums=(4,))


@jax.jit
def _jax_key_sort(hval, npos):
    """The key and lax.sort of optimal_jax._level_candidates (its lines
    144-148): the uint32 key and the positions in sorted order."""
    pos = jnp.arange(hval.shape[0], dtype=jnp.int32)
    key = jnp.where(pos < npos,
                    (hval << 14) | (pos.astype(jnp.uint32) >> 9),
                    jnp.uint32(1 << 31) | pos.astype(jnp.uint32))
    return key, jax.lax.sort((key, pos.astype(jnp.uint32)), num_keys=1)[1]

NPOS_CASES = {"npos 0": 0, "npos n": SEG, "npos off grid": 12_345}


@pytest.mark.parametrize("plen,ranks", LEVEL3, ids=["4", "8", "16"])
@pytest.mark.parametrize("case", list(SEGMENTS) + ["window"] +
                         list(NPOS_CASES))
def test_level_candidates_match(host, plen, ranks, case):
    seg = _segment(host, SEGMENTS.get(case, SEG))
    data, maxd = seg["data"], MAXD
    if case == "window":
        maxd = SMALL_WINDOW
    npos = NPOS_CASES.get(case, seg["npos"])
    lvl_npos = max(npos - (plen - 4), 0)
    d = torch.from_numpy(data)
    key = O.edge_keys_plain(d, lvl_npos, plen)
    assert key.dtype == torch.int32 and key.shape == (SEG,)
    key_s, order = torch.sort(key, stable=True)
    got = O.edge_ranks_plain(key_s, order, d, lvl_npos, maxd, ranks)
    assert got.dtype == torch.int32 and got.shape == (SEG, len(ranks))
    w, hval = _jax_words_hash(data, plen)
    # the int32 key is the JAX key - 2**31, and its stable sort is
    # lax.sort's permutation, padding rows included
    jkey, pos_u = _jax_key_sort(hval, jnp.int32(lvl_npos))
    _eq(key.numpy().astype(np.int64) + (1 << 31), np.asarray(jkey))
    _eq(order.numpy(), np.asarray(pos_u))
    assert (key < 0).sum() == min(lvl_npos, SEG)
    want = _level_ref(w, jnp.arange(SEG, dtype=jnp.int32),
                      jnp.int32(lvl_npos), jnp.int32(maxd), ranks, hval)
    _eq(got.numpy(), np.stack([np.asarray(x) for x in want], 1)
        .view(np.int32))
    found = int((got >> 25).ge(2).sum())
    if npos == 0:
        assert found == 0
    elif case in ("full", "text", "npos n"):
        assert found > SEG // 4


def test_candidates_wrap_at_the_bucket_end():
    """The words are cyclic: with npos = n, a position near the end
    matches the segment's head through the wrap, and the JAX package's
    lengths run across it."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, SEG).astype(np.uint8)
    data[-8:] = data[:8]  # the head repeats at the end...
    data[100:116] = data[-8:].tolist() + data[:8].tolist()  # ...and here
    d = torch.from_numpy(data)
    ranks = O.LEVELS[0][1]
    key_s, order = torch.sort(O.edge_keys_plain(d, SEG, 4), stable=True)
    got = O.edge_ranks_plain(key_s, order, d, SEG, MAXD, ranks)
    w, hval = _jax_words_hash(data, 4)
    want = _level_ref(w, jnp.arange(SEG, dtype=jnp.int32), jnp.int32(SEG),
                      jnp.int32(MAXD), ranks, hval)
    _eq(got.numpy(), np.stack([np.asarray(x) for x in want], 1)
        .view(np.int32))
    # the match at n - 8 against position 100 runs 16 bytes, 8 past the
    # end; the guard npos + 3 - pos lets 3 of them count
    assert int(got[SEG - 8].max()) >> 25 == 11


# ---------------------------------------------------------------------
# (a2) edge_ranks.cu's two launches, modelled
# ---------------------------------------------------------------------

def _windows(data):
    """The 8 little-endian words of the 32 cyclic bytes at every
    position, uint32 (n, 8)."""
    n = data.shape[0]
    b = data[(np.arange(n)[:, None] + np.arange(32)) % n]
    return np.ascontiguousarray(b).view("<u4")


def _tz_bytes(x):
    return sum(((x & np.uint32((1 << (8 * (b + 1))) - 1)) == 0)
               .astype(np.int64) for b in range(4))


def _ranks_model(key_s, order, data, npos, max_distance, ranks, tile):
    """edge_ranks.cu's level launch in numpy: a CTA of `tile` sorted rows
    [i0, end) counts the rows among the kmax before it that are live and
    share row i0's hash (a suffix of that halo) and stages them with the
    tile; it gathers the window of each staged live row that shares its
    hash with the staged row before or after it (the halo rows all do),
    leaving the others' words random; each row's ranks then come from
    the staged rows alone, written as a whole 16-word row at its
    position, zero past the level's ranks."""
    key = key_s.numpy().astype(np.int64)
    pos = order.numpy()
    n, kmax = len(key), max(ranks)
    h, live = key >> 14, key < 0
    words = _windows(data)
    rng = np.random.default_rng(1)
    out = np.full((n, kernels.MAX_RANKS), -7, np.int32)
    for i0 in range(0, n, tile):
        end = min(i0 + tile, n)
        halo = slice(max(i0 - kmax, 0), i0)
        g0 = i0 - int(np.sum(live[halo] & (h[halo] == h[i0])))
        hs = h[g0:end]
        same_prev = np.r_[False, hs[1:] == hs[:-1]]
        same_next = np.r_[hs[:-1] == hs[1:], False]
        need = live[g0:end] & ((np.arange(g0, end) < i0) | same_prev |
                               same_next)
        win = rng.integers(0, 1 << 32, (end - g0, 8), dtype=np.uint64) \
            .astype(np.uint32)
        win[need] = words[pos[g0:end][need]]
        m = np.arange(i0 - g0, end - g0)
        ti = g0 + m
        guard = np.maximum(npos + 3 - pos[ti], 0)
        row = np.zeros((len(m), kernels.MAX_RANKS), np.int32)
        for r, k in enumerate(ranks):
            mj = np.maximum(m - k, 0)
            dist = pos[ti] - pos[g0 + mj]
            ok = live[ti] & (m - k >= 0) & (h[g0 + mj] == h[ti]) & \
                (dist > 0) & (dist <= max_distance)
            x = win[m] ^ win[mj]
            alive = np.ones(len(m), bool)
            mlen = np.zeros(len(m), np.int64)
            for w in range(8):
                mlen += np.where(alive, _tz_bytes(x[:, w]), 0)
                alive &= x[:, w] == 0
            mlen = np.minimum(mlen, guard)
            row[:, r] = np.where(ok & (mlen >= 2), (mlen << 25) | dist, 0)
        out[pos[ti]] = row
    return out


def _rows_model(words, nranks, rows=128):
    """edge_ranks.cu's row pass in numpy: a CTA of `rows` positions reads
    their 16-word rows of every level into a (rows, ld) tile, each
    level's first nranks[l] words side by side, and stores the tile
    whole."""
    nlevels, n, _ = words.shape
    ld = sum(nranks)
    out = np.full((n, ld), -7, np.int32)
    for p0 in range(0, n, rows):
        p = np.arange(p0, min(p0 + rows, n))
        tile = np.zeros((len(p), ld), np.int32)
        col = 0
        for lvl, nr in enumerate(nranks):
            tile[:, col:col + nr] = words[lvl, p, :nr]
            col += nr
        out[p] = tile
    return out


def _model_case(host, case, plen):
    """(data, npos) for the model: the real segment; all-zero bytes (one
    hash group, so every halo reaches row 0); random bytes whose head
    repeats at the end, npos = n (windows across the wrap)."""
    if case == "real":
        seg = _segment(host, 0)
        data, npos = seg["data"], seg["npos"]
    elif case == "zeros":
        data, npos = np.zeros(SEG, np.uint8), SEG - 3
    else:
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, SEG).astype(np.uint8)
        data[-8:] = data[:8]
        data[100:116] = data[-8:].tolist() + data[:8].tolist()
        data[-40:-8] = data[:32]
        npos = SEG
    return data, max(npos - (plen - 4), 0)


@pytest.mark.parametrize("tile", [64, 100, 1024])
@pytest.mark.parametrize("plen,ranks", LEVEL3, ids=["4", "8", "16"])
@pytest.mark.parametrize("case", ["real", "zeros", "wrap"])
def test_ranks_model_matches_plain(host, case, plen, ranks, tile):
    """The CTA walk of tiles and a kmax halo (the 8-byte level's 512 rows
    span 8 tiles of 64) gives the plain level's words, and the dispatcher
    on the CPU the same 16-word rows, so a fault at a tile's edge shows
    before the card."""
    data, npos = _model_case(host, case, plen)
    d = torch.from_numpy(data)
    key_s, order = torch.sort(O.edge_keys_plain(d, npos, plen), stable=True)
    want = O.edge_ranks_plain(key_s, order, d, npos, MAXD, ranks)
    got = _ranks_model(key_s, order, data, npos, MAXD, ranks, tile)
    _eq(got[:, :len(ranks)], want.numpy())
    assert not got[:, len(ranks):].any()
    rows = torch.full((SEG, kernels.MAX_RANKS), -1, dtype=torch.int32)
    O.edge_ranks(key_s, order, d, npos, MAXD, ranks, rows)
    _eq(rows, got)
    assert (want >> 25).ge(2).any()
    if case == "zeros":  # live sorted row i is position i: all found
        assert bool((want[max(ranks):npos] >> 25).ge(2).all())


@pytest.mark.parametrize("nranks", [(13, 14), (13, 14, 10), (16,)])
def test_rows_model_matches_plain(nranks):
    """The row pass over the levels' 16-word rows, with a part-full last
    CTA, gives edge_rows_plain's table: each level's first nranks words
    side by side, the rest of its row dropped."""
    rng = np.random.default_rng(len(nranks))
    n = 40 * 128 + 77
    words = rng.integers(-(1 << 31), 1 << 31, (len(nranks), n, 16),
                         dtype=np.int64).astype(np.int32)
    want = O.edge_rows_plain(torch.from_numpy(words), list(nranks))
    _eq(_rows_model(words, nranks), want.numpy())
    _eq(want[:, -nranks[-1]:], words[-1, :, :nranks[-1]])
    assert want.shape == (n, sum(nranks))


# ---------------------------------------------------------------------
# (b) the slot tables
# ---------------------------------------------------------------------

class _Captured(Exception):
    pass


def _dp_v3_rows(host, seg, maxd, levels):
    """_dp_v3_impl's slot rows (pd_flat, cs_flat, as they enter the
    suffix-min) and its per-position literal costs (as they enter the
    scan, back in position order), run eagerly with both functions
    patched to record their inputs."""
    _, _, tables, _ = host
    got = {}

    def suffix(pd_flat, cs_flat, copyq_row, interpret):
        got["pd"], got["cs"] = np.asarray(pd_flat), np.asarray(cs_flat)
        return jnp.zeros((2 * W, pd_flat.shape[1]), jnp.int32)

    def scan(mp_all, litq_b, **kw):
        got["litq"] = np.asarray(litq_b).T.reshape(-1)
        raise _Captured

    spos, slen, sdist = seg["seeds"]
    dloc, dval = seg["dict"]
    copyq_row = np.zeros((1, 128), np.int32)
    copyq_row[0, :W] = tables[1][:W]
    dq = np.concatenate([tables[2], tables[4]]).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OJ, "_suffix_pallas", suffix)
        mp.setattr(OJ, "_scan_math_v3", scan)
        mp.setattr(OJ, "LEVELS", levels)
        with pytest.raises(_Captured):
            OJ._dp_v3_impl(
                jnp.asarray(seg["data"]), jnp.int32(seg["npos"]),
                jnp.int32(maxd),
                jnp.asarray(tables[0].astype(np.int32).reshape(-1)),
                jnp.asarray(tables[3].astype(np.int32)),
                jnp.asarray(copyq_row), jnp.asarray(dq), jnp.asarray(spos),
                jnp.asarray(slen), jnp.asarray(sdist), jnp.asarray(dloc),
                jnp.asarray(dval), jnp.int32(seg["lo"]), capm=SEG // 8)
    return got


def _port_rows(host, seg, maxd, levels):
    _, _, tables, _ = host
    bits_tab, ctx_tab, _, distq = O.device_tables(tables[:4], "cpu")
    return O.segment_tables(
        torch.from_numpy(seg["data"]), seg["npos"], maxd, bits_tab, ctx_tab,
        distq, *(_t64(a) for a in seg["seeds"]),
        *(_t64(a) for a in seg["dict"]), seg["lo"], levels)


def _seeded(seg, kind):
    """The segment with seeded seeds (in place of its real ones) or
    seeded dictionary hits (in place of the real hits); the other kind
    stays real."""
    rng = np.random.default_rng(11)
    if kind == "seeds":
        # two seeds at one start: the end of one, the distance of the
        # other; overlaps; a zero length with a live distance; starts
        # below 0 and past n (clamped); random seeds at repeated starts
        k = np.array([[100, 20, 7], [100, 10, 900], [5000, 40, 3],
                      [5010, 60, 11], [7000, 0, 55], [-5, 30, 2],
                      [SEG + 9, 70, 4], [SEG - 2, 5, 6]])
        starts = rng.choice(np.arange(8192, 8192 + 64), 400)
        r = np.stack([starts, rng.integers(0, 90, 400),
                      rng.integers(1, 1 << 20, 400)], 1)
        k = np.concatenate([k, r, np.zeros((100, 3), np.int64)])
        return dict(seg, seeds=tuple(k.T.astype(np.int32)))
    # two hits at one position (the advance of one, the offset of the
    # other); an advance of 100 at a block start (100 << 25 wraps); an
    # advance of 1; one that overruns its block; bit 31 set; positions
    # below 0 and past n; random hits at repeated positions
    adv = lambda a, wl, off: (a << 22) | (wl << 17) | off
    k = [(3 * B, adv(9, 9, 70)), (3 * B, adv(5, 5, 99_000)),
         (5 * B, adv(100, 24, 5)), (5 * B + 7, adv(1, 4, 3)),
         (6 * B - 10, adv(30, 20, 12)), (7 * B, (1 << 31) | adv(9, 9, 1)),
         (-4, adv(8, 8, 2)), (SEG + 100, adv(6, 6, 3))]
    k += [(int(p), adv(int(a), 8, int(o))) for p, a, o in zip(
        rng.choice(np.arange(9 * B, 9 * B + 32), 200),
        rng.integers(0, 64, 200), rng.integers(0, 1 << 17, 200))]
    k = np.array(k + [(0, 0)] * 100, np.int64)
    return dict(seg, dict=(k[:, 0].astype(np.int32),
                           k[:, 1].astype(np.uint32).view(np.int32)))


SLOT_CASES = ["full", "text", "tail", "window", "level3",
              "duplicate seeds", "duplicate dictionary hits"]


@pytest.mark.parametrize("case", SLOT_CASES)
def test_segment_tables_match_dp_v3_impl(host, case):
    seg = _segment(host, SEGMENTS.get(case, 2 * SEG))
    if case.startswith("duplicate"):
        seg = _seeded(seg, case.split()[1])
    maxd = SMALL_WINDOW if case == "window" else MAXD
    levels = LEVEL3 if case == "level3" else O.LEVELS
    pd, cs, litq, dist_fill = _port_rows(host, seg, maxd, levels)
    want = _dp_v3_rows(host, seg, maxd, levels)
    nslots = 39 if case == "level3" else 29
    assert pd.shape == cs.shape == (nslots, SEG)
    assert all(t.dtype == torch.int32 for t in (pd, cs, litq, dist_fill))
    _eq(pd.numpy(), want["pd"])
    _eq(cs.numpy(), want["cs"])
    _eq(litq.numpy(), want["litq"])
    dls = pd[-2] >> 25
    if case == "duplicate dictionary hits":
        assert int(pd[-2, 5 * B]) < 0  # the wrapped length
        assert int(dls[3 * B]) == 9 and int(dls[5 * B + 7]) == 1
        assert int(pd[-2, 3 * B] & O.MASK25) == \
            min(2 * SEG + 3 * B, MAXD) + 1 + 99_000
        assert int(dls[6 * B - 10]) == 0 and int(dls[7 * B]) == 0
    if case == "duplicate seeds":
        assert int(pd[-1, 101] >> 25) == 19
        assert int(pd[-1, 101] & O.MASK25) == 900


_edges_slots_ref = jax.jit(OJ._edges_slots)


@pytest.mark.parametrize("case", ["text", "tail", "duplicate seeds"])
def test_edge_slots_match_edges_slots(host, case):
    """The slot rows of K11's plain version, with the dictionary row
    taken out, against optimal_jax._edges_slots; dist_fill too."""
    seg = _segment(host, SEGMENTS.get(case, 0))
    if case == "duplicate seeds":
        seg = _seeded(seg, "seeds")
    data = seg["data"]
    _, _, tables, _ = host
    bits_tab, ctx_tab, _, distq = O.device_tables(tables[:4], "cpu")
    cand = O._candidates(torch.from_numpy(data), seg["npos"], MAXD)
    pd, cs, _, dist_fill = O.edge_slots_plain(
        cand, torch.from_numpy(data), MAXD, distq,
        *(_t64(a) for a in seg["seeds"]), bits_tab, ctx_tab,
        *(_t64(a) for a in seg["dict"]), seg["lo"])
    keep = [s for s in range(pd.shape[0]) if s != pd.shape[0] - 2]
    ls, rcs, ds, rfill = _edges_slots_ref(
        jnp.asarray(data), jnp.int32(seg["npos"]), jnp.int32(MAXD),
        jnp.asarray(tables[2].astype(np.int32)),
        *(jnp.asarray(a) for a in seg["seeds"]))
    ls, ds = np.asarray(ls), np.asarray(ds)
    _eq(pd[keep].numpy(), (ls << 25) | np.where(ls >= 2, ds, 0))
    _eq(cs[keep].numpy(), rcs)
    _eq(dist_fill.numpy(), rfill)


def _v1_inputs(host, seg, maxd):
    arr, seed, _, _ = host
    lit, copyq, distq = O._cost_tables(arr, seed, lit_table=False,
                                       cfg=O.DPConfig(mode="v1"))
    spos, slen, sdist = seg["seeds"]
    port = (torch.from_numpy(seg["data"]), seg["npos"], maxd,
            torch.from_numpy(lit.reshape(-1)), torch.from_numpy(distq),
            _t64(spos), _t64(slen), _t64(sdist))
    ref = (jnp.asarray(seg["data"]), jnp.int32(seg["npos"]),
           jnp.int32(maxd), jnp.asarray(lit), jnp.asarray(copyq),
           jnp.asarray(distq), jnp.asarray(spos), jnp.asarray(slen),
           jnp.asarray(sdist))
    return port, ref


@pytest.mark.parametrize("case", ["full", "tail", "window",
                                  "duplicate seeds"])
def test_edges_v1_match_edges_kernel(host, case):
    """v1's layout: no dictionary slot, litq without the * 2; the JAX
    package's (B, nslots, nb) transposed back."""
    seg = _segment(host, SEGMENTS.get(case, SEG))
    if case == "duplicate seeds":
        seg = _seeded(seg, "seeds")
    maxd = SMALL_WINDOW if case == "window" else MAXD
    port, ref = _v1_inputs(host, seg, maxd)
    pd, cs, litq = O.edges_v1(*port)
    rpd, rcs, rlq = OJ._edges_kernel(*ref)
    nb = SEG // B
    assert pd.shape == (28, SEG)
    _eq(pd.numpy().reshape(28, nb, B).transpose(2, 0, 1), rpd)
    _eq(cs.numpy().reshape(28, nb, B).transpose(2, 0, 1), rcs)
    _eq(litq.numpy().reshape(nb, B).T, rlq)


def test_edge_slots_on_random_candidates():
    """K11's arithmetic on candidates no K10 gives: negative words,
    lengths past W - 1, distances in every bit of the 25, against the
    plain composition of _slot_rows; v3 and v1."""
    rng = np.random.default_rng(3)
    n, ncand = 2 * B, 27
    cand = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n, ncand))
                            .astype(np.int32))
    data = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    distq = torch.from_numpy(rng.integers(0, 300, 64).astype(np.int32))
    seeds = [_t64(a) for a in (rng.integers(0, n, 50),
                               rng.integers(0, 80, 50),
                               rng.integers(0, 1 << 22, 50))]
    bits = torch.from_numpy(rng.integers(0, 256, 64 * 256).astype(np.int32))
    ctx = torch.from_numpy(rng.integers(0, 64, 256 * 256).astype(np.int32))
    lit1 = torch.from_numpy(rng.integers(0, 400, 256 * 256)
                            .astype(np.int32))
    dpos, dpay = _t64(rng.integers(0, n, 40)), _t64(rng.integers(
        0, 1 << 31, 40))
    ls, cs, ds, fill = O._slot_rows(cand, distq, *seeds)
    pd = (ls << 25) | torch.where(ls >= 2, ds, 0)
    for ctx_tab in (ctx, None):
        v3 = ctx_tab is not None
        got = O.edge_slots_plain(cand, data, MAXD, distq, *seeds,
                                 bits if v3 else lit1, ctx_tab,
                                 dpos if v3 else None, dpay if v3 else None,
                                 12_345)
        keep = [s for s in range(ncand + 2) if s != ncand] if v3 else \
            list(range(ncand + 1))
        _eq(got[0][keep], pd)
        _eq(got[1][keep], cs)
        _eq(got[3], fill.to(torch.int32))
        assert got[0].shape[0] == ncand + (2 if v3 else 1)
    assert (ls[:ncand] < 0).any() and (ls[:ncand] >= 2).any()


# ---------------------------------------------------------------------
# (d) edge_slots.cu's fill, modelled
# ---------------------------------------------------------------------

def _fill_model(seed_pos, seed_len, seed_dist, n, tile=kernels.EDGE_TILE,
                threads=256):
    """edge_slots.cu's continuation fill in numpy: the scatter's max per
    field into zeroed rows and each tile's last start with a positive
    value; per tile, the last positive start before it from the first
    window of 32 earlier records (walking back) that holds one; then
    rows of `threads` positions, a running max of positive starts."""
    ntiles = -(-n // tile)
    out = []
    for vals in (np.where(seed_len > 0, seed_pos + seed_len, 0),
                 np.where(seed_len > 0, seed_dist, 0)):
        row = np.zeros(n, np.int64)
        rec = np.full(ntiles, -1, np.int64)
        sp = np.clip(seed_pos, 0, n - 1)
        for p, v in zip(sp, vals):
            if v > 0:
                row[p] = max(row[p], v)
                rec[p // tile] = max(rec[p // tile], p)
        fill = np.zeros(n, np.int64)
        for t in range(ntiles):
            carry = -1
            u0 = t - 1
            while u0 >= 0 and carry < 0:
                carry = rec[max(u0 - 31, 0):u0 + 1].max()
                u0 -= 32
            for c in range(0, tile, threads):
                lo = t * tile + c
                if lo >= n:
                    break
                idx = np.arange(lo, min(lo + threads, n))
                src = np.maximum.accumulate(
                    np.where(row[idx] > 0, idx, -1))
                src = np.maximum(src, carry)
                carry = src[-1]
                fill[idx] = np.where(src >= 0, row[np.maximum(src, 0)], 0)
        out.append(fill)
    return out


@pytest.mark.parametrize("kind", ["dense", "sparse", "head only", "none",
                                  "duplicates"])
def test_fill_model_matches_plain(kind):
    """The per-tile records and the walk back give _fill_last_positive's
    rows, also when the last positive start lies more than 32 tiles
    back, or nowhere."""
    rng = np.random.default_rng(7)
    n = 200 * B + 1000  # a part-full last tile
    k = {"dense": 20_000, "sparse": 30, "head only": 3, "none": 0,
         "duplicates": 5_000}[kind]
    pos = rng.integers(-10, n + 10, k)
    if kind == "head only":
        pos = np.array([5, 900, 4000])
    if kind == "duplicates":
        pos = rng.choice(np.arange(0, n, 97), k)
    length = rng.integers(0, 60, k)
    dist = rng.integers(0, 1 << 20, k)
    want_e, want_d = _fill_model(pos, length, dist, n)
    t = [_t64(a) for a in (pos, length, dist)]
    zero = torch.zeros(n, dtype=torch.int64)
    sp = torch.clamp(t[0], 0, n - 1)
    ends = zero.scatter_reduce(0, sp, torch.where(t[1] > 0, t[0] + t[1], 0),
                               "amax", include_self=True)
    sdist = zero.scatter_reduce(0, sp, torch.where(t[1] > 0, t[2], 0),
                                "amax", include_self=True)
    _eq(O._fill_last_positive(ends).numpy(), want_e)
    _eq(O._fill_last_positive(sdist).numpy(), want_d)


# ---------------------------------------------------------------------
# (e) dispatch
# ---------------------------------------------------------------------

def test_cpu_tensors_never_launch(host, monkeypatch):
    """On CPU tensors the dispatchers take the plain versions: a spy on
    kernels._launch is never called, and the results are the plain
    versions'; the kernels' wrappers refuse a CPU tensor."""
    calls = []
    monkeypatch.setattr(kernels, "_launch",
                        lambda *a, **k: calls.append(a[0]))
    seg = _segment(host, 2 * SEG)
    d = torch.from_numpy(seg["data"])
    key = O.edge_keys(d, seg["npos"], 8)
    _eq(key, O.edge_keys_plain(d, seg["npos"], 8))
    key_s, order = torch.sort(key, stable=True)
    ranks = O.LEVELS[1][1]
    words = torch.full((2, SEG, kernels.MAX_RANKS), -1, dtype=torch.int32)
    O.edge_ranks(key_s, order, d, seg["npos"], MAXD, ranks, words[1])
    _eq(words[1, :, :len(ranks)],
        O.edge_ranks_plain(key_s, order, d, seg["npos"], MAXD, ranks))
    assert not words[1, :, len(ranks):].any() and (words[0] == -1).all()
    table = O.edge_rows(words, [3, len(ranks)])
    _eq(table, O.edge_rows_plain(words, [3, len(ranks)]))
    _eq(table[:, 3:], words[1, :, :len(ranks)])
    rows = _port_rows(host, seg, MAXD, O.LEVELS)
    port, _ = _v1_inputs(host, seg, MAXD)
    O.edges_v1(*port)
    assert calls == []
    assert rows[0].shape == (29, SEG)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kernels.edge_keys(d, seg["npos"], 8)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kernels.edge_ranks(key_s, order, d, seg["npos"], MAXD, ranks,
                           words[1])
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kernels.edge_rows(words, [3, len(ranks)])
    cand = O._candidates(d, seg["npos"], MAXD)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        kernels.edge_slots(cand, d, MAXD, *port[4:], port[3])
    assert calls == []


@pytest.mark.parametrize("case", ["aligned", "offset", "short"])
def test_edge_wrappers_refuse_bytes_off_the_grid(case, monkeypatch):
    """K9 and K10 read the bytes as whole aligned 16-byte chunks, so
    their wrappers launch only for bytes that are 16-byte aligned and a
    multiple of 16 long (a DP segment is a bucket slice, so always), and
    raise before any launch otherwise. The device test of `_check` is
    stubbed so the CPU tensors reach the wrappers' own checks."""
    calls = []
    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_launch", lambda *a: calls.append(a[1]))
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES,
                                                           0))
    buf = torch.zeros(4096 + 64, dtype=torch.uint8)
    lo = -buf.data_ptr() % 16 + (case == "offset")
    n = 4096 - 8 if case == "short" else 4096
    data = buf[lo:lo + n]
    assert (data.data_ptr() % 16 == 0) == (case != "offset")
    key_s = torch.zeros(n, dtype=torch.int32)
    order = torch.arange(n, dtype=torch.int64)
    words = torch.zeros((n, kernels.MAX_RANKS), dtype=torch.int32)
    assert words.data_ptr() % 16 == 0
    if case == "aligned":
        assert kernels.edge_keys(data, n - 3, 8).shape == (n,)
        kernels.edge_ranks(key_s, order, data, n - 3, MAXD, (1, 2), words)
        assert calls == ["btt_edge_keys", "btt_edge_ranks"]
        assert kernels.LAUNCHES["edge_keys"] == 1
        return
    with pytest.raises(ValueError, match="edge_keys"):
        kernels.edge_keys(data, n - 3, 8)
    with pytest.raises(ValueError, match="edge_ranks"):
        kernels.edge_ranks(key_s, order, data, n - 3, MAXD, (1, 2), words)
    assert calls == [] and not any(kernels.LAUNCHES.values())
