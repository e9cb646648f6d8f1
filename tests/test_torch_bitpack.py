"""The port's device serializer against the JAX package's, bit for bit,
on the CPU.

  (a) `plan` against `bitpack.plan_kernel` on seeded command lists
      (every short distance code, dictionary words, legacy cut flags,
      entry rings) and on the real matches of a 64 KiB metablock; every
      slot an active field writes is unique;
  (b) `pack_plain` against `pack_kernel` on seeded fields of every
      marker kind, on the real plan and trees of that metablock, and on
      fields that overflow the words;
  (c) `serialize_shard_device` against the JAX one with 64 KiB
      metablocks (`mb_bits=16`, buckets of 64 and 256 KiB in both
      packages): several metablocks with the ring crossing them, a
      first and a last shard, and the cases the device path does not
      take (a custom-word flag, too many commands, a distance of 2**25,
      a payload that overflows), None in both and counted;
  (d) `compress_sharded(serializer="device")` at q5 with one and two
      shards and at q11 with two, against the JAX package's, with the
      fixtures of tests/test_torch_shard.py; every stream decodes
      through both packages' native decoders.

The JAX side runs its own jitted functions on the CPU; tolerance 0
everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu import native as JN
from brotli_tpu.enc import bitstream as JBS
from brotli_tpu.ops import bitpack as JB
from brotli_tpu.parallel import device_serialize as JD
from brotli_tpu.parallel import shard as JS
from brotli_tpu_torch.ops import bitpack as PB
from brotli_tpu_torch.ops import kernels
from brotli_tpu_torch.parallel import device_serialize as PD
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import build_corpus
from test_torch_shard import _decodes, data, one_device  # noqa: F401

MB = 1 << 16
MAXD = (1 << 22) - 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_shard.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def block():
    """A 64 KiB metablock of the corpus and its real matches: the
    native q5 parse plus the dictionary post-pass's words (flags
    2000 + length)."""
    raw = build_corpus(1 << 20)[50_000:50_000 + MB]
    pos, ln, dist = (a.astype(np.int64) for a in JN.find_matches(raw, 5, 22))
    dp, dl, dd, df = JN.dict_post(raw, pos, ln, MAXD)
    m = np.concatenate([pos, dp])
    order = np.argsort(m, kind="stable")
    matches = tuple(np.concatenate(a)[order] for a in (
        (pos, dp), (ln, dl), (dist, dd), (np.zeros_like(pos), df)))
    assert (matches[3] >= 2000).sum() > 10
    return raw, matches


def _seeded_commands(seed, n=MB, ncmd=2000):
    """Sorted, non-overlapping commands over n bytes whose distances hit
    every distance code: the ring top (reuse), the other ring slots,
    top and second +-1..3, and new ones, plus dictionary words (flag
    2000 + length) and legacy cut flags (2 + cut)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(0, 12, ncmd)
    lens = rng.integers(2, 20, ncmd)
    m = np.cumsum(gaps + lens) - lens
    keep = m + lens <= n - 5
    m, lens = m[keep], lens[keep]
    k = len(m)
    dists, flags, recent = np.zeros(k, np.int64), np.zeros(k, np.int64), []
    for i in range(k):
        pick = rng.integers(0, 8)
        if pick < 5 and recent:
            base = recent[-1 - min(int(rng.integers(0, 4)), len(recent) - 1)]
            d = base + int(rng.integers(-3, 4)) if pick >= 3 else base
        else:
            d = int(rng.integers(1, 1 << 22))
        dists[i] = max(d, 1)
        kind = rng.integers(0, 10)
        if kind == 0:
            flags[i] = 2000 + int(rng.integers(4, 25))
            dists[i] = MAXD + 1 + int(rng.integers(0, 1 << 20))
        elif kind == 1:
            flags[i] = 2 + int(rng.integers(0, 3))
        else:
            recent.append(int(dists[i]))
    return m, lens, dists, flags


def _padded(matches, ncap):
    out = []
    for a in matches:
        p = np.zeros(ncap, np.int32)
        p[:len(a)] = a
        out.append(p)
    return out


def _plan_both(raw, matches, ring, b):
    """plan on the port and plan_kernel on the JAX side, for the
    metablock raw (padded to bucket b)."""
    ncap = b // 4 + 8
    cmds = _padded(matches, ncap)
    data = np.zeros(b, np.uint8)
    data[:len(raw)] = np.frombuffer(raw, np.uint8)
    ring = np.asarray(ring, np.int32)
    k = len(matches[0])
    ref = JB.plan_kernel(jnp.asarray(data), *map(jnp.asarray, cmds),
                         jnp.int32(k), jnp.asarray(ring),
                         jnp.int32(len(raw)), cap_words=b // 2 + 64)
    got = PB.plan(torch.from_numpy(data), *map(torch.from_numpy, cmds), k,
                  torch.from_numpy(ring), len(raw))
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def _written_slots(matches, mlen):
    """Every slot index an active lane of the plan writes: the 5 slots
    of each command (its distance pair counted whether or not it has
    one) and each literal's slot, from the command list alone."""
    m, lens = (np.asarray(a, np.int64) for a in matches[:2])
    k = len(m)
    prev_end = np.concatenate([[0], (m + lens)[:-1]])
    ins = m - prev_end
    last_end = int((m + lens).max()) if k else 0
    tail = mlen - last_end
    if tail > 0:
        ins = np.concatenate([ins, [tail]])
    rec = 5 * np.arange(len(ins)) + np.cumsum(ins) - ins
    cmd_slots = np.concatenate([rec, rec + 1, rec + 2])
    dist_slots = np.concatenate([rec[:k] + 3 + ins[:k],
                                 rec[:k] + 4 + ins[:k]])
    covered = np.zeros(mlen + 1, np.int64)
    np.add.at(covered, m, 1)
    np.add.at(covered, m + lens, -1)
    lit_pos = np.flatnonzero(np.cumsum(covered[:mlen]) == 0)
    cmd_of_lit = np.searchsorted(m, lit_pos, side="right")
    lit_slots = 5 * cmd_of_lit + 3 + np.arange(len(lit_pos))
    return np.concatenate([cmd_slots, dist_slots, lit_slots])


RINGS = {"initial": [4, 11, 15, 16], "custom": [1000, 7, 300, 2]}


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plan_seeded_matches_jax(seed, ring):
    raw = np.random.default_rng(seed).integers(0, 256, MB,
                                               dtype=np.uint8).tobytes()
    matches = _seeded_commands(seed)
    got, ref = _plan_both(raw, matches, RINGS[ring], MB)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    slots = _written_slots(matches, MB)
    assert len(np.unique(slots)) == len(slots)
    assert slots.max() < len(got[0]) - 1  # below the sacrificial slot
    assert (got[1] == -1).sum() > len(matches[0])  # tree symbols written


@pytest.mark.parametrize("mlen", [MB, MB - 777])
def test_plan_real_matches_jax(block, mlen):
    """The real matches of a 64 KiB metablock, and of a shorter one (a
    tail insert after the last match; the bucket padded)."""
    raw, matches = block
    keep = matches[0] + matches[1] <= mlen
    sub = tuple(a[keep] for a in matches)
    got, ref = _plan_both(raw[:mlen], sub, RINGS["initial"], MB)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    slots = _written_slots(sub, mlen)
    assert len(np.unique(slots)) == len(slots)
    assert got[2].sum() == (got[1] == -2).sum()  # literals histogrammed


def _tables(rng):
    out = []
    for size in (256, 704, 64):
        out += [rng.integers(0, 1 << 15, size).astype(np.int32),
                rng.integers(0, 16, size).astype(np.int32)]
    return out


def _pack_both(vals, markers, tables, bit0, cap_words):
    ref_w, ref_t = JB.pack_kernel(
        jnp.asarray(vals), jnp.asarray(markers),
        *map(jnp.asarray, tables), jnp.uint32(bit0), cap_words=cap_words)
    got_w, got_t = PB.pack_plain(
        torch.from_numpy(vals), torch.from_numpy(markers),
        *map(torch.from_numpy, tables), bit0, cap_words)
    np.testing.assert_array_equal(got_w.numpy().view(np.uint32),
                                  np.asarray(ref_w))
    assert int(got_t) == int(ref_t)
    return int(got_t)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_pack_plain_seeded_matches_jax(seed):
    """Every marker kind, raw fields of 0..24 bits with any 32-bit
    value, bit0 0..7."""
    rng = np.random.default_rng(seed)
    n = 50_000
    kind = rng.integers(0, 4, n)
    vals = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    markers = rng.integers(0, 25, n).astype(np.int32)
    markers[kind == 1] = -2
    vals[kind == 1] = rng.integers(0, 256, (kind == 1).sum())
    markers[kind >= 2] = -1
    vals[kind == 2] = rng.integers(0, 704, (kind == 2).sum())
    vals[kind == 3] = 4096 + rng.integers(0, 64, (kind == 3).sum())
    total = _pack_both(vals, markers, _tables(rng), seed % 8, n // 2 + 64)
    assert total < 32 * (n // 2 + 64)


def test_pack_plain_overflow_matches_jax():
    """Fields past the words' end add into the last word, as the JAX
    code's clip does; the total still counts every bit."""
    rng = np.random.default_rng(5)
    n = 4096
    vals = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    markers = np.full(n, 24, np.int32)
    total = _pack_both(vals, markers, _tables(rng), 3, 512)
    assert total == 3 + 24 * n > 32 * 512


def test_pack_plain_real_plan_matches_jax(block):
    """The plan of a real metablock, its trees built as the serializer
    builds them."""
    raw, matches = block
    got, _ = _plan_both(raw, matches, RINGS["initial"], MB)
    vals, markers, h_lit, h_cmd, h_dist = got[:5]
    tables = []
    for h in (h_lit, h_cmd, h_dist):  # the distance alphabet is 64 here
        _, le, c = PD._tables(h.astype(np.int64), len(h))
        tables += [c, le]
    for bit0 in (0, 5):
        total = _pack_both(vals, markers, tables, bit0, MB // 2 + 64)
        assert 8 * 10_000 < total < 8 * MB


def test_bitpack_wrapper_needs_cuda():
    """kernels.bitpack launches K6 or raises: a CPU tensor is refused;
    pack takes the plain version for it."""
    z = torch.zeros(8, dtype=torch.int32)
    tables = [torch.zeros(s, dtype=torch.int32)
              for s in (256, 256, 704, 704, 64, 64)]
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.bitpack(z, z, tables, 0, 64)
    words, total = PB.pack(z, z, *tables, 3, 64)
    assert int(total) == 3 and not words.any()


@pytest.fixture
def mb16():
    """64 KiB metablocks in 64 and 256 KiB buckets, in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JD, PD):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 18])
        yield


def _serialize_both(arr, lo, hi, matches, ring, write_header, is_last):
    ref = JD.serialize_shard_device(arr, lo, hi, matches, ring, 22,
                                    write_header, is_last, mb_bits=16)
    before = PD.HOST_SHARDS
    out = PD.serialize_shard_device(arr, lo, hi, matches, ring, 22,
                                    write_header, is_last, mb_bits=16,
                                    device="cpu")
    assert out == ref
    assert PD.HOST_SHARDS - before == (out is None)
    return out


@pytest.fixture(scope="module")
def shard_input(data):
    """300 KB of the corpus and its native q5 matches with dictionary
    words, split at 64 KiB metablocks (absolute positions)."""
    arr = np.frombuffer(data, np.uint8)
    pos, ln, dist = (a.astype(np.int64)
                     for a in JN.find_matches(data, 5, 22))
    dp, dl, dd, df = JN.dict_post(data, pos, ln, MAXD)
    m = np.concatenate([pos, dp])
    order = np.argsort(m, kind="stable")
    cols = tuple(np.concatenate(a)[order] for a in (
        (pos, dp), (ln, dl), (dist, dd), (np.zeros_like(pos), df)))
    from brotli_tpu.enc import matcher as JM
    bounds = list(range(MB, len(arr), MB)) + [len(arr)]
    return arr, JM.split_matches_at(*cols, bounds)


def test_serialize_whole_shard_matches_jax(mb16, shard_input):
    """One shard of five metablocks: the header, the FLUSH stitches and
    the ring carried across metablocks; the stream decodes."""
    arr, matches = shard_input
    out = _serialize_both(arr, 0, len(arr), matches, None, True, True)
    assert out is not None
    assert JN.decode(out) == arr.tobytes()


def test_serialize_first_and_last_shard_matches_jax(mb16, shard_input):
    """A first shard (header, no ISLAST) and a last one entered with the
    first's exit ring; concatenated they decode."""
    arr, (m, lens, dists, flags) = shard_input
    cut = 3 * MB + 1234
    first = m + lens <= cut
    head = tuple(a[first] for a in (m, lens, dists, flags))
    tail = tuple(a[m >= cut] for a in (m, lens, dists, flags))
    ring = JBS.ring_after(head[2], head[3])
    a = _serialize_both(arr, 0, cut, head, None, True, False)
    b = _serialize_both(arr, cut, len(arr), tail, ring, False, True)
    assert a is not None and b is not None
    assert JN.decode(a + b) == arr.tobytes()


def _one_block(n_cmd, dist, flag, lens=2, step=4):
    """n_cmd commands of `lens` bytes every `step` bytes in one 64 KiB
    metablock."""
    m = np.arange(n_cmd, dtype=np.int64) * step + (step - lens)
    full = np.full(n_cmd, 1, np.int64)
    return m, full * lens, full * dist, full * flag


@pytest.mark.parametrize("case", ["custom word", "too many commands",
                                  "distance 2**25", "payload overflow"])
def test_serialize_cases_left_to_host(mb16, case):
    """What the device path does not take: None in both packages, and
    counted in HOST_SHARDS."""
    arr = np.random.default_rng(9).integers(0, 256, MB, dtype=np.uint8)
    if case == "custom word":
        matches = _one_block(100, 5, 1000 + 6)
    elif case == "too many commands":
        matches = _one_block(MB // 2, 1, 0, step=2)
    elif case == "distance 2**25":
        matches = _one_block(100, 1 << 25, 0)
    else:
        # a dictionary word's copy code comes from its flag: 24 extra
        # bits of copy length and 23 of distance for every 1-byte
        # advance, three random literals between them
        matches = _one_block(MB // 4, (1 << 24) + 12345,
                             2000 + (1 << 24) + 5, lens=1)
    assert _serialize_both(arr, 0, MB, matches, None, True, True) is None


@pytest.mark.parametrize("quality,n_shards", [(5, 1), (5, 2), (11, 2)])
def test_compress_sharded_device_serializer_matches_jax(one_device, data,
                                                        quality, n_shards):
    """serializer="device" end to end, the buckets cut to 64 and 512
    KiB in both packages (one 300 KB shard fits)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JD, PD):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 19])
        before = PD.HOST_SHARDS
        out = PS.compress_sharded(data, quality=quality, n_shards=n_shards,
                                  serializer="device", device="cpu")
        ref = JS.compress_sharded(data, quality=quality, n_shards=n_shards,
                                  serializer="device")
    assert out == ref
    assert PD.HOST_SHARDS == before
    native = PS.compress_sharded(data, quality=quality, n_shards=n_shards,
                                 device="cpu")
    assert len(native) < len(out) < 1.08 * len(native)
    _decodes(out, data)


# ---------------------------------------------------------------------
# a numpy model of K6's design (csrc/bitpack.cu) at a shrunk tile
# ---------------------------------------------------------------------

LO32, BIG = (1 << 32) - 1, 1 << 32


def _combine(a, b):
    """Two bit counts as (sum mod 2**32) | BIG once either reached
    2**32: what a descriptor carries."""
    s = (a & LO32) + (b & LO32)
    return (s & LO32) | ((a | b | s) & BIG)


def _resolve_fields(vals, markers, tables):
    """(code, nb) as uint64 lanes holding uint32 values."""
    lit_code, lit_len, cmd_code, cmd_len, dist_code, dist_len = (
        np.asarray(t, np.int64) for t in tables)
    v = np.asarray(vals, np.int64)
    m = np.asarray(markers, np.int64)
    dsym = (m == -1) & (v >= 4096)
    csym = (m == -1) & ~dsym
    lit = m == -2
    w = np.where(dsym, v - 4096, v)
    lv, cv, dv = np.clip(w, 0, 255), np.clip(w, 0, 703), np.clip(w, 0, 63)
    code = np.select([lit, csym, dsym], [lit_code[lv], cmd_code[cv],
                                         dist_code[dv]], w)
    nb = np.select([lit, csym, dsym], [lit_len[lv], cmd_len[cv],
                                       dist_len[dv]], np.maximum(m, 0))
    return (code & LO32).astype(np.uint64), (nb & LO32).astype(np.uint64)


def _k6_model(vals, markers, tables, bit0, cap_words, threads, items,
              seed=0):
    """The kernel's steps, tile by tile in ticket order: the fields
    resolved once, per-thread sums of `items` consecutive fields and one
    block scan, the start from a look-back (over a seeded mix of
    predecessors that have or have not published their inclusive
    prefix), then the fast path (the tile's words ORed in a buffer of
    tile + 1 words, interior words stored, the first and last added) or
    the slow path (per-field adds, clipped, offsets mod 2**32). Returns
    (words int32, total, slow tiles)."""
    tile = threads * items
    code, nb = _resolve_fields(vals, markers, tables)
    n = len(nb)
    ntiles = max(1, -(-n // tile))
    words = np.zeros(cap_words, np.uint64)
    touched = np.zeros(cap_words, bool)
    last = cap_words - 1
    agg_d, incl_d = [], []
    published = np.random.default_rng(seed).random(ntiles) < 0.3
    slow = 0
    for c in range(ntiles):
        f = slice(c * tile, min((c + 1) * tile, n))
        nbt = np.zeros(tile, np.uint64)
        nbt[:f.stop - f.start] = nb[f]
        codet = np.zeros(tile, np.uint64)
        codet[:f.stop - f.start] = code[f]
        per = nbt.reshape(threads, items)
        sums = per.sum(1)
        ex = ((np.cumsum(sums) - sums)[:, None] +
              np.cumsum(per, 1) - per).ravel()
        agg = int(sums.sum())
        a = (agg & LO32) | (BIG if agg >> 32 else 0)
        start = bit0
        if c > 0:  # the look-back: aggregates back to an inclusive one
            start, q = 0, c - 1
            while q > 0 and not published[q]:
                start = _combine(start, agg_d[q])
                q -= 1
            start = _combine(start, incl_d[q])
        agg_d.append(a)
        incl_d.append(_combine(start, a))
        s = start & LO32
        wraps = bool(start & BIG) or s + agg > 1 << 32
        fast = not (nbt > 32).any() and not wraps and \
            (agg == 0 or (s + agg - 1) >> 5 < last)
        if agg == 0:
            continue
        off = s + ex.astype(object)  # exact
        off = np.array([int(o) for o in off], np.uint64)
        mask = np.where(nbt >= 32, LO32,
                        (np.uint64(1) << np.minimum(nbt, 31)) - 1)
        t = (codet & mask) << (off & np.uint64(31))
        lo, hi = t & np.uint64(LO32), t >> np.uint64(32)
        live = nbt > 0
        if fast:
            w0 = s >> 5
            buf = np.zeros(tile + 1, np.uint64)
            k = (off >> np.uint64(5)).astype(np.int64) - w0
            np.bitwise_or.at(buf, k[live], lo[live])
            np.bitwise_or.at(buf, k[live] + 1, hi[live])
            nw = ((s + agg + 31) >> 5) - w0
            assert 1 <= nw <= tile + 1 and not buf[nw:].any()
            inner = slice(w0 + 1, w0 + nw - 1)
            assert not touched[inner].any()  # no other tile writes there
            words[inner] = buf[1:nw - 1]
            touched[inner] = True
            for k0 in {0, nw - 1}:
                words[w0 + k0] += buf[k0]
                touched[w0 + k0] = True
        else:
            slow += 1
            idx = ((off & np.uint64(LO32)) >> np.uint64(5)).astype(np.int64)
            np.add.at(words, np.minimum(idx[live], last), lo[live])
            np.add.at(words, np.minimum(idx[live] + 1, last), hi[live])
    total = incl_d[-1] & LO32
    return (words & np.uint64(LO32)).astype(np.uint32).view(np.int32), \
        total, slow


def _k6_check(vals, markers, tables, bit0, cap_words, threads=16,
              items=4):
    """The model against pack_plain and the JAX pack_kernel (which
    _pack_both holds equal); returns the model's slow tiles."""
    ref_w, ref_t = JB.pack_kernel(
        jnp.asarray(vals), jnp.asarray(markers),
        *map(jnp.asarray, tables), jnp.uint32(bit0), cap_words=cap_words)
    total = _pack_both(vals, markers, tables, bit0, cap_words)
    words, mtotal, slow = _k6_model(vals, markers, tables, bit0, cap_words,
                                    threads, items)
    np.testing.assert_array_equal(words.view(np.uint32), np.asarray(ref_w))
    assert mtotal == total == int(ref_t)
    return slow


def _k6_fields(rng, n, zero_share=0.6, max_raw=24):
    kind = rng.choice(4, n, p=[zero_share, (1 - zero_share) / 3,
                               (1 - zero_share) / 3, (1 - zero_share) / 3])
    vals = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    markers = np.zeros(n, np.int32)
    raw = kind == 1
    markers[raw] = rng.integers(1, max_raw + 1, int(raw.sum()))
    markers[kind == 2] = -2
    vals[kind == 2] = rng.integers(0, 256, int((kind == 2).sum()))
    markers[kind == 3] = -1
    vals[kind == 3] = np.where(rng.random(int((kind == 3).sum())) < 0.5,
                               rng.integers(0, 704, int((kind == 3).sum())),
                               4096 + rng.integers(0, 64,
                                                   int((kind == 3).sum())))
    return vals, markers


@pytest.mark.parametrize("bit0", [0, 1, 7, 17, 31])
def test_k6_model_seeded(bit0):
    """Every marker kind, runs of empty fields (a few whole tiles of
    them), fields straddling the tiles' edges, every bit0: no slow
    tile."""
    rng = np.random.default_rng(100 + bit0)
    n = 64 * 40 + 37
    vals, markers = _k6_fields(rng, n)
    markers[64 * 5:64 * 9] = 0   # four tiles of nothing
    markers[64 * 20 + 3:64 * 21 - 2] = 0
    assert _k6_check(vals, markers, _tables(rng), bit0, n) == 0


@pytest.mark.parametrize("where", ["table", "raw"])
def test_k6_model_wide_fields(where):
    """Fields of more than 32 bits (a code table's length, or a raw
    marker) take the slow path in their tiles only."""
    rng = np.random.default_rng(7)
    n = 64 * 20
    vals, markers = _k6_fields(rng, n)
    tables = _tables(rng)
    if where == "table":
        tables[1][:8] = 40  # literal lengths
        markers[64 * 3 + 5] = -2
        vals[64 * 3 + 5] = 3
    else:
        markers[64 * 3 + 5] = 33
        markers[64 * 11] = 45
    slow = _k6_check(vals, markers, tables, 5, n)
    assert 1 <= slow <= 2 if where == "raw" else slow >= 1


@pytest.mark.parametrize("share", [0.3, 0.7, 0.97])
def test_k6_model_span_reaches_cap(share):
    """Words that overflow the buffer add into its last word: the
    tiles whose span reaches cap_words - 1 take the slow path, the
    tiles before them do not (cap_words a share of the payload's)."""
    rng = np.random.default_rng(int(share * 100))
    n = 64 * 30
    vals, markers = _k6_fields(rng, n, zero_share=0.2)
    tables = _tables(rng)
    _, nb = _resolve_fields(vals, markers, tables)
    cap_words = int(share * (int(nb.sum()) + 9) / 32)
    slow = _k6_check(vals, markers, tables, 9, cap_words)
    assert 0 < slow < 30


def test_k6_model_offsets_wrap():
    """Three raw fields of 2**31 - 1 bits carry the offsets past 2**32:
    every tile from there on takes the slow path and its offsets wrap,
    as the JAX code's uint32 cumsum does."""
    rng = np.random.default_rng(3)
    n = 64 * 12
    vals, markers = _k6_fields(rng, n)
    markers[64 * 4 + 10] = markers[64 * 4 + 11] = 2 ** 31 - 1
    markers[64 * 6 + 1] = 2 ** 31 - 1
    slow = _k6_check(vals, markers, _tables(rng), 2, 4 * n)
    assert slow >= 12 - 6


def test_k6_model_real_plan(block):
    """The real plan of a 64 KiB metablock at 4,096-field tiles (256
    threads of 16, the kernel's own sizes): no slow tile."""
    raw, matches = block
    got, _ = _plan_both(raw, matches, RINGS["initial"], MB)
    vals, markers, h_lit, h_cmd, h_dist = got[:5]
    tables = []
    for h in (h_lit, h_cmd, h_dist):
        _, le, c = PD._tables(h.astype(np.int64), len(h))
        tables += [c, le]
    assert _k6_check(vals, markers, tables, 3, MB // 2 + 64, 256, 16) == 0
