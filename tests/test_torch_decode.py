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
    """decoder="python" is the Python decoder (dec/decoder.py), which
    gives the native decoder's bytes; an unknown name is refused."""
    stream = ENCODES["corpus q5"]()
    assert bt.decompress(stream, decoder="python") == \
        bt.decompress(stream)
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


# ---------------------------------------------------------------------
# a numpy model of K5's design (csrc/lz_resolve.cu) at a shrunk tile
# ---------------------------------------------------------------------

def _k5_model(lits, nlit, ncopy, dist, n_out, n_steps, tile, threads,
              in_place=False):
    """The kernel's steps: per tile a cooperative search of the first
    command (`threads` probes a round), the tile's literals (consecutive
    from the first command's), each command's literal and copy runs
    marked where they start in the tile and max-scanned, each position's
    state (resolved byte and
    depth 0, or a pointer j - dist at depth 1; a bad copy resolves to 0
    and sets err), the pointers into the tile jumped until none is
    left; then the global jumps and the depth mask. The jumps run out of
    place (every position reads, then every position writes) or, with
    `in_place`, one position at a time in ascending order: two of the
    schedules the kernel's threads may take, which must agree. Returns
    (out, err, unresolved after the tile collapse, global rounds)."""
    nlit, ncopy, dist = (np.asarray(a, np.int64) for a in (nlit, ncopy,
                                                           dist))
    lits = np.frombuffer(bytes(lits), np.uint8) if len(lits) else \
        np.zeros(1, np.uint8)
    adv = nlit + ncopy
    ends = np.cumsum(adv)
    lit_off = np.cumsum(nlit) - nlit
    ncmd = len(ends)
    res = np.zeros(n_out, bool)
    low = np.zeros(n_out, np.int64)  # byte if resolved, else target
    dep = np.zeros(n_out, np.int64)
    err = False

    def jump(act_of):
        """Jump the positions act_of() selects until none is left;
        returns the rounds."""
        rounds = 0
        while True:
            act = np.flatnonzero(act_of())
            if len(act) == 0:
                return rounds
            rounds += 1
            if in_place:
                for p in act:
                    t = low[p]
                    res[p], low[p], dep[p] = res[t], low[t], dep[p] + dep[t]
            else:
                t = low[act]
                res[act], low[act], dep[act] = res[t], low[t], \
                    dep[act] + dep[t]
            assert rounds <= 64

    left = 0
    for t0 in range(0, n_out, tile):
        t1 = min(t0 + tile, n_out)
        lo, hi = 0, ncmd
        while lo < hi:
            step = -(-(hi - lo) // threads)
            q = lo + np.arange(threads) * step
            c = int(((q < hi) & (ends[np.minimum(q, ncmd - 1)] <= t0)).sum())
            if c == 0:
                hi = lo
            else:
                hi = min(lo + c * step, hi)
                lo += (c - 1) * step + 1
        assert lo == np.searchsorted(ends, t0, side="right")
        # each command marks its literal run and its copy run where
        # they start in the tile (clipped to 0): key m + 1, the kind and
        # lit_off - start or dist; a max-scan carries each position's run
        key = np.zeros(t1 - t0, np.int64)
        is_copy = np.zeros(t1 - t0, bool)
        val = np.zeros(t1 - t0, np.int64)
        k = lo
        while True:
            ks = np.arange(k, min(k + threads, ncmd))
            s0 = ends[ks] - adv[ks]
            inside = s0 < t1
            m1 = s0 - t0
            m2 = m1 + nlit[ks]
            for sel, m, copy, v in (
                    (inside & (nlit[ks] > 0) & (m2 > 0), m1, False,
                     lit_off[ks] - s0),
                    (inside & (ncopy[ks] > 0) & (m2 < t1 - t0), m2, True,
                     dist[ks])):
                at = np.maximum(m[sel], 0)
                assert key[at].max(initial=0) == 0  # one mark a position
                key[at], is_copy[at], val[at] = at + 1, copy, v[sel]
            if inside.sum() < threads:
                break
            k += threads
        run = np.maximum.accumulate(key) - 1
        assert run[0] == 0
        is_copy, val = is_copy[run], val[run]
        j = np.arange(t0, t1)
        is_lit = ~is_copy
        src = j - val
        ok = is_lit | ((src >= 0) & (src < j))
        err |= not ok.all()
        li = np.clip(val + j, 0, len(lits) - 1)
        # the tile's literals are consecutive from l0, which the kernel
        # stages in shared memory
        l0 = lit_off[lo] + min(max(t0 - (ends[lo] - adv[lo]), 0), nlit[lo])
        if nlit.sum() <= len(lits):
            np.testing.assert_array_equal(li[is_lit],
                                          l0 + np.arange(is_lit.sum()))
        res[t0:t1] = is_lit | ~ok
        low[t0:t1] = np.where(is_lit, lits[li], np.where(ok, src, 0))
        dep[t0:t1] = np.where(is_lit | ~ok, 0, 1)
        sl = slice(t0, t1)
        jump(lambda: np.concatenate([np.zeros(t0, bool),
                                     ~res[sl] & (low[sl] >= t0),
                                     np.zeros(n_out - t1, bool)]))
        assert (res[sl] | (low[sl] < t0)).all()
        left += int((~res[sl]).sum())
    rounds = jump(lambda: ~res)
    limit = 1 << n_steps if n_steps < 31 else 1 << 62
    out = np.where(dep <= limit, low, 0).astype(np.uint8)
    return out, err, left, rounds


def _k5_cases():
    """(label, lits, (nlit, ncopy, dist)) small command lists: one deep
    RLE chain (distance 1 and 3 with zero-length commands between),
    chains that cross many tiles (copies one to three tiles back), and
    a part-full last tile."""
    rng = np.random.default_rng(11)
    lits = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    cases = [("rle", lits[:3], ([1, 0, 2, 0], [2999, 0, 1500, 0],
                                [1, 0, 3, 0]))]
    k = 400
    nl = rng.integers(0, 3, k)
    nl[0] = 5
    nc = rng.integers(20, 80, k)
    first_copy = np.cumsum(nl + nc) - nc
    far = np.minimum(rng.integers(60, 200, k), first_copy)
    cases.append(("cross tiles", lits[:int(nl.sum())], (nl, nc, far)))
    n = 64 * 37 + 13
    nl = np.array([7, 0, 3, 1])
    nc = np.array([0, 1000, 0, n - 1011])
    cases.append(("part-full tile", lits[:11], (nl, nc, [0, 5, 0, 70])))
    return cases


K5_CASES = _k5_cases()


@pytest.mark.parametrize("case", range(len(K5_CASES)),
                         ids=[c[0] for c in K5_CASES])
def test_k5_model_every_round_count(case):
    """The model, out of place and in place, against resolve_plain and
    the JAX _resolve at every n_steps from 0 to full, at a 64-position
    tile of 8 threads."""
    _, lits, cmds = K5_CASES[case]
    n_out = int(np.sum(cmds[0]) + np.sum(cmds[1]))
    full = PL.n_steps_for(n_out)
    parse = (lits, *(np.asarray(c, np.uint32) for c in cmds), None)
    for n_steps in range(full + 1):
        ref = _resolve_both(parse, n_steps)
        for in_place in (False, True):
            out, err, left, rounds = _k5_model(lits, *cmds, n_out, n_steps,
                                               64, 8, in_place)
            np.testing.assert_array_equal(out, ref)
            assert not err
    # the collapse leaves the cross-tile pointers; the rle chain's
    # tiles each point one tile back
    assert left > 0 and rounds > 0


@pytest.mark.parametrize("name", ["corpus q5", "rle q5"])
def test_k5_model_real_parse(name):
    """The real parse of an in-repo stream at 1,024-position tiles of 64
    threads, at the full round count and cut to half."""
    data = ENCODES[name]()
    lits, cn, cc, cd, depth = parse = PN.parse_stream(data)
    n_out = int(cn.sum(dtype=np.int64) + cc.sum(dtype=np.int64))
    full = PL.n_steps_for(n_out, depth)
    for n_steps in (full, full // 2):
        ref = _resolve_both(parse, n_steps)
        out, err, left, rounds = _k5_model(
            lits, *(c.astype(np.int64) for c in (cn, cc, cd)), n_out,
            n_steps, 1024, 64)
        np.testing.assert_array_equal(out, ref)
        assert not err and 0 < left < n_out and rounds <= full + 1


def test_k5_model_bad_copy():
    """A copy from before the output sets err and resolves to 0, as in
    the kernel (the wrapper then raises); the copies of it give 0 too."""
    out, err, _, _ = _k5_model(b"\x07", [1], [5], [2], 6, 3, 64, 8)
    assert err and out.tolist() == [7, 0, 7, 0, 7, 0]
