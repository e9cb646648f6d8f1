"""The device half of one DP segment in brotli_tpu_torch against the JAX
package, bit for bit, on the CPU.

  (b) the candidate edges (`_edges_slots`);
  (c) K1, the suffix-min: the plain version, transposed, against the
      Pallas kernel in interpret mode on two DP blocks;
  (d) K3, the wavefront scan, against `_scan_math_v3`, and K4, the
      backtrack with its compaction, against `_finish_math`;
  (e) the whole segment (`dp_v3_segment`) against `_dp_v3_impl` in
      interpret mode: `packed` and `stacked`.

On the CPU each kernel's wrapper takes its plain version, so these tests
pin the arithmetic the CUDA kernels must reproduce (chip_smoke.py holds
the kernels against the plain versions on the card). Real inputs come
from the port's corpus; synthetic ones, drawn from numpy seeds, are
dense in ties and edge cases.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.format import constants as C
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
SEG = 1 << 16
B, W = O.B, O.W


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
def host(v3):
    """The input (200 KB of C source, then dictionary-word text), its
    seed parse, cost tables and dictionary probe."""
    arr = np.frombuffer(build_corpus(1 << 20)[120_000:320_000], np.uint8)
    seed = O._seed_parse(arr, MAXD, 0)
    tables = OJ._cost_tables(arr, seed, lit_table=True)
    dict_g = O._dict_probe_global(arr, [seed], 0, MAXD)
    assert len(dict_g[0]) > 100
    return arr, seed, tables, dict_g


def _segment(host, lo, max_distance=MAXD):
    """Every input of the segment [lo, lo + SEG) as the port's CPU
    tensors (a dict) and as the JAX package's arrays (a tuple in
    `_dp_v3_impl` order)."""
    arr, seed, tables, dict_g = host
    hi = min(lo + SEG, len(arr))
    npos, spos, slen, sdist, dloc, dval = O._prep_segment_v3(
        arr, [seed], dict_g[0], dict_g[1], lo, hi, SEG)
    data = np.zeros(SEG, np.uint8)
    data[:hi - lo] = arr[lo:hi]
    bits_tab, ctx_tab, copyq, distq = O.device_tables(tables[:4], "cpu")
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    port = dict(data=torch.from_numpy(data), npos=npos,
                max_distance=max_distance, bits_tab=bits_tab,
                ctx_tab=ctx_tab, copyq=copyq, dist_sym_bits_q=distq,
                seed_pos=t(spos), seed_len=t(slen), seed_dist=t(sdist),
                dict_pos=t(dloc), dict_pay=t(dval), seg_base=lo)
    copyq_row = np.zeros((1, 128), np.int32)
    copyq_row[0, :W] = tables[1][:W]
    dq = np.concatenate([tables[2], tables[4]]).astype(np.int32)
    ref = (jnp.asarray(data), jnp.int32(npos), jnp.int32(max_distance),
           jnp.asarray(tables[0].astype(np.int32).reshape(-1)),
           jnp.asarray(tables[3].astype(np.int32)), jnp.asarray(copyq_row),
           jnp.asarray(dq), jnp.asarray(spos), jnp.asarray(slen),
           jnp.asarray(sdist), jnp.asarray(dloc), jnp.asarray(dval),
           jnp.int32(lo))
    return port, ref


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# (b) candidate edges
# ---------------------------------------------------------------------

@pytest.mark.parametrize("lo,maxd", [(0, MAXD), (2 * SEG, MAXD),
                                     (3 * SEG, MAXD), (SEG, (1 << 10) - 16)])
def test_edges_slots_match(host, lo, maxd):
    """Full, text and tail-padded segments (the npos + 3 guard sees the
    wrapped roll), and a small window (dist > max_distance)."""
    p, r = _segment(host, lo, maxd)
    port = O._edges_slots(p["data"], p["npos"], maxd, p["dist_sym_bits_q"],
                          p["seed_pos"], p["seed_len"], p["seed_dist"])
    ref = jax.jit(OJ._edges_slots)(r[0], r[1], r[2], r[6][:64], r[7],
                                   r[8], r[9])
    for a, b in zip(port, ref):
        assert a.dtype == torch.int32
        _eq(a.numpy(), b)
    live = min(SEG, len(host[0]) - lo)
    assert (port[0].numpy() >= 2).sum() > live


# ---------------------------------------------------------------------
# (c) K1, the suffix-min
# ---------------------------------------------------------------------

def _suffix_ref(pd, cs, copyq):
    row = np.zeros((1, 128), np.int32)
    row[0, :W] = copyq[:W]
    return np.asarray(OJ._suffix_pallas(jnp.asarray(pd), jnp.asarray(cs),
                                        jnp.asarray(row), interpret=True))


def _synthetic_slots(seed, nslots=29, n=2 * B):
    """Slot rows dense in ties: costs from a handful of values, lengths
    over the whole window, dictionary lengths beyond it, dead slots."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(0, W, (nslots, n))
    ls[nslots - 2] = rng.integers(0, 100, n)
    ds = rng.integers(0, 1 << 25, (nslots, n))
    cs = rng.choice([0, 5, 7, 7, 9, 200, 1 << 28], (nslots, n))
    cs = np.where(ls >= 2, cs, 1 << 28)
    pd = (ls << 25) | np.where(ls >= 2, ds, 0)
    copyq = rng.integers(0, 300, W)
    copyq[:2] = 1 << 28
    return (pd.astype(np.int32), cs.astype(np.int32),
            copyq.astype(np.int32))


def _extreme_slots(nslots, seed=3, n=2 * B):
    """The edge cases of K1's scatter: ties across slots, lengths over
    -64..63 (pd with bit 31 set), dictionary lengths 64..127 (which wrap
    to negative), costs at and above 1 << 28 and negative ones, and live
    distances on dead slots."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(-64, W, (nslots, n))
    ls[nslots - 2] = rng.integers(0, 128, n)
    ds = rng.integers(0, 1 << 25, (nslots, n))
    cs = rng.choice([-7, 0, 5, 5, 9, (1 << 28) - 1, 1 << 28, (1 << 28) + 1,
                     (1 << 31) - 1], (nslots, n))
    pd = ((ls << 25) | ds) & 0xFFFFFFFF
    copyq = rng.integers(0, 300, W)
    copyq[:2] = 1 << 28
    return (pd.astype(np.uint32).view(np.int32), cs.astype(np.int32),
            copyq.astype(np.int32))


def _slots_case(case):
    if case.startswith("extreme"):
        return _extreme_slots(int(case[len("extreme"):]))
    return _synthetic_slots(int(case[-1]))


@pytest.fixture(scope="module")
def seg_tables(host):
    """pd_flat, cs_flat and litq of the text segment [2 SEG, 3 SEG)."""
    p, _ = _segment(host, 2 * SEG)
    return p, O.segment_tables(
        p["data"], p["npos"], MAXD, p["bits_tab"], p["ctx_tab"],
        p["dist_sym_bits_q"], p["seed_pos"], p["seed_len"],
        p["seed_dist"], p["dict_pos"], p["dict_pay"], p["seg_base"])


@pytest.mark.parametrize("case", ["real", "synthetic0", "synthetic1",
                                  "extreme2", "extreme29", "extreme32"])
def test_suffix_min_matches_pallas(seg_tables, case):
    if case == "real":
        p, (pd, cs, _, _) = seg_tables
        # the two blocks with the most dictionary edges
        per_block = (pd[-2] >> 25).reshape(-1, B).gt(1).sum(1)
        k = int(per_block[:-1].add(per_block[1:]).argmax())
        assert per_block[k:k + 2].sum() > 10
        pd = pd[:, k * B:(k + 2) * B].contiguous().numpy()
        cs = cs[:, k * B:(k + 2) * B].contiguous().numpy()
        copyq = p["copyq"].numpy()
    else:
        pd, cs, copyq = _slots_case(case)
    port = O.suffix_min(torch.from_numpy(pd), torch.from_numpy(cs),
                        torch.from_numpy(copyq))
    assert port.shape == (pd.shape[1], 2 * W) and port.dtype == torch.int32
    _eq(port.numpy().T, _suffix_ref(pd, cs, copyq))


def test_suffix_min_chunking_is_invisible():
    pd, cs, copyq = _synthetic_slots(7, n=3 * B)
    args = [torch.from_numpy(x) for x in (pd, cs, copyq)]
    _eq(O.suffix_min_plain(*args, chunk=1000).numpy(),
        O.suffix_min_plain(*args).numpy())


def _suffix_model(pd, cs, copyq):
    """csrc/suffix_min.cu's algorithm in numpy: each live non-dictionary
    slot's key (cost, slot << 25 | dist) scattered with a min into
    bucket[len], one suffix-min over the columns (none for columns 0
    and 1), the dictionary key folded into column len alone, then the
    decode of M and P."""
    inf, none = O.EDGE_INF, O.EDGE_INF << 32
    nslots, n = pd.shape
    ln = pd >> 25
    slot = np.arange(nslots)[:, None]
    key = (cs.astype(np.int64) << 32) | (slot << 25) | (pd & O.MASK25)
    live = (cs < inf) & (ln >= 2)
    dslot = nslots - 2
    bucket = np.full((n, W), none, np.int64)
    for s in range(nslots):
        idx = np.nonzero(live[s])[0]
        if s != dslot:  # one key per position and slot: no collisions
            cur = bucket[idx, ln[s, idx]]
            bucket[idx, ln[s, idx]] = np.minimum(cur, key[s, idx])
    acc = np.minimum.accumulate(bucket[:, ::-1], axis=1)[:, ::-1].copy()
    acc[:, :2] = none
    idx = np.nonzero(live[dslot])[0]
    cols = ln[dslot, idx]
    acc[idx, cols] = np.minimum(acc[idx, cols], key[dslot, idx])
    cost = (acc >> 32).astype(np.int32)
    hit = cost < inf
    col = np.arange(W, dtype=np.int32)[None, :]
    m = np.where(hit, cost + copyq[None, :W], O.NO_EDGE)  # int32 wrap
    p = np.where(hit, (col << 25) | (acc & O.MASK25).astype(np.int32), 0)
    return np.concatenate([m, p], 1).astype(np.int32)


@pytest.mark.parametrize("case", ["extreme2", "extreme29", "extreme32",
                                  "synthetic0"])
def test_suffix_min_model_matches_plain(case):
    """The per-length scatter with one suffix-min gives the plain
    version's rows bit for bit, ties, clamps and dead slots included."""
    pd, cs, copyq = _slots_case(case)
    with np.errstate(over="ignore"):
        model = _suffix_model(pd, cs, copyq)
    plain = O.suffix_min_plain(torch.from_numpy(pd), torch.from_numpy(cs),
                               torch.from_numpy(copyq))
    _eq(model, plain.numpy())
    assert (model[:, :W] != O.NO_EDGE).any()


# ---------------------------------------------------------------------
# (d) K3, the scan, and K4, the backtrack + compaction
# ---------------------------------------------------------------------

_scan_ref = jax.jit(OJ._scan_math_v3)


def _scan_jax(mp, litq):
    nb = mp.shape[0] // B
    mp_all = mp.reshape(nb, B, 2 * W).transpose(1, 0, 2)
    return np.asarray(_scan_ref(jnp.asarray(mp_all),
                                jnp.asarray(litq.reshape(nb, B).T)))


def _finish_check(paymat, npos):
    count, stacked = OJ._finish_kernel(jnp.asarray(paymat), jnp.int32(npos))
    gsrc, vals = O.dp_backtrack(torch.from_numpy(paymat))
    assert gsrc.shape == vals.shape == (B, paymat.shape[0])
    pcount, pstacked = O.compact(gsrc, vals, npos)
    assert int(pcount) == int(count)
    _eq(pstacked.numpy(), np.asarray(stacked).astype(np.int64))
    return int(count)


def test_scan_and_backtrack_match_real(seg_tables):
    p, (pd, cs, litq, _) = seg_tables
    mp = O.suffix_min(pd, cs, p["copyq"])
    paymat = O.dp_scan(mp, litq)
    assert paymat.shape == (SEG // B, B + 1)
    _eq(paymat.numpy(), _scan_jax(mp.numpy(), litq.numpy()))
    assert _finish_check(paymat.numpy(), p["npos"]) > 1000


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_matches_synthetic(seed):
    """Ties everywhere: literal against match, match against match."""
    rng = np.random.default_rng(seed)
    n = 2 * B
    m = rng.choice([0, 3, 3, 4, 16], (n, W)) + rng.choice([16, 20], W)
    m = np.where(rng.random((n, W)) < 0.3, m, 1 << 29)
    m[:, :2] = 1 << 29
    col = np.arange(W)[None, :]
    pay = np.where(m < (1 << 29), (col << 25) | rng.integers(
        1, 1 << 25, (n, W)), 0)
    mp = np.concatenate([m, pay], 1).astype(np.int32)
    litq = rng.choice([4, 8, 16, 19, 20], n).astype(np.int32)
    port = O.dp_scan(torch.from_numpy(mp), torch.from_numpy(litq))
    _eq(port.numpy(), _scan_jax(mp, litq))


def _paymat(fill, seed=0, nb=2):
    """Payload rows for K4. "ones": every length 0 or 1, the longest walk
    (B positions); "63": every length W-1, the shortest; "random":
    lengths over -64..63 (bit 31 set below 0), steps that overrun the
    block start into negative positions; an int seed: the original mix
    of lengths up to W-1."""
    rng = np.random.default_rng(seed)
    if fill == "ones":
        ln = rng.integers(0, 2, (nb, B + 1))
    elif fill == "63":
        ln = np.full((nb, B + 1), W - 1)
    elif fill == "random":
        ln = rng.integers(-64, W, (nb, B + 1))
    else:
        ln = rng.choice([0, 1, 2, 3, 17, W - 1], (nb, B + 1))
    pay = ((ln << 25) | rng.integers(0, 1 << 25, (nb, B + 1))) & 0xFFFFFFFF
    return pay.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed,npos", [(0, 2 * B - 3), (1, 3000),
                                       (2, 0), ("ones", 2 * B - 3),
                                       ("63", 2 * B - 3),
                                       ("random", 2 * B - 3)])
def test_backtrack_matches_synthetic(seed, npos):
    """Random payloads, lengths up to W-1 at every position: steps that
    overrun the block start index from the row's end, as in JAX; and
    the all-ones, all-63 and signed-length chains."""
    if isinstance(seed, int):
        pay = _paymat(None, seed)
    else:
        pay = _paymat(seed)
    _finish_check(pay, npos)


def _backtrack_model(paymat, log_s=5):
    """csrc/dp_backtrack.cu's algorithm in numpy. log_s rounds of pointer
    doubling (J_0 = next, J_{r+1} = J_r o J_r; positions <= 0 are fixed
    points) give J_S = next^S, S = 2^log_s; the checkpoints c_{i+1} =
    J_S(c_i) chain from c_0 = B; then walk[S i + j] = next^j(c_i).
    Returns gsrc and vals in the (B, nb) layout."""
    nb = paymat.shape[0]
    s = 1 << log_s
    rows = np.arange(nb)[:, None]

    def step(q):
        ln = paymat[rows, np.maximum(q, 0)] >> 25
        return np.where(q > 0, q - np.maximum(ln, 1), q)

    jmp = step(np.broadcast_to(np.arange(1, B + 1), (nb, B)))  # entry p - 1
    for _ in range(log_s):
        hop = np.take_along_axis(jmp, np.maximum(jmp, 1) - 1, 1)
        jmp = np.where(jmp > 0, hop, jmp)
    ck = np.empty((nb, B // s), np.int64)
    c = np.full((nb, 1), B)
    for i in range(B // s):
        ck[:, i] = c[:, 0]
        c = np.where(c > 0, np.take_along_axis(jmp, np.maximum(c, 1) - 1, 1),
                     c)
    walk = np.empty((nb, B), np.int64)
    p = ck
    for j in range(s):
        walk[:, j::s] = p
        p = step(p)
    v = np.take_along_axis(paymat, np.where(walk < 0, walk + B + 1, walk),
                           1)
    ln = v >> 25
    src = walk - np.where(walk > 0, np.maximum(ln, 1), 0)
    start = (ln >= 2) & (walk > 0) & (src >= 0)
    gsrc = np.where(start, src + (np.arange(nb) * B)[:, None], -1)
    return gsrc.T.astype(np.int32), v.T.astype(np.int32)


@pytest.mark.parametrize("fill", ["ones", "63", "random", "mix"])
def test_backtrack_model_matches_plain(fill):
    """The doubled walk with its checkpoints gives the plain version's
    (B, nb) tables bit for bit, fixed points at and below 0 included,
    for the kernel's 32-step checkpoints and for 8-step ones."""
    pay = _paymat(None if fill == "mix" else fill, nb=3)
    pg, pv = O.dp_backtrack_plain(torch.from_numpy(pay))
    for log_s in (5, 3):
        gsrc, vals = _backtrack_model(pay, log_s)
        _eq(gsrc, pg.numpy())
        _eq(vals, pv.numpy())


# ---------------------------------------------------------------------
# (e) one whole segment
# ---------------------------------------------------------------------

@pytest.mark.parametrize("lo", [0, 2 * SEG])
def test_dp_v3_segment_matches(host, lo):
    p, r = _segment(host, lo)
    capm = SEG // O.CAPM_DIV
    packed, stacked = O.dp_v3_segment(**p, capm=capm)
    rpacked, rstacked = OJ.dp_parse_block_v3(*r, capm=capm,
                                             interpret=True)
    assert packed.shape == (2, capm + 8)
    assert stacked.shape == (2, SEG // 2)
    _eq(packed.numpy(), np.asarray(rpacked).astype(np.int64))
    _eq(stacked.numpy(), np.asarray(rstacked).astype(np.int64))
    count = int(packed[0, 0])
    assert 1000 < count <= capm
    # the dictionary slot won somewhere in the text segment
    if lo:
        pay = packed[1, 8:8 + count]
        pos = packed[0, 8:8 + count]
        assert ((pay & O.MASK25) > pos + lo).any()
