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


@pytest.fixture(scope="module")
def seg_tables(host):
    """pd_flat, cs_flat and litq of the text segment [2 SEG, 3 SEG)."""
    p, _ = _segment(host, 2 * SEG)
    return p, O.segment_tables(
        p["data"], p["npos"], MAXD, p["bits_tab"], p["ctx_tab"],
        p["dist_sym_bits_q"], p["seed_pos"], p["seed_len"],
        p["seed_dist"], p["dict_pos"], p["dict_pay"], p["seg_base"])


@pytest.mark.parametrize("case", ["real", "synthetic0", "synthetic1"])
def test_suffix_min_matches_pallas(seg_tables, case):
    if case == "real":
        p, (pd, cs, _) = seg_tables
        # the two blocks with the most dictionary edges
        per_block = (pd[-2] >> 25).reshape(-1, B).gt(1).sum(1)
        k = int(per_block[:-1].add(per_block[1:]).argmax())
        assert per_block[k:k + 2].sum() > 10
        pd = pd[:, k * B:(k + 2) * B].contiguous().numpy()
        cs = cs[:, k * B:(k + 2) * B].contiguous().numpy()
        copyq = p["copyq"].numpy()
    else:
        pd, cs, copyq = _synthetic_slots(int(case[-1]))
    port = O.suffix_min(torch.from_numpy(pd), torch.from_numpy(cs),
                        torch.from_numpy(copyq))
    assert port.shape == (pd.shape[1], 2 * W) and port.dtype == torch.int32
    _eq(port.numpy().T, _suffix_ref(pd, cs, copyq))


def test_suffix_min_chunking_is_invisible():
    pd, cs, copyq = _synthetic_slots(7, n=3 * B)
    args = [torch.from_numpy(x) for x in (pd, cs, copyq)]
    _eq(O.suffix_min_plain(*args, chunk=1000).numpy(),
        O.suffix_min_plain(*args).numpy())


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
    p, (pd, cs, litq) = seg_tables
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


@pytest.mark.parametrize("seed,npos", [(0, 2 * B - 3), (1, 3000),
                                       (2, 0)])
def test_backtrack_matches_synthetic(seed, npos):
    """Random payloads, lengths up to W-1 at every position: steps that
    overrun the block start index from the row's end, as in JAX."""
    rng = np.random.default_rng(seed)
    nb = 2
    ln = rng.choice([0, 1, 2, 3, 17, W - 1], (nb, B + 1))
    pay = (ln << 25) | rng.integers(0, 1 << 25, (nb, B + 1))
    _finish_check(pay.astype(np.int32), npos)


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
