"""The DP variants of brotli_tpu_torch (ops/optimal.DPConfig) against the
JAX package's environment variables, bit for bit, on the CPU.

  (a) DPConfig: the fields that would change nothing raise, and no
      BROTLI_TPU_* variable moves the port's bytes;
  (b) the cost tables, both branches with the implicit-cell row, under
      each cost knob, and the seed parse's quality;
  (c) v1: the edges (`edges_v1`), K7's plain version on real tables
      and on seeded extremes (with a numpy model of the kernel's
      per-column loop), the whole segment (`dp_v1_segment`);
  (d) K8's plain version, the path-ring scan, with the implicit-cell
      row off and on, on a real segment and on seeded rings; K1 at the
      39 slots of the 16-byte level;
  (e) `find_matches_optimal(dp=...)`: v1 whole and streamed, ring_scan,
      ring_scan + icell, level3, iterations=2, fast_first=False, the
      cost knobs; the encoded bytes of v1 and of compress_sharded with
      two shards, through both packages' decoders.

Segments are 64 KiB in both packages (SEG, _BUCKETS, SEG_V3). The JAX
package reads LEVELS at import and its variables while a function is
traced, so the level is patched on the module and every jit cache is
cleared inside each variable's scope. Inputs come from the port's
corpus and from numpy seeds only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import encoder as JE
from brotli_tpu.format import constants as C
from brotli_tpu.ops import chain_pallas as CP
from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu.parallel import shard as JS
from brotli_tpu.utils import jaxcfg
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
SEG = 1 << 16
B, W = O.B, O.W
INF = O.SCAN_INF
DPConfig = O.DPConfig


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
def small():
    """Both packages with no BROTLI_TPU_* variable and 64 KiB DP
    segments in both pipelines."""
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        for mod, names in ((OJ, ("SEG", "_BUCKETS", "SEG_V3", "_BUCKETS_V3")),
                           (O, ("SEG", "BUCKETS", "SEG_V3", "BUCKETS_V3"))):
            mp.setattr(mod, names[0], SEG)
            mp.setattr(mod, names[1], [SEG])
            mp.setattr(mod, names[2], SEG)
            mp.setattr(mod, names[3], [SEG])
        yield mp


@pytest.fixture
def jax_env(small):
    """Set the JAX package's variables (and its LEVELS) for one test,
    with every jit cache cleared on the way in and out, so no trace
    outlives the variables it read."""
    with pytest.MonkeyPatch.context() as mp:
        def apply(env, level3=False):
            jax.clear_caches()
            for k, v in env.items():
                mp.setenv(k, v)
            if level3:
                mp.setattr(OJ, "LEVELS", OJ.LEVELS + (O.LEVEL3,))
        yield apply
    jax.clear_caches()


@pytest.fixture(scope="module")
def arr():
    """Two segments: the C source of the corpus, then dictionary-word
    text."""
    return np.frombuffer(build_corpus(1 << 20)[150_000:150_000 + 2 * SEG],
                         np.uint8)


@pytest.fixture(scope="module")
def arr1(arr):
    """One segment, the variants whose code runs per segment alike."""
    return arr[:SEG - 1000]


@pytest.fixture(scope="module")
def seed(small, arr):
    return O._seed_parse(arr, MAXD, 0)


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _eq_all(xs, ys):
    assert len(xs) == len(ys)
    for k, (x, y) in enumerate(zip(xs, ys)):
        _eq(x, y, str(k))


# ---------------------------------------------------------------------
# (a) DPConfig
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(mode="v2"), dict(mode="v1", ring_scan=True),
    dict(mode="v1", icell=True), dict(icell=True), dict(iterations=0),
])
def test_invalid_dpconfig_raises(kw):
    with pytest.raises(ValueError):
        DPConfig(**kw)


def test_dpconfig_is_frozen_and_exported():
    cfg = DPConfig(mode="v1", level3=True)
    with pytest.raises(AttributeError):
        cfg.mode = "v3"
    assert bt.DPConfig is DPConfig
    assert len(cfg.levels) == 3 and len(DPConfig().levels) == 2


_EVERY_VARIABLE = {
    "BROTLI_TPU_DP": "v1", "BROTLI_TPU_RING_SCAN": "1",
    "BROTLI_TPU_ICELL": "1", "BROTLI_TPU_LEVEL3": "1",
    "BROTLI_TPU_DP_ITERS": "2", "BROTLI_TPU_FAST_FIRST": "0",
    "BROTLI_TPU_COST_SAMPLE": "4096", "BROTLI_TPU_LIT_SURCHARGE": "1.5",
    "BROTLI_TPU_INS_SCALE": "0.5", "BROTLI_TPU_CMD_EXTRA": "2.0",
    "BROTLI_TPU_SEED_Q": "5", "BROTLI_TPU_LIT_UTF8": "0",
    "BROTLI_TPU_ENCODER": "native", "BROTLI_TPU_DECODER": "python",
    "BROTLI_TPU_BACKEND": "jax", "BROTLI_TPU_SERIALIZER": "device",
    "BROTLI_TPU_NO_NATIVE_DICT": "1", "BROTLI_TPU_TRACE": "1",
}


def test_variables_do_not_move_the_port(small, arr1, monkeypatch):
    """Every BROTLI_TPU_* variable the JAX package reads, set away from
    its default, leaves the port's stream as it was."""
    def stream():
        return PE._encode_q11_streamed(arr1, len(arr1), MAXD, 11, 16, 22,
                                       torch.device("cpu"))
    want = stream()
    for k, v in _EVERY_VARIABLE.items():
        monkeypatch.setenv(k, v)
    assert stream() == want


def test_compress_passes_dp_down(monkeypatch):
    """api.compress hands `dp` to the device DP (the parse itself is
    held to the JAX package below)."""
    seen = []

    class Stop(Exception):
        pass

    def spy(*args, dp=None, **kw):
        seen.append(dp)
        raise Stop
    monkeypatch.setattr(PE, "find_matches_optimal", spy)
    cfg = DPConfig(mode="v1")
    with pytest.raises(Stop):
        bt.compress(bytes(PE.MIN_DEVICE_INPUT), quality=11, device="cpu",
                    dp=cfg)
    assert seen == [cfg]


# ---------------------------------------------------------------------
# (b) cost tables and the seed parse
# ---------------------------------------------------------------------

_KNOBS = [
    ({}, DPConfig()),
    ({"BROTLI_TPU_COST_SAMPLE": "40000"}, DPConfig(cost_sample=40000)),
    ({"BROTLI_TPU_LIT_SURCHARGE": "1.35"}, DPConfig(lit_surcharge=1.35)),
    ({"BROTLI_TPU_INS_SCALE": "0.6"}, DPConfig(ins_scale=0.6)),
    ({"BROTLI_TPU_CMD_EXTRA": "1.7"}, DPConfig(cmd_extra=1.7)),
]


@pytest.mark.parametrize("lit_table", [False, True])
@pytest.mark.parametrize("k", range(len(_KNOBS)))
def test_cost_tables_match(jax_env, arr, seed, lit_table, k):
    env, cfg = _KNOBS[k]
    jax_env(env)
    port = O._cost_tables(arr, seed, lit_table=lit_table, cfg=cfg)
    ref = OJ._cost_tables(arr, seed, lit_table=lit_table)
    _eq_all(port, ref)
    assert len(port) == (5 if lit_table else 3)
    if not lit_table:
        assert port[0].shape == (256, 256) and port[0].dtype == np.int32


def test_cost_tables_without_joint_stats(jax_env, arr):
    """A seed of under 17 matches takes the implicit-cell row's other
    branch (copy cost + the ring code's cost)."""
    jax_env({})
    seed = tuple(np.asarray(x)[:10] for x in O._seed_parse(arr, MAXD, 0))
    _eq_all(O._cost_tables(arr, seed, lit_table=True, cfg=DPConfig()),
            OJ._cost_tables(arr, seed, lit_table=True))


def test_seed_quality(jax_env, arr):
    jax_env({"BROTLI_TPU_SEED_Q": "5"})
    _eq_all(O._seed_parse(arr, MAXD, 0, seed_q=5),
            OJ._seed_parse(arr, MAXD, 0))


# ---------------------------------------------------------------------
# (c) v1: edges, K7, the segment
# ---------------------------------------------------------------------

def _v1_inputs(arr, seed, lo, level3=False):
    """One v1 segment [lo, lo + SEG): the port's CPU tensors and the JAX
    package's arrays, in dp_parse_block order."""
    hi = min(lo + SEG, len(arr))
    data = np.zeros(SEG, np.uint8)
    data[:hi - lo] = arr[lo:hi]
    npos = max(hi - lo - 3, 0)
    lit, copyq, distq = O._cost_tables(arr, seed, lit_table=False,
                                       cfg=DPConfig(level3=level3))
    spos, slen, sdist = O._seg_seed_edges([seed], lo, hi, SEG // 32)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    port = (torch.from_numpy(data), npos, MAXD,
            torch.from_numpy(lit.reshape(-1)), torch.from_numpy(copyq),
            torch.from_numpy(distq), t(spos), t(slen), t(sdist))
    ref = (jnp.asarray(data), jnp.int32(npos), jnp.int32(MAXD),
           jnp.asarray(lit), jnp.asarray(copyq), jnp.asarray(distq),
           jnp.asarray(spos), jnp.asarray(slen), jnp.asarray(sdist))
    return port, ref


def _to_jax_layout(flat):
    """(nslots, n) -> the JAX package's (B, nslots, nb)."""
    ns, n = flat.shape
    return np.asarray(flat).reshape(ns, n // B, B).transpose(2, 0, 1)


@pytest.fixture(scope="module")
def v1_edges(small, arr, seed):
    """The port's v1 edges of the second (tail-padded) segment."""
    port, ref = _v1_inputs(arr, seed, SEG)
    d, npos, maxd, lit, copyq, distq, *seeds = port
    return port, ref, O.edges_v1(d, npos, maxd, lit, distq, *seeds)


@pytest.mark.parametrize("lo,level3", [(0, False), (SEG, False),
                                       (0, True)])
def test_edges_v1_match(jax_env, arr, seed, lo, level3):
    jax_env({}, level3=level3)
    port, ref = _v1_inputs(arr, seed, lo, level3)
    d, npos, maxd, lit, copyq, distq, *seeds = port
    pd, cs, litq = O.edges_v1(d, npos, maxd, lit, distq, *seeds,
                              levels=DPConfig(level3=level3).levels)
    assert pd.shape[0] == (38 if level3 else 28)
    rpd, rcs, rlq = OJ._edges_kernel(*ref)
    _eq(_to_jax_layout(pd), rpd)
    _eq(_to_jax_layout(cs), rcs)
    _eq(litq.view(-1, B).T, rlq)
    assert (pd >> 25).ge(2).sum() > SEG // 2


def test_scan_v1_real(small, v1_edges):
    port, ref, (pd, cs, litq) = v1_edges
    got = O.dp_scan_v1(pd, cs, litq, port[4])
    want = OJ._scan_kernel(_to_jax_layout(pd), _to_jax_layout(cs),
                           litq.view(-1, B).T.numpy(), ref[4])
    _eq(got, want)
    assert (got >> 25).ge(2).sum() > 1000


def v1_case(kind, nslots, nb, seed):
    """Seeded K7 inputs (pd, cs, litq, copyq) over nb DP blocks, as
    chip_smoke.py draws them: "ties" (costs from three values and
    distances from eight, so equal sums at different distances abound;
    lengths over -64..63: stubs below 2 and negative pd), "empty" (every
    length 0), "stubs" (lengths -3..1 at cheap costs), "expensive"
    (costs at and above 1 << 28 on live slots, and near 2**31 so sums
    wrap), "block end" (every slot 63 long, cut at each block's end),
    "cost wrap" (literal costs near 2**20 and slot costs near 1.5 *
    2**30: once cost_i passes 2**29 the slots' sums cross 2**31 and
    wrap, inside a block), "mixed" (the ties case, with
    one slot in 200 at a cost near 2**31 on scattered steps)."""
    rng = np.random.default_rng(seed)
    n = nb * B
    ls = rng.integers(-64, 64, (nslots, n)).astype(np.int64)
    ds = rng.integers(1, 9, (nslots, n)) * 1000 + rng.integers(0, 2, (
        nslots, n))
    cs = rng.choice([300, 301, 420], (nslots, n))
    if kind == "empty":
        ls[:] = 0
    elif kind == "stubs":
        ls = rng.integers(-3, 2, (nslots, n))
    elif kind == "expensive":
        ls = rng.integers(2, 64, (nslots, n))
        cs = rng.choice([1 << 28, (1 << 28) + 7, (1 << 31) - 5, 500],
                        (nslots, n))
    elif kind == "block end":
        ls[:] = 63
    elif kind == "cost wrap":
        cs = rng.choice([3 << 29, (3 << 29) + 1, (3 << 29) + 300],
                        (nslots, n))
    elif kind == "mixed":
        rare = rng.random((nslots, n)) < 0.005
        cs = np.where(rare, (1 << 31) - rng.integers(1, 400, (nslots, n)),
                      cs)
    ls = np.minimum(ls, B - np.arange(n) % B)
    pd = ((ls << 25) | ds) & 0xFFFFFFFF
    litq = rng.integers(20, 200, n).astype(np.int32)
    if kind == "cost wrap":
        litq = rng.integers((1 << 20) - 500, (1 << 20) + 500, n).astype(
            np.int32)
    copyq = rng.integers(0, 300, W).astype(np.int32)
    copyq[:2] = 1 << 28
    return (pd.astype(np.uint32).view(np.int32), cs.astype(np.int32), litq,
            copyq)


_V1_CASES = [("ties", 28, 1), ("ties", 38, 2), ("empty", 28, 3),
             ("stubs", 28, 6), ("expensive", 28, 4), ("block end", 38, 5),
             ("cost wrap", 28, 7), ("mixed", 38, 8)]


@pytest.mark.parametrize("kind,nslots,sd", _V1_CASES)
def test_scan_v1_seeded(kind, nslots, sd):
    pd, cs, litq, copyq = v1_case(kind, nslots, 2, sd)
    got = O.dp_scan_v1(*(torch.from_numpy(a) for a in (pd, cs, litq, copyq)))
    want = jax.jit(OJ._scan_kernel)(_to_jax_layout(pd), _to_jax_layout(cs),
                                    litq.reshape(-1, B).T, copyq)
    _eq(got, want)


def k7_model(pd, cs, litq, copyq):
    """K7's algorithm in numpy (csrc/dp_scan_v1.cu): per step, each
    window column c >= 2 walks the slots in order keeping (best, bpay),
    from (1 << 30, 0x7FFFFFFF), replaced by a slot that reaches c with
    a smaller sum, or an equal sum and a smaller payload; the column
    takes it only where best < F. The window is a ring indexed (j - i)
    mod W, as the kernel's threads hold it."""
    ns, n = pd.shape
    nb = n // B
    pd3, cs3, lq = (a.reshape(-1, nb, B) for a in (pd, cs, litq[None]))
    j = np.arange(W)
    F = np.full((nb, W), INF, np.int32)
    F[:, 0] = 0
    P = np.zeros((nb, W), np.int32)
    out = np.zeros((nb, B + 1), np.int32)
    for i in range(B):
        c = (j - i) % W                      # column of thread j
        own0 = c == 0
        cost = F[:, own0][:, 0]
        out[:, i] = P[:, own0][:, 0]
        lv = cost + lq[0, :, i]
        c1 = np.flatnonzero(c == 1)[0]
        take = lv < F[:, c1]
        F[take, c1], P[take, c1] = lv[take], 0
        best = np.full((nb, W), INF, np.int32)
        bpay = np.full((nb, W), 0x7FFFFFFF, np.int32)
        for s in range(ns):
            v = pd3[s, :, i][:, None]
            val = (cost + cs3[s, :, i])[:, None] + copyq[c][None, :]
            pay = (c[None, :] << 25) | (v & O.MASK25)
            t = (c >= 2)[None, :] & (c[None, :] <= (v >> 25)) & (
                (val < best) | ((val == best) & (pay < bpay)))
            best, bpay = np.where(t, val, best), np.where(t, pay, bpay)
        upd = (c >= 2)[None, :] & (best < F)
        F, P = np.where(upd, best, F), np.where(upd, bpay, P)
        F[:, own0], P[:, own0] = INF, 0
    out[:, B] = P[:, (j - B) % W == 0][:, 0]
    return out


@pytest.mark.parametrize("kind,nslots,sd", _V1_CASES[1:2] + _V1_CASES[4:5])
def test_k7_model_matches_plain(kind, nslots, sd):
    pd, cs, litq, copyq = v1_case(kind, nslots, 1, sd)
    with np.errstate(over="ignore"):
        model = k7_model(pd, cs, litq, copyq)
    _eq(model, O.dp_scan_v1_plain(
        *(torch.from_numpy(a) for a in (pd, cs, litq, copyq))))


def test_dp_v1_segment_matches(small, arr, seed):
    port, ref = _v1_inputs(arr, seed, 0)
    count, stacked = O.dp_v1_segment(*port)
    rc, rs = OJ.dp_parse_block(*ref)
    assert int(count) == int(rc) > 1000
    _eq(stacked.numpy().astype(np.uint32), rs)


# ---------------------------------------------------------------------
# (d) K8, the path-ring scan, and K1 at 39 slots
# ---------------------------------------------------------------------

def _ring_ref(mp, litq, data, ring_init, ring_cost, copyq, icell, npos,
              use_icell, jax_env):
    """optimal_jax._scan_math_v3 with the ring arguments, traced with
    BROTLI_TPU_ICELL as `use_icell` says."""
    jax_env({"BROTLI_TPU_ICELL": "1" if use_icell else "0"})
    n = len(data)
    nb = n // B
    du = np.asarray(data).astype(np.uint32)
    w0 = du | np.roll(du, -1) << 8 | np.roll(du, -2) << 16 | \
        np.roll(du, -3) << 24
    w_full = np.stack([np.roll(w0, -4 * k) for k in range(4)])
    row = np.zeros((1, 128), np.int32)
    row[0, :W] = copyq[:W]
    return jax.jit(OJ._scan_math_v3)(np.asarray(mp).reshape(nb, B, 2 * W).transpose(1, 0, 2),
              np.asarray(litq).reshape(nb, B).T,
              wc_all=w_full.reshape(4, nb, B).transpose(2, 0, 1),
              w_full=w_full, ring_init=np.asarray(ring_init),
              ring_cost=jnp.int32(ring_cost), copyq_row=row,
              npos=jnp.int32(npos), icell_row=np.asarray(icell))


@pytest.fixture(scope="module")
def v3_segment(small, arr, seed):
    """The K1 rows, literal costs and entry rings of the first v3
    segment, with its tables (icell row included)."""
    tables = O._cost_tables(arr, seed, lit_table=True, cfg=DPConfig())
    dict_g = O._dict_probe_global(arr, [seed], 0, MAXD)
    bits_tab, ctx_tab, copyq, distq = O.device_tables(tables, "cpu")
    npos, *rest = O.segment_inputs(arr, [seed], dict_g, 0, SEG, SEG, "cpu")
    data = torch.from_numpy(arr[:SEG].copy())
    pd, cs, litq, dist_fill = O.segment_tables(
        data, npos, MAXD, bits_tab, ctx_tab, distq, *rest, 0)
    mp = O.suffix_min(pd, cs, copyq)
    return dict(mp=mp, litq=litq, data=data, npos=npos, copyq=copyq,
                ring_init=dist_fill.view(-1, B)[:, 0].contiguous(),
                distq=distq, icell=torch.from_numpy(tables[4]))


@pytest.mark.parametrize("use_icell", [False, True])
def test_scan_ring_real(jax_env, v3_segment, use_icell):
    s = v3_segment
    icell = s["icell"] if use_icell else None
    got = O.dp_scan_ring(s["mp"], s["litq"], s["data"], s["ring_init"],
                         s["distq"][:1], s["copyq"], icell, s["npos"])
    want = _ring_ref(s["mp"], s["litq"], s["data"], s["ring_init"],
                     int(s["distq"][0]), s["copyq"].numpy(),
                     s["icell"].numpy(), s["npos"], use_icell, jax_env)
    _eq(got, want)
    # the ring edge won somewhere: payloads whose distance is a ring
    assert not torch.equal(got, O.dp_scan(s["mp"], s["litq"]))


def ring_case(kind, nb, seed):
    """Seeded K8 inputs over nb DP blocks: (mp, litq, data, ring_init,
    ring_cost, copyq, icell, npos). Bytes repeat with a period of 2,000
    plus sparse noise, so ring distances that are multiples of it match
    up to the 16-byte cap; the K1 rows offer sparse edges whose
    distances (R after a win) are the period, the previous block's
    reach or beyond the segment start. Kinds: "prev block" (entry rings
    of 4,100 to 8,000, into the block before), "to start" (block b
    enters with ring b * B + k for k in -1, 0, 1: src one before, at and
    after the segment start), "npos cut" (npos ends half way into the
    last block), "wrap" (the last block's bytes repeat the segment's
    head, so the lanes at the end compare wrapped words), "literal run"
    (edges at 0.1%, so a ring is inherited across runs of more than 32
    literals), "ring churn" (edges at 30%, so R is set at column 2 on
    most steps), "column 1" (the rows also reach column 1, below the
    literal's cost, so a ring comes from a row's payload there: one the
    look-ahead of csrc/dp_scan_ring.cu does not cover)."""
    rng = np.random.default_rng(seed)
    n = nb * B
    period = rng.integers(0, 256, 2000, dtype=np.uint8)
    data = np.resize(period, n)
    noise = rng.random(n) < 0.01
    data[noise] = rng.integers(0, 256, int(noise.sum()))
    if kind == "wrap":
        data[-B:] = data[:B]
    m = np.full((n, W), O.NO_EDGE, np.int32)
    py = np.zeros((n, W), np.int32)
    share = {"literal run": 0.001, "ring churn": 0.3}.get(kind, 0.02)
    live = rng.random((n, W)) < share
    live[:, 0] = False
    if kind != "column 1":
        live[:, 1] = False
    m[live] = rng.integers(200, 900, int(live.sum()))
    if kind == "column 1":
        m[live[:, 1], 1] = rng.integers(10, 40, int(live[:, 1].sum()))
    dist = rng.choice([2000, 4000, 4100, 6000, 9000], (n, W))
    py[live] = ((np.arange(W)[None, :] << 25) | dist)[live]
    mp = np.concatenate([m, py], axis=1)
    litq = rng.integers(40, 120, n).astype(np.int32)
    if kind == "prev block":
        ring_init = rng.integers(4100, 8000, nb)
    elif kind == "to start":
        ring_init = np.arange(nb) * B + rng.integers(-1, 2, nb)
    else:
        ring_init = rng.choice([0, 2000, 4000], nb)
    copyq = rng.integers(30, 200, W).astype(np.int32)
    copyq[:2] = 1 << 28
    icell = rng.integers(20, 300, W).astype(np.int32)
    icell[:2] = 1 << 28
    npos = n - B // 2 if kind == "npos cut" else n - 3
    return (mp, litq, data, ring_init.astype(np.int32), 40, copyq, icell,
            npos)


RING_KINDS = [("prev block", False), ("to start", True), ("npos cut", False),
              ("wrap", True), ("literal run", False), ("ring churn", True),
              ("column 1", False)]


@pytest.mark.parametrize("kind,use_icell", RING_KINDS)
def test_scan_ring_seeded(jax_env, kind, use_icell):
    mp, litq, data, ring_init, rc, copyq, icell, npos = ring_case(kind, 3,
                                                                 7)
    t = torch.from_numpy
    got = O.dp_scan_ring(t(mp), t(litq), t(data), t(ring_init),
                         torch.tensor([rc], dtype=torch.int32), t(copyq),
                         t(icell) if use_icell else None, npos)
    want = _ring_ref(mp, litq, data, ring_init, rc, copyq, icell, npos,
                     use_icell, jax_env)
    _eq(got, want)
    rings = (got & O.MASK25)[(got >> 25) >= 2]
    assert rings.numel() > 1000


def test_suffix_min_39_slots_matches_pallas():
    """K1 at the 39 slots of v3 with the 16-byte level, on seeded
    extremes as chip_smoke.py draws them, against the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(39)
    ns, n = 39, 2 * B
    ls = rng.integers(-64, 64, (ns, n)).astype(np.int64)
    ls[ns - 2] = rng.integers(0, 128, n)
    ds = rng.integers(0, 1 << 25, (ns, n))
    vals = np.array([-7, 0, 5, 5, 9, (1 << 28) - 1, 1 << 28, (1 << 28) + 1,
                     (1 << 31) - 1], np.int32)
    cs = vals[rng.integers(0, len(vals), (ns, n))]
    pd = (((ls << 25) | ds) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    copyq = rng.integers(0, 300, W).astype(np.int32)
    copyq[:2] = 1 << 28
    got = O.suffix_min(torch.from_numpy(pd), torch.from_numpy(cs),
                       torch.from_numpy(copyq))
    row = np.zeros((1, 128), np.int32)
    row[0, :W] = copyq
    want = OJ._suffix_pallas(jnp.asarray(pd), jnp.asarray(cs),
                             jnp.asarray(row), interpret=True)
    _eq(got.T, want)


# ---------------------------------------------------------------------
# (e) the whole parse, the encode and the shards
# ---------------------------------------------------------------------

# (variables, config, level3, two segments): fast_first and the
# iterations' seeds need a second segment
_VARIANTS = {
    "v1": ({"BROTLI_TPU_DP": "v1"}, DPConfig(mode="v1"), False),
    "ring": ({"BROTLI_TPU_DP": "v3", "BROTLI_TPU_RING_SCAN": "1"},
             DPConfig(ring_scan=True), False),
    "ring+icell": ({"BROTLI_TPU_DP": "v3", "BROTLI_TPU_RING_SCAN": "1",
                    "BROTLI_TPU_ICELL": "1"},
                   DPConfig(ring_scan=True, icell=True), False),
    "level3": ({"BROTLI_TPU_DP": "v3", "BROTLI_TPU_LEVEL3": "1"},
               DPConfig(level3=True), True),
    "iterations=2": ({"BROTLI_TPU_DP": "v3", "BROTLI_TPU_DP_ITERS": "2"},
                     DPConfig(iterations=2), False),
    "fast_first=False": ({"BROTLI_TPU_DP": "v3",
                          "BROTLI_TPU_FAST_FIRST": "0"},
                         DPConfig(fast_first=False), False),
    "v1 iterations=2, level3": (
        {"BROTLI_TPU_DP": "v1", "BROTLI_TPU_DP_ITERS": "2"},
        DPConfig(mode="v1", iterations=2, level3=True), True),
    "cost knobs": ({"BROTLI_TPU_DP": "v3", "BROTLI_TPU_COST_SAMPLE": "50000",
                    "BROTLI_TPU_LIT_SURCHARGE": "1.25",
                    "BROTLI_TPU_INS_SCALE": "0.8",
                    "BROTLI_TPU_CMD_EXTRA": "1.5",
                    "BROTLI_TPU_SEED_Q": "7"},
                   DPConfig(cost_sample=50000, lit_surcharge=1.25,
                            ins_scale=0.8, cmd_extra=1.5, seed_q=7), False),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_find_matches_optimal_variant(jax_env, arr, arr1, name):
    env, cfg, level3 = _VARIANTS[name]
    data = arr if name in ("iterations=2", "fast_first=False") else arr1
    jax_env(env, level3)
    port = O.find_matches_optimal(data, MAXD, device="cpu", dp=cfg)
    ref = OJ.find_matches_optimal_jax(data, MAXD, 11)
    _eq_all(port, ref)
    assert len(port[0]) > 1000


def test_find_matches_v1_streamed(jax_env, arr):
    """v1 streaming: the spans and their matches, metablocks of 16 KiB
    (four a segment)."""
    jax_env({"BROTLI_TPU_DP": "v1"})
    got, want = [], []
    O.find_matches_optimal(arr, MAXD, device="cpu", dp=DPConfig(mode="v1"),
                           on_block=lambda *a: got.append(a),
                           mb_size=1 << 14)
    OJ.find_matches_optimal_jax(arr, MAXD, 11,
                                on_block=lambda *a: want.append(a),
                                mb_size=1 << 14)
    assert len(got) == len(want) == len(arr) >> 14
    for (lo, hi, m), (rlo, rhi, rm) in zip(got, want):
        assert (lo, hi) == (rlo, rhi)
        _eq_all(m, rm)


@pytest.mark.parametrize("lgblock", [18])
def test_encode_v1_matches_jax(jax_env, arr, lgblock):
    """The v1 stream of the q11 encode, metablocks of two segments
    (collected whole, then split), through both decoders (spans of a
    quarter segment: test_find_matches_v1_streamed)."""
    jax_env({"BROTLI_TPU_DP": "v1"})
    out = PE._encode_q11_streamed(arr, len(arr), MAXD, 11, lgblock, 22,
                                  torch.device("cpu"), DPConfig(mode="v1"))
    ref = JE._encode_q11_streamed(arr, len(arr), MAXD, 11, lgblock, 22)
    assert out == ref
    assert JN.decode(out) == bytes(arr) == bt.decompress(out)


def test_compress_sharded_v1_matches_jax_default(small):
    """compress_sharded(quality=11, n_shards=2, dp=DPConfig(mode="v1"))
    is the JAX package's default on a GPU: its single-device branch
    (`jax.devices` cut to one, `backend_or_cpu` reporting "gpu", so
    `_dp_mode` picks v1), with no BROTLI_TPU_DP set. The second shard's
    seed parse runs the device matcher, whose buckets shrink in both
    packages."""
    data = build_corpus(1 << 20)[300_000:300_000 + 2 * SEG]
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxcfg, "backend_or_cpu", lambda: "gpu")
        mp.setattr(CP, "chain_select", CP.chain_select_xla)
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        for mod in (MJ, PM):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 17])
            mp.setattr(mod, "SEG_BYTES", 1 << 17)
        assert OJ._dp_mode() == "v1"
        out = PS.compress_sharded(data, quality=11, n_shards=2,
                                  device="cpu", dp=DPConfig(mode="v1"))
        ref = JS.compress_sharded(data, quality=11, n_shards=2)
    assert out == ref
    assert JN.decode(out) == data == bt.decompress(out)
