"""Numpy models of the Hopper designs of K7 (csrc/dp_scan_v1.cu) and K8
(csrc/dp_scan_ring.cu), held bit for bit against their plain versions
(ops/optimal.dp_scan_v1_plain, dp_scan_ring_plain) on the CPU.

  K7: per step, the producer's per-length scatter of 64-bit keys
      (cs + 2**31) << 25 | dist into 64 buckets and the suffix-min from
      column 63 down to 2, and the interval of cost_i for which no live
      sum wraps; the consumer's one add, compare and select a column
      where cost_i lies in it, and the exact slot loop where it does
      not, counted;
  K8: the look-ahead compare: at step i the two candidates of
      ring_{i+1} (the R column 1 held before the step, and ring_i) are
      compared at position i + 1, and step i + 1 takes the length of the
      one its ring equals (capped; 0 where ring <= 0 or src < 0); a ring
      that is neither is compared on the chain, counted.

Both run on every seeded case of tests/test_torch_dp_variants.py (old
and new) and on real 512 KiB segments of the port's corpus. The slow
counters are the kernels' own (kernels.SLOW): 0 on the real segments.
"""

import numpy as np
import pytest
import torch

from brotli_tpu_torch.format import constants as C
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus
from test_torch_dp_variants import (RING_KINDS, _V1_CASES, _eq,  # noqa: F401
                                    one_torch_thread, ring_case, v1_case)

B, W = O.B, O.W
INF = O.SCAN_INF
MASK25 = O.MASK25
MAXD = C.max_backward_distance(22)
REAL = 512 << 10
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
NONE = np.uint64(0xFFFFFFFFFFFFFFFF)


def i32(x):
    """int32 with wrap-around, as the kernels' add32."""
    return np.asarray(x, np.int64).astype(np.int32)


# ---------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------

def k7_reduce(v, w, cq):
    """The producer's work for one step of every block: v, w the
    (nslots, nb) pd and cs. Returns the (nb, W) (M, pay) the consumer
    reads (pay 0 where no live slot reaches the column; columns 0 and 1
    unused) and the (nb,) int32 interval [lo, hi] of cost_i for which
    no sum of a live slot wraps."""
    ns, nb = v.shape
    ls = v >> 25
    live = ls >= 2
    key = ((w.astype(np.int64) + (1 << 31)).astype(np.uint64) << np.uint64(
        25)) | (v & MASK25).astype(np.uint64)
    bk = np.full((nb, W), NONE, np.uint64)
    s, b = np.nonzero(live)
    np.minimum.at(bk, (b, ls[s, b]), key[s, b])
    run = np.minimum.accumulate(bk[:, ::-1], axis=1)[:, ::-1]
    col = np.arange(W)
    reached = (run != NONE) & (col >= 2)
    cs = (run >> np.uint64(25)).astype(np.int64) - (1 << 31)
    M = np.where(reached, i32(cs + cq[None, :]), 0).astype(np.int32)
    pay = np.where(reached, (col << 25) | (run & np.uint64(MASK25)).astype(
        np.int64), 0).astype(np.int32)
    cqmin, cqmax = int(cq[2:].min()), int(cq[2:].max())
    csmin = np.where(live, w, I32_MAX).min(0).astype(np.int64)
    csmax = np.where(live, w, I32_MIN).max(0).astype(np.int64)
    top = np.maximum(csmax, csmax + cqmax)
    bot = np.minimum(csmin, csmin + cqmin)
    hi64, lo64 = I32_MAX - top, I32_MIN - bot
    empty = (lo64 > hi64) | (lo64 > I32_MAX)
    lo = np.where(empty, I32_MAX, np.maximum(lo64, I32_MIN))
    hi = np.where(empty, I32_MIN, np.minimum(hi64, I32_MAX))
    anylive = live.any(0)
    return M, pay, np.where(anylive, lo, I32_MIN), np.where(anylive, hi,
                                                           I32_MAX)


def k7_exact(v, w, cost, c, cq):
    """The first version's slot loop for the (nb, W) columns c of the
    given blocks: (best, bpay), best INF where no slot reaches."""
    nb = cost.shape[0]
    best = np.full((nb, W), INF, np.int32)
    bpay = np.full((nb, W), 0x7FFFFFFF, np.int32)
    for s in range(v.shape[0]):
        vs = v[s][:, None]
        val = i32(i32(cost.astype(np.int64) + w[s])[:, None].astype(
            np.int64) + cq[c][None, :])
        pay = (c[None, :] << 25) | (vs & MASK25)
        t = (c >= 2)[None, :] & (c[None, :] <= (vs >> 25)) & (
            (val < best) | ((val == best) & (pay < bpay)))
        best, bpay = np.where(t, val, best), np.where(t, pay, bpay)
    return best, bpay


def k7_redesign_model(pd, cs, litq, copyq):
    """The redesigned K7 in numpy, all blocks at once: returns (paymat,
    the (B,) count of blocks whose step i ran the exact slot loop). F, P
    are indexed by ring slot j (column (j - i) mod W at step i), as the
    consumer's lanes hold them."""
    ns, n = pd.shape
    nb = n // B
    pd3, cs3 = pd.reshape(ns, nb, B), cs.reshape(ns, nb, B)
    lq = litq.reshape(nb, B)
    cq = copyq[:W].astype(np.int64)
    j = np.arange(W)
    F = np.full((nb, W), INF, np.int32)
    F[:, 0] = 0
    P = np.zeros((nb, W), np.int32)
    out = np.zeros((nb, B + 1), np.int32)
    slow = np.zeros(B, np.int64)
    for i in range(B):
        v, w = pd3[:, :, i], cs3[:, :, i]
        M, pay, lo, hi = k7_reduce(v, w, cq)
        c = (j - i) % W
        s0, s1 = i % W, (i + 1) % W
        cost = F[:, s0].copy()
        out[:, i] = P[:, s0]
        F[:, s0], P[:, s0] = INF, 0
        lv = i32(cost.astype(np.int64) + lq[:, i])
        take = lv < F[:, s1]
        F[take, s1], P[take, s1] = lv[take], 0
        ok = (cost >= lo) & (cost <= hi)
        val = i32(cost[:, None].astype(np.int64) + M[:, c])
        upd = ok[:, None] & (c >= 2)[None, :] & (pay[:, c] != 0) & (val < F)
        F, P = np.where(upd, val, F), np.where(upd, pay[:, c], P)
        bad = np.flatnonzero(~ok)
        if bad.size:
            slow[i] = bad.size
            best, bpay = k7_exact(v[:, bad], w[:, bad], cost[bad], c, cq)
            upd = (c >= 2)[None, :] & (best < F[bad])
            F[bad] = np.where(upd, best, F[bad])
            P[bad] = np.where(upd, bpay, P[bad])
    out[:, B] = P[:, B % W]
    return out, slow


def _v1_plain(pd, cs, litq, copyq):
    return O.dp_scan_v1_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (pd, cs, litq, copyq))).numpy()


@pytest.mark.parametrize("kind,nslots,sd", _V1_CASES)
def test_k7_redesign_model_seeded(kind, nslots, sd):
    pd, cs, litq, copyq = v1_case(kind, nslots, 2, sd)
    model, slow_at = k7_redesign_model(pd, cs, litq, copyq)
    _eq(model, _v1_plain(pd, cs, litq, copyq))
    slow = slow_at.sum()
    if kind in ("expensive", "cost wrap", "mixed"):
        assert slow > 0
    elif kind != "empty":
        assert slow == 0


def test_k7_cost_wrap_flips_mid_block():
    """In the "cost wrap" case the slots' sums cross 2**31 inside the
    block once cost_i passes 2**29: the steps start on the fast path,
    take the exact loop at the crossing, whose wrapped sums send the
    path's costs below 0, and leave it again after; the payloads follow
    the plain version's wrapped sums."""
    pd, cs, litq, copyq = v1_case("cost wrap", 28, 1, 7)
    model, slow_at = k7_redesign_model(pd, cs, litq, copyq)
    _eq(model, _v1_plain(pd, cs, litq, copyq))
    hit = np.flatnonzero(slow_at)
    assert 0 < hit.size < B
    assert hit[0] > 0 and not slow_at[hit[0]:].all()


@pytest.fixture(scope="module")
def real_arr():
    return np.frombuffer(build_corpus(1 << 20)[:REAL], np.uint8)


@pytest.fixture(scope="module")
def real_seed(real_arr):
    return O._seed_parse(real_arr, MAXD, 0)


@pytest.mark.parametrize("level3", [False, True])
def test_k7_redesign_model_real(real_arr, real_seed, level3):
    """A real 512 KiB v1 segment (28 slots, 38 with the 16-byte level):
    the model equals the plain version and takes no exact step."""
    cfg = O.DPConfig(mode="v1", level3=level3)
    lit, copyq, distq = O._cost_tables(real_arr, real_seed, lit_table=False,
                                       cfg=cfg)
    spos, slen, sdist = O._seg_seed_edges([real_seed], 0, REAL, REAL // 32)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    pd, cs, litq = O.edges_v1(
        torch.from_numpy(real_arr.copy()), REAL - 3, MAXD,
        torch.from_numpy(lit.reshape(-1)), torch.from_numpy(distq),
        t(spos), t(slen), t(sdist), levels=cfg.levels)
    assert pd.shape[0] == (38 if level3 else 28)
    args = (pd.numpy(), cs.numpy(), litq.numpy(), np.asarray(copyq))
    model, slow_at = k7_redesign_model(*args)
    plain = _v1_plain(*args)
    _eq(model, plain)
    assert slow_at.sum() == 0
    assert ((plain >> 25) >= 2).sum() > 10_000


# ---------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------

def k8_len(d, pos, ring):
    """Equal leading bytes of the 16 at pos and pos - ring (the
    segment read cyclically), 0 where ring <= 0 or pos - ring < 0."""
    n = d.shape[0]
    live = (ring > 0) & (pos - ring >= 0)
    k = np.arange(16)
    a = d[(pos[:, None] + k) % n]
    b = d[(np.maximum(pos - ring, 0)[:, None] + k) % n]
    diff = a != b
    first = np.where(diff.any(1), diff.argmax(1), 16)
    return np.where(live, first, 0)


def k8_cap(rl, pos, i, npos):
    """The caps: the block's end and max(npos + 3 - pos, 0)."""
    rl = np.minimum(rl, B - i)
    room = npos + 3 - pos
    return np.where(room < rl, np.maximum(room, 0), rl)


def k8_redesign_model(mp, litq, data, ring_init, ring_cost, copyq, icell,
                      npos):
    """The redesigned K8 in numpy, all blocks at once: returns (paymat,
    the count of steps whose ring the look-ahead did not cover and that
    compared bytes on the chain). F, P, R are indexed by ring slot."""
    n = mp.shape[0]
    nb = n // B
    mpv = mp.reshape(nb, B, 2 * W)
    lq = litq.reshape(nb, B)
    cap = icell[:W] if icell is not None else np.full(W, 1 << 28)
    rw = np.minimum(i32(int(ring_cost) + copyq[:W].astype(np.int64)), cap)
    base = np.arange(nb, dtype=np.int64) * B
    j = np.arange(W)
    F = np.full((nb, W), INF, np.int32)
    F[:, 0] = 0
    P = np.zeros((nb, W), np.int32)
    R = np.repeat(ring_init.astype(np.int32)[:, None], W, 1)
    out = np.zeros((nb, B + 1), np.int32)
    # the prologue: step 0's candidates are ring_init, both halves
    cand = np.repeat(ring_init.astype(np.int64)[:, None], 2, 1)
    slow = 0
    for i in range(B):
        s0, s1 = i % W, (i + 1) % W
        cost = F[:, s0].copy()
        ring = R[:, s0].astype(np.int64)
        r1 = R[:, s1].astype(np.int64)  # published: column 1's R
        out[:, i] = P[:, s0]
        pos = base + i
        # the two lengths of the compares queued a step ago, then the
        # next step's candidates, then the pick
        lens = np.stack([k8_len(data, pos, cand[:, q]) for q in range(2)], 1)
        da, db = cand[:, 0], cand[:, 1]
        cand = np.stack([r1, ring], 1)
        live = (ring > 0) & (pos - ring >= 0)
        from_a = ring == da
        from_b = ~from_a & (ring == db)
        other = live & ~from_a & ~from_b
        slow += int(other.sum())
        rl = np.where(from_a, lens[:, 0], np.where(
            from_b, lens[:, 1], k8_len(data, pos, ring)))
        rl = np.where(live, k8_cap(rl, pos, i, npos), 0)
        c = (j - i) % W
        lv = i32(cost.astype(np.int64) + lq[:, i])
        take = lv < F[:, s1]
        F[take, s1], P[take, s1] = lv[take], 0
        R[take, s1] = ring[take]
        rv = i32(cost[:, None].astype(np.int64) + rw[c][None, :])
        upd = (c >= 2)[None, :] & (c[None, :] <= rl[:, None]) & (rv < F)
        F = np.where(upd, rv, F)
        P = np.where(upd, (c[None, :] << 25) | ring[:, None], P)
        R = np.where(upd, ring[:, None], R)
        m, py = mpv[:, i, :W][:, c], mpv[:, i, W:][:, c]
        mv = i32(cost[:, None].astype(np.int64) + m)
        better = mv < F
        F, P = np.where(better, mv, F), np.where(better, py, P)
        R = np.where(better, py & MASK25, R)
        F[:, s0], P[:, s0], R[:, s0] = INF, 0, 0
    out[:, B] = P[:, B % W]
    return out, slow


def _ring_plain(mp, litq, data, ring_init, rc, copyq, icell, npos):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return O.dp_scan_ring_plain(
        t(mp), t(litq), t(data), t(ring_init),
        torch.tensor([rc], dtype=torch.int32), t(copyq),
        None if icell is None else t(icell), npos).numpy()


@pytest.mark.parametrize("kind,use_icell", RING_KINDS)
def test_k8_redesign_model_seeded(kind, use_icell):
    mp, litq, data, ring_init, rc, copyq, icell, npos = ring_case(kind, 3, 7)
    icell = icell if use_icell else None
    model, slow = k8_redesign_model(mp, litq, data, ring_init, rc, copyq,
                                    icell, npos)
    _eq(model, _ring_plain(mp, litq, data, ring_init, rc, copyq, icell,
                           npos))
    # only a row's payload at column 1 escapes the look-ahead
    assert (slow > 0) == (kind == "column 1")


@pytest.fixture(scope="module")
def real_v3(real_arr, real_seed):
    """K1's rows, literal costs and entry rings of a real 512 KiB v3
    segment, with its tables (implicit-cell row included)."""
    tables = O._cost_tables(real_arr, real_seed, lit_table=True,
                            cfg=O.DPConfig())
    dict_g = O._dict_probe_global(real_arr, [real_seed], 0, MAXD)
    bits_tab, ctx_tab, copyq, distq = O.device_tables(tables, "cpu")
    npos, *rest = O.segment_inputs(real_arr, [real_seed], dict_g, 0, REAL,
                                   REAL, "cpu")
    data = torch.from_numpy(real_arr.copy())
    pd, cs, litq, dist_fill = O.segment_tables(
        data, npos, MAXD, bits_tab, ctx_tab, distq, *rest, 0)
    mp = O.suffix_min(pd, cs, copyq)
    return (mp.numpy(), litq.numpy(), real_arr.copy(),
            dist_fill.view(-1, B)[:, 0].numpy().copy(), int(distq[0]),
            copyq.numpy(), tables[4].astype(np.int32), npos)


@pytest.mark.parametrize("use_icell", [False, True])
def test_k8_redesign_model_real(real_v3, use_icell):
    mp, litq, data, ring_init, rc, copyq, icell, npos = real_v3
    icell = icell if use_icell else None
    model, slow = k8_redesign_model(mp, litq, data, ring_init, rc, copyq,
                                    icell, npos)
    plain = _ring_plain(mp, litq, data, ring_init, rc, copyq, icell, npos)
    _eq(model, plain)
    assert slow == 0
    assert ((plain >> 25) >= 2).sum() > 10_000
