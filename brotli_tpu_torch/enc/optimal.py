"""Optimal-parse backward references (q10/q11) as a blocked, batched DP
(the host DP; copy of brotli_tpu.enc.optimal).

Role parity: c/enc/backward_references_hq.c (BrotliZopfliComputeShortestPath
+ ZopfliCostModel). The reference runs a serial shortest-path DP over one
8M-node graph; that shape is hostile to vector hardware, so this is a
re-design, not a translation:

  * the input is cut into fixed blocks of B bytes with hard parse
    boundaries (a match may not cross a block edge -- the loss is a few
    bits per boundary), which makes every block an independent DP;
  * all blocks advance in lock-step: the DP wavefront is a loop of B
    steps, each step a handful of vector ops over the block axis, so
    the serial depth is B instead of n;
  * cost/length/slot are packed into one integer per node so the
    argmin travels with the min for free.

Edge sets per position: NC nearest hash candidates (ordered by
distance, the zopfli-role exhaustive search), 4 distance-cache probes
and full-length seed edges from the previous parse, and a
static-dictionary word probe. Costs come from the previous parse's
histograms (literal bits are context-modeled, RFC 7932 7.1); every
edge is priced as it will actually emit -- ring-code savings are
opportunistic, realized by plan_commands when they line up.
"""

import numpy as np

from ..format import prefix
from . import static_dict
from .matcher import (HASH_MUL, MIN_MATCH, hash4, _extend_capped,
                      _tz_bytes)

CAPQ = 32          # candidate/cache edge-length cap
NCACHE = 4         # ring-cache probes (slots of the previous parse)
# DP discounts (bits) on ring edges: 0 measured best -- pricing ring
# edges below their explicit-symbol cost chases short codes the
# emission ring cannot realize (the cache belongs to the PREVIOUS
# parse; +13% size at full short-code optimism, +0.7% at 3 bits)
CACHE_DISC_RING = 0.0
CACHE_DISC_NEAR = 0.0
B = 8192           # DP block size (hard parse boundary)
QB = 16            # cost quantization: 1/16 bit
CMD_BASE_Q = 1 * QB  # floor cost per command beyond modeled parts
MAX_EDGE = 2047    # packed-length field limit (backtrack payload)
# copy-length stops relaxed per edge besides the full length: any
# prefix of a match is itself a match, and stopping early lets the
# parse land exactly on a later match start (all-lengths relaxation of
# the zopfli DP, reduced to a geometric stop set)
_TRUNC_STOPS = (MAX_EDGE, 4, 6, 9, 14, 22)


def _w8(data: np.ndarray) -> np.ndarray:
    n = len(data)
    w8 = np.zeros(n, np.uint64)
    for i in range(8):
        w8[:n - i] |= data[i:].astype(np.uint64) << np.uint64(8 * i)
    return w8


def _capped_len(w8, pos, cand, valid, cap=None):
    """Common-prefix length (<= cap) of data[pos:] vs data[cand:]."""
    cap = CAPQ if cap is None else cap
    n = len(w8)
    mlen = np.zeros(len(pos), np.int32)
    alive = valid.copy()
    c = np.where(valid, cand, 0)
    for r in range(0, cap, 8):
        p_r = np.minimum(pos + r, n - 1)
        c_r = np.minimum(c + r, n - 1)
        x = w8[p_r] ^ w8[c_r]
        tz = _tz_bytes(x)
        mlen += np.where(alive, tz, 0)
        alive &= x == 0
    return np.minimum(mlen, cap)


# hierarchical candidate levels: (prefix bytes, slots, length cap).
# Common 4-grams flood a single-hash nearest-k list and hide long
# matches farther back; longer-prefix levels guarantee any length-P
# match is dominated by a level-P candidate unless > k same-prefix
# occurrences intervene (the binary-tree hasher's longest-match role,
# c/enc/hash_to_binary_tree_inc.h, as sorted batch lookups). Slot
# count None = the caller's nc.
_CAND_LEVELS = ((4, None, 16), (8, 12, 48), (16, 6, 192))
_MUL1 = np.uint64(0x9E3779B97F4A7C15)
_MUL2 = np.uint64(0xC2B2AE3D27D4EB4F)


def candidates_topk(data: np.ndarray, max_distance: int, nc: int):
    """Per-position nearest same-prefix prior occurrences, tiered by
    prefix length (see _CAND_LEVELS).

    Returns (cand_len int32[S, n], cand_dist int64[S, n]); within a
    level, slot k is the (k+1)-nearest, so distances grow with k and
    any prefix length is realizable at the smallest listed distance
    that covers it.
    """
    n = len(data)
    nslots = sum(nc if k is None else k for _, k, _ in _CAND_LEVELS)
    cand_len = np.zeros((nslots, n), np.int32)
    cand_dist = np.zeros((nslots, n), np.int64)
    if n < 24:
        return cand_len, cand_dist
    w8 = _w8(data)
    row = 0
    for plen, k, cap in _CAND_LEVELS:
        k = nc if k is None else k
        npos = n - (plen - 1) - 1
        if npos <= 0:
            row += k
            continue
        if plen == 4:
            h = hash4(data, 18)[:npos]
        elif plen == 8:
            h = ((w8[:npos] * _MUL1) >> np.uint64(44)).astype(np.int64)
        else:
            h = (((w8[:npos] * _MUL1) ^ (w8[8:npos + 8] * _MUL2))
                 >> np.uint64(44)).astype(np.int64)
        order = np.argsort(h, kind="stable").astype(np.int64)
        h_s = h[order]
        pos_idx = np.arange(npos, dtype=np.int64)
        for j in range(1, k + 1):
            cand = np.full(npos, -1, np.int64)
            same = h_s[j:] == h_s[:-j]
            cand[order[j:]] = np.where(same, order[:-j], -1)
            dist = pos_idx - cand
            valid = (cand >= 0) & (dist <= max_distance)
            mlen = _capped_len(w8, pos_idx, cand, valid, cap)
            mlen = np.minimum(mlen, (n - pos_idx).astype(np.int32))
            cand_len[row, :npos] = np.where(valid, mlen, 0)
            cand_dist[row, :npos] = np.where(valid, dist, 0)
            row += 1
    return cand_len, cand_dist


def cache_probes(data: np.ndarray, cache_dist: np.ndarray):
    """Match lengths at the previous parse's ring distances.

    cache_dist: int64[k, n] per-position candidate distances (0 = none).
    Returns int32[k, n] capped lengths."""
    n = len(data)
    w8 = _w8(data)
    pos = np.arange(n, dtype=np.int64)
    out = np.zeros(cache_dist.shape, np.int32)
    for s in range(cache_dist.shape[0]):
        d = cache_dist[s]
        valid = (d > 0) & (d <= pos)
        mlen = _capped_len(w8, pos, pos - d, valid)
        out[s] = np.minimum(np.where(valid, mlen, 0),
                            (n - pos).astype(np.int32))
    return out


def _ring_history(m, dists, flags, n):
    """Per-position last-4 pushed distances of a given parse.

    Mirrors the decoder ring: dictionary words never push; consecutive
    equal distances collapse (a reuse emits dist code 0, no push)."""
    cache = np.zeros((4, n), np.int64)
    push = flags < 2
    pm, pd = m[push], dists[push]
    if len(pm) == 0:
        return cache
    keep = np.concatenate([[True], pd[1:] != pd[:-1]])
    pm, pd = pm[keep], pd[keep]
    # ring visible at position p: pushes with match pos strictly < p
    # (a match's own distance enters the ring only after its command)
    idx = np.searchsorted(pm, np.arange(n), side="left") - 1
    for s in range(4):
        j = idx - s
        cache[s] = np.where(j >= 0, pd[np.maximum(j, 0)], 0)
    return cache


def _dist_sym_extra(dists: np.ndarray):
    """(dist code >= 16, extra bits) for explicit distances
    (npostfix = ndirect = 0)."""
    d = dists.astype(np.int64) - 1
    # bit_length((d+4)>>2) via the float exponent (exact: values fit
    # a double's 53-bit mantissa)
    nbits = np.frexp(((d + 4) >> 2).astype(np.float64))[1].astype(
        np.int64)
    half = ((d + 4 - (np.int64(1) << (nbits + 1))) >> nbits) & 1
    return 16 + (((nbits - 1) << 1) | half), nbits


class CostModel:
    """Quantized bit costs from a previous parse (ZopfliCostModel role)."""

    def __init__(self, data, m, lens, dists, flags, context_mode=None):
        n = len(data)
        covered = np.zeros(n + 1, np.int64)
        np.add.at(covered, np.minimum(m, n), 1)
        np.add.at(covered, np.minimum(m + lens, n), -1)
        is_lit = np.cumsum(covered[:n]) == 0
        # literal bits, 2nd-order context modeled (UTF8 mode)
        from ..format import context as ctx
        lut = ctx.context_lut(2 if context_mode is None else context_mode)
        p1 = np.concatenate([[0], data[:-1]]).astype(np.int64)
        p2 = np.concatenate([[0, 0], data[:-2]]).astype(np.int64)
        cid = (lut[0][p1] | lut[1][p2]).astype(np.int64)
        hist = np.zeros((64, 256), np.int64)
        np.add.at(hist, (cid[is_lit], data[is_lit].astype(np.int64)), 1)
        hist += 1
        bits = -np.log2(hist / hist.sum(axis=1, keepdims=True))
        self.litq = np.minimum(
            (bits[cid, data.astype(np.int64)] * QB), 24 * QB
        ).astype(np.int64)
        # blend in the windowed position-in-UTF8-codepoint model
        # (literal_cost.c role): the global context model misses local
        # statistic shifts; the average of the two guides the parse
        # best on text (measured; binary inputs skip the blend)
        from .literal_cost import estimate_literal_bits, is_mostly_utf8
        if is_mostly_utf8(data):
            u = estimate_literal_bits(np.asarray(data))
            uq = np.minimum(u * QB, 24 * QB).astype(np.int64)
            self.litq = (self.litq + uq) // 2

        # per-copy-code command cost: marginal copy-code bits plus the
        # measured insert-side share of the joint command symbol (joint
        # entropy minus copy-marginal entropy over this parse's actual
        # commands). An exact insert-run-aware joint table was tried
        # and measured WORSE realized sizes (+3.5% on plrabn12): the
        # writer's block splitting and clustering reward parses the
        # joint model penalizes, so the flat insert share calibrates
        # better against what actually emits.
        from . import bitstream
        ccode, _, cbits = bitstream._encode_values(
            np.maximum(lens, 2), prefix.COPY_BASE, prefix.COPY_EXTRA)
        cc_hist = np.bincount(ccode, minlength=24).astype(np.float64) + 0.2
        cc_p = cc_hist / cc_hist.sum()
        jh = np.zeros((24, 24), np.float64)
        if len(m) > 16:
            prev_end = np.concatenate([[0], (m + lens)[:-1]])
            ins_lens = np.maximum(m - prev_end, 0)
            icode, _, _ = bitstream._encode_values(
                ins_lens, prefix.INSERT_BASE, prefix.INSERT_EXTRA)
            np.add.at(jh, (icode, ccode), 1.0)
        ic_hist = jh.sum(axis=1) + 0.2
        ic_p = ic_hist / ic_hist.sum()
        jp = (jh + 8.0 * np.outer(ic_p, cc_p)) / (jh.sum() + 8.0)
        joint_bits = -np.log2(jp)
        self.cc_bits = -np.log2(cc_p) + float(
            (joint_bits * jp).sum() - -(cc_p * np.log2(cc_p)).sum())
        # command cost per copy code, extras + per-command floor
        # included (indexed by the code of the possibly-truncated edge)
        self.cq = ((self.cc_bits + np.asarray(prefix.COPY_EXTRA)) *
                   QB).astype(np.int64) + CMD_BASE_Q
        self.copyq = self.copy_cost_q(np.arange(CAPQ + 1))
        self.copyq[:2] = 1 << 30

        # distance-symbol cost from this parse's ACTUAL emission (ring
        # codes included): replay the parse through plan_commands so
        # short codes 0-15 carry learned costs, which lets the DP see
        # ring-cache edges as the bargains they are (ZopfliCostModel
        # role, backward_references_hq.c)
        from .matcher import matches_to_commands
        from . import bitstream
        if len(m):
            cmds = matches_to_commands(m, lens, dists, flags, 0, n)
            plan, _ = bitstream.plan_commands(*cmds[:3], None, cmds[3])
            dsym = plan["dist_syms"][plan["has_dist"]]
            dh = np.bincount(dsym, minlength=64).astype(np.float64)
        else:
            dh = np.zeros(64, np.float64)
        dh += 0.2
        self.dist_sym_bits = -np.log2(dh / dh.sum())

    def dist_cost_q(self, dists: np.ndarray) -> np.ndarray:
        dsym, nbits = _dist_sym_extra(np.maximum(dists, 1))
        return ((self.dist_sym_bits[np.minimum(dsym, 63)] + nbits) *
                QB).astype(np.int64)

    def copy_cost_q(self, lens: np.ndarray) -> np.ndarray:
        """Command-symbol + copy-extra bit cost for copy lengths."""
        lcode = np.searchsorted(prefix.COPY_BASE,
                                np.maximum(lens, 2), side="right") - 1
        return ((self.cc_bits[lcode] + prefix.COPY_EXTRA[lcode]) *
                QB).astype(np.int64)


def _blocked_dp(n, litq, edge_len, edge_cost_q, edge_atomic,
                edge_ccode, cq):
    """Lock-step DP over ceil(n/B) independent blocks.

    edge_len: int32[nslots, n], edge_cost_q: int64[nslots, n] (distance
    cost of the edge; the command-symbol part is added per relaxed
    length from `cq`), edge_atomic: bool[nslots] (edge may not be
    truncated), edge_ccode: int64[nslots, n] copy code override for
    atomic (dictionary) edges whose emitted code differs from the
    output span, cq: int64[24] command cost per copy code (symbol +
    copy extras + floor).

    Besides the full edge, each edge is re-relaxed at the truncation
    stops in _TRUNC_STOPS -- any prefix of a match is a valid match,
    and stopping early lets the parse land exactly on a later match
    start (the all-lengths relaxation of the reference zopfli DP,
    c/enc/backward_references_hq.c UpdateNodes, reduced to a geometric
    stop set). Returns packed int64[nb, B+1]: (len << 7) | slot.
    """
    nslots = edge_len.shape[0]
    assert nslots <= 128 and MAX_EDGE < (1 << 11)
    nb = (n + B - 1) // B
    npad = nb * B
    assert edge_len.shape[1] == npad, "edge arrays must be pre-padded"
    litp = np.full(npad, 1 << 20, np.int64)
    litp[:n] = litq[:n]
    litp = litp.reshape(nb, B)
    # pre-padded views (pad region has edge_len 0 -> never relaxed)
    elen, ecost, eccode = edge_len, edge_cost_q, edge_ccode
    # copy length -> copy code LUT (lengths clamp at the table top)
    ccode_lut = (np.searchsorted(
        prefix.COPY_BASE, np.arange(MAX_EDGE + 1, dtype=np.int64),
        side="right") - 1).astype(np.int64)
    ccode_lut[0] = ccode_lut[1] = 0
    INF = np.int64(1) << 62
    # node value: (cost << 18) | (len << 7) | slot ; literal step has
    # len 0 (slot unused)
    val = np.full((nb, B + 1), INF, np.int64)
    val[:, 0] = 0
    valf = val.ravel()
    bidx = np.arange(nb, dtype=np.int64)
    slot_id = np.arange(nslots, dtype=np.int64)[:, None]
    row_base = (bidx * (B + 1))[None, :]
    atom = edge_atomic[:, None]
    for i in range(B):
        cur = val[:, i]
        cost = cur >> 18
        reachable = cur < INF
        # literal edge
        lv = ((cost + litp[:, i]) << 18)
        val[:, i + 1] = np.minimum(val[:, i + 1],
                                   np.where(reachable, lv, INF))
        gpos = bidx * B + i
        lim = B - i
        L = elen[:, gpos].astype(np.int64)           # (nslots, nb)
        L = np.where(atom & (L > lim), 0, np.minimum(L, lim))
        base = cost[None, :] + ecost[:, gpos]
        # relax the full edge plus truncated stops: a shorter copy of
        # the same match is valid and lets the parse land exactly on a
        # later match start (the all-lengths relaxation of the
        # reference zopfli DP, reduced to a geometric stop set)
        for t in _TRUNC_STOPS:
            l = np.minimum(L, t)
            ok = reachable[None, :] & (l >= 2)
            if t is not _TRUNC_STOPS[0]:
                # only re-relax when actually shorter than full
                ok &= (L > t) & ~atom
            if not ok.any():
                continue
            # dictionary rows: the copy CODE is the base word length
            # (carried in edge_ccode), not the transformed output span
            if t is _TRUNC_STOPS[0]:
                cc = np.where(atom, eccode[:, gpos], ccode_lut[l])
            else:
                cc = ccode_lut[l]
            cmdq = cq[cc]
            tgt = i + np.where(ok, l, 1)
            v = np.where(ok,
                         ((base + cmdq) << 18) | (l << 7) | slot_id,
                         INF)
            np.minimum.at(valf, row_base + tgt, v)
    return val


def _backtrack(val, n):
    """Walk each block's best path backward; returns global (pos, len,
    slot) arrays of the chosen match edges, position-sorted."""
    nb = val.shape[0]
    pos = np.full(nb, B, np.int64)
    # final (ragged) block: end at its true length
    last_end = n - (nb - 1) * B
    pos[-1] = last_end
    out_pos, out_len, out_slot = [], [], []
    bidx = np.arange(nb)
    active = pos > 0
    while active.any():
        v = val[bidx, np.maximum(pos, 0)]
        ln = (v >> 7) & 0x7FF
        slot = v & 0x7F
        is_match = active & (ln >= 2)
        step = np.where(active, np.where(is_match, ln, 1), 0)
        src = pos - step
        if is_match.any():
            out_pos.append((bidx[is_match] * B + src[is_match]))
            out_len.append(ln[is_match])
            out_slot.append(slot[is_match])
        pos = src
        active = pos > 0
    if not out_pos:
        z = np.zeros(0, np.int64)
        return z, z, z
    p = np.concatenate(out_pos)
    order = np.argsort(p, kind="stable")
    return (p[order], np.concatenate(out_len)[order],
            np.concatenate(out_slot)[order])


def _coalesce(m, lens, dists, flags):
    """Merge adjacent same-distance LZ copies (chunked long matches)
    back into single commands."""
    if len(m) < 2:
        return m, lens, dists, flags
    join = (m[1:] == m[:-1] + lens[:-1]) & (dists[1:] == dists[:-1]) & \
        (flags[1:] == 0) & (flags[:-1] == 0)
    # group id per run of joined matches
    grp = np.concatenate([[0], np.cumsum(~join)])
    ngrp = int(grp[-1]) + 1
    first = np.zeros(ngrp, np.int64)
    first[grp[::-1]] = np.arange(len(m))[::-1]  # first member per group
    nl = np.zeros(ngrp, np.int64)
    np.add.at(nl, grp, lens)
    return m[first], nl, dists[first], flags[first]


def bridge_matches(data, m, lens, dists, flags, max_gap=32):
    """Merge [copy@d][g-byte literal gap][copy@d] into one copy when
    the gap bytes also match at distance d (verified byte-for-byte).

    The DP chunks long matches into <=W-1 edges; when the chunk grid
    does not divide the span, its model prefers a 1-byte literal over
    an extra modeled command (the chunks coalesce into ONE command at
    emission, so the extra chunk is free in reality but not in the
    model). On repeat-heavy data that leaves a 1-byte hole every ~4 KB
    which breaks the giant command apart: measured 1,120 one-byte gaps
    = ~8 KB of the round-2 gap vs the reference on the 16 MB corpus.
    Bridging is exact -- strictly fewer commands and literals, same
    distances (reference counterpart: zopfli's cost model with the
    distance cache never splits these, backward_references_hq.c)."""
    if len(m) < 2:
        return m, lens, dists, flags
    e = m[:-1] + lens[:-1]
    g = m[1:] - e
    d = dists[:-1]
    ok = (dists[1:] == d) & (d > 0) & (flags[:-1] == 0) & \
        (flags[1:] == 0) & (g > 0) & (g <= max_gap)
    if ok.any():
        for off in range(int(g[ok].max())):
            act = np.flatnonzero(ok & (g > off))
            if act.size == 0:
                break
            idx = (e[act] + off).astype(np.int64)
            src = idx - d[act]
            bad = (src < 0) | (data[idx] != data[np.maximum(src, 0)])
            ok[act[bad]] = False
        lens = lens.copy()
        lens[:-1][ok] += g[ok]  # absorb the gap; _coalesce fuses runs
    return _coalesce(m, lens, dists, flags)


def find_matches_optimal(data: np.ndarray, max_distance: int,
                         base: int = 0, iterations: int = 1,
                         nc: int = 32, seed=None):
    """q10/q11 parse: blocked DP over `nc` candidates. Returns (m,
    lens, dists, flags) like the other matchers."""
    n = len(data)
    z = np.zeros(0, np.int64)
    if n < 16:
        return z, z, z, z
    from .matcher import find_matches_vectorized
    if seed is None:
        seed = find_matches_vectorized(data, max_distance,
                                       num_candidates=4, use_dict=True,
                                       base=base)
    m, lens, dists, flags = seed
    cand_len, cand_dist = candidates_topk(data, max_distance, nc)
    ncs = cand_len.shape[0]
    SLOT_CACHE = ncs
    SLOT_DICT, SLOT_SEED = ncs + NCACHE, ncs + NCACHE + 1
    nslots = ncs + NCACHE + 2
    # static-dictionary probe at every position (vectorized)
    pos_all = np.arange(max(n - MIN_MATCH, 0), dtype=np.int64)
    dlen, dwlen, didx, dtr = static_dict.probe(data, pos_all)
    ddist = static_dict.dict_distance(pos_all + base, dwlen, didx,
                                      max_distance, dtr)
    dict_len = np.zeros(n, np.int32)
    dict_dist = np.zeros(n, np.int64)
    dict_wlen = np.zeros(n, np.int64)
    dict_len[:len(pos_all)] = np.where(dlen >= 4, dlen, 0).astype(
        np.int32)
    dict_dist[:len(pos_all)] = ddist
    dict_wlen[:len(pos_all)] = dwlen

    seed_len = np.zeros(n, np.int32)
    seed_dist = np.zeros(n, np.int64)
    for it in range(iterations):
        cm = CostModel(data, m, lens, dists, flags)
        ring4 = _ring_history(m, dists, flags, n)
        # short-code probe set: ring slots 0-3 (codes 0-3) and
        # ring-top +/- 1..3 (codes 4-9), all extra-bit-free
        cache_dist = np.zeros((NCACHE, n), np.int64)
        cache_dist[:4] = ring4
        for s, off in enumerate((-1, 1, -2, 2, -3, 3), start=4):
            if s >= NCACHE:
                break
            cache_dist[s] = np.where(ring4[0] > 0, ring4[0] + off, 0)
        cache_len = cache_probes(data, cache_dist)

        def _ccode(lens_):
            return (np.searchsorted(prefix.COPY_BASE,
                                    np.maximum(lens_, 2),
                                    side="right") - 1).astype(np.int64)

        # edge costs carry the DISTANCE side only; the command-symbol
        # cost is added per relaxed length inside the DP. Arrays are
        # pre-padded to the DP's block grid (int32/uint8: these are
        # the big allocations) -- pad region keeps edge_len 0.
        nb_ = (n + B - 1) // B
        npad_ = nb_ * B
        edge_len = np.zeros((nslots, npad_), np.int32)
        edge_cost = np.zeros((nslots, npad_), np.int32)
        edge_ccode = np.zeros((nslots, npad_), np.uint8)
        for k in range(ncs):
            el = np.minimum(cand_len[k], MAX_EDGE)
            edge_len[k, :n] = el
            edge_ccode[k, :n] = _ccode(el)
            edge_cost[k, :n] = cm.dist_cost_q(cand_dist[k])
        for s in range(NCACHE):
            el = np.minimum(cache_len[s], CAPQ)
            edge_len[SLOT_CACHE + s, :n] = el
            edge_ccode[SLOT_CACHE + s, :n] = _ccode(el)
            # a ring edge realizes short code s only when the emission
            # ring (simulated exactly by plan_commands) lines up, and
            # this parse's ring will differ from the previous parse's
            # that produced cache_dist -- so price as the explicit
            # symbol with a bounded short-code discount, not at the
            # full learned short-code cost (phantom-ring optimism
            # measured +13% size on text)
            expl = cm.dist_cost_q(np.maximum(cache_dist[s], 1))
            disc = int((CACHE_DISC_RING if s < 4 else CACHE_DISC_NEAR)
                       * QB)
            edge_cost[SLOT_CACHE + s, :n] = np.maximum(expl - disc,
                                                         QB)
        # edge length = transformed OUTPUT length (prefix/suffix forms
        # may exceed the base word length); the copy CODE spans the
        # base word length, so that is what the command-symbol costs
        edge_len[SLOT_DICT, :n] = np.minimum(dict_len, MAX_EDGE)
        edge_ccode[SLOT_DICT, :n] = _ccode(dict_wlen)
        edge_cost[SLOT_DICT, :n] = cm.dist_cost_q(
            np.maximum(dict_dist, 1))
        # previous parses' LZ matches at full length (up to the packing
        # limit): the honest way long matches enter the DP -- candidate
        # and cache edges are length-capped. Accumulated across
        # iterations so a later parse never loses an earlier option.
        lz = flags < 2
        keep_new = np.minimum(lens[lz], MAX_EDGE) > seed_len[m[lz]]
        upd = m[lz][keep_new]
        seed_len[upd] = np.minimum(lens[lz][keep_new],
                                   MAX_EDGE).astype(np.int32)
        seed_dist[upd] = dists[lz][keep_new]
        edge_len[SLOT_SEED, :n] = seed_len
        edge_ccode[SLOT_SEED, :n] = _ccode(seed_len)
        edge_cost[SLOT_SEED, :n] = cm.dist_cost_q(
            np.maximum(seed_dist, 1))
        atomic = np.zeros(nslots, bool)
        atomic[SLOT_DICT] = True

        val = _blocked_dp(n, cm.litq, edge_len, edge_cost, atomic,
                          edge_ccode, cm.cq)
        p, ln, slot = _backtrack(val, n)

        # resolve slot -> distance/flag
        d = np.zeros(len(p), np.int64)
        f = np.zeros(len(p), np.int64)
        for k in range(ncs):
            sel = slot == k
            d[sel] = cand_dist[k, p[sel]]
        for s in range(NCACHE):
            sel = slot == SLOT_CACHE + s
            d[sel] = cache_dist[s, p[sel]]
        sel = slot == SLOT_DICT
        d[sel] = dict_dist[p[sel]]
        f[sel] = 2000 + dict_wlen[p[sel]]
        sel = slot == SLOT_SEED
        d[sel] = seed_dist[p[sel]]
        m, lens, dists, flags = bridge_matches(data, *_coalesce(
            p, ln, d, f))
    return m, lens, dists, flags
