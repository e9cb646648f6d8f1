"""Device optimal-parse DP (q10/q11), the PyTorch/CUDA counterpart of
brotli_tpu.ops.optimal_jax.

Two pipelines, chosen by `DPConfig.mode`:

v3 (the default), per segment of the input (4 MiB by default, padded to
a 2 or 4 MiB bucket):

  1. candidate edges by tiered sort-carry (`segment_tables`): the k
     nearest prior occurrences sharing a 4- or 8-byte prefix (and a
     16-byte one with `level3`) and their capped match lengths, per
     level a sort key (K9, csrc/edge_keys.cu), a stable torch.sort and
     the ranks (K10, csrc/edge_ranks.cu, whole 64-byte rows a level),
     then K10's row pass into one table; then the slot tables (K11,
     csrc/edge_slots.cu): those candidates, continuation edges inside
     the seed parse's long matches and an atomic static-dictionary
     slot, and the literal costs;
  2. the suffix-min pre-reduction (K1, csrc/suffix_min.cu): the 29 (39
     with `level3`) edge slots collapse into a dense per-position
     (cost, payload) row over the W window columns;
  3. the wavefront scan (K3, csrc/dp_scan.cu): per DP block of B
     positions, 4096 dependent relaxation steps over a W-column window;
     with `ring_scan`, K8 (csrc/dp_scan_ring.cu) instead, which also
     carries the path's last distance and prices one edge at it a step;
  4. the backtrack (K4, csrc/dp_backtrack.cu) and a stable sort that
     compacts the chosen match starts.

v1, per 2 MiB segment: the same edges (K9-K11) without the dictionary
slot, a literal cost from a (p1, byte) table, and the all-slots
wavefront (K7, csrc/dp_scan_v1.cu), whose every step reduces all the
slots itself; then K4 and the compaction.

Every kernel has a plain PyTorch version here with the same contract;
its wrapper runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card. All arithmetic is int32 (int64 where
the JAX code used uint32 lanes, see utils/u32.py), so both are bit
equal to the JAX package.

The host side -- the native seed parse, cost tables, dictionary probe,
segment prep, collect and span emission -- is copied from
optimal_jax.py; its environment variables are the fields of DPConfig.
"""

import concurrent.futures as futures
import dataclasses

import numpy as np
import torch

from .. import native
from ..enc import bitstream
from ..enc.matcher import (add_dictionary_matches, matches_to_commands,
                           split_matches_at)
from ..enc.optimal import CMD_BASE_Q, QB, _coalesce, bridge_matches
from ..format import constants as C
from ..format import context as ctx
from ..format import prefix
from ..utils import fetch, trace, u32
from ..utils.device import resolve
from . import kernels

HASH_MUL = 0x1E35A7BD
HASH_MUL2 = 0x9E3779B1
HASH_MUL3 = 0x85EBCA77
HASH_MUL4 = 0xC2B2AE3D
CAPD = 32         # candidate match-length cap (8 carried words)
W = 64            # DP window: max edge length W-1
B = 4096          # DP block size (hard parse boundary)
# hierarchical candidate levels (prefix bytes, occurrence ranks)
LEVELS = (
    (4, tuple(range(1, 13)) + (16,)),
    (8, tuple(range(1, 9)) + (16, 32, 64, 128, 256, 512)),
)
# the 16-byte level that DPConfig.level3 adds
LEVEL3 = (16, (1, 2, 3, 4, 8, 16, 32, 64, 128, 256))
SEG_V3 = 1 << 22          # v3 segment size
BUCKETS_V3 = [1 << 21, 1 << 22]
CAPM_DIV = 8              # batched-collect match cap = bucket // 8
SEG = 1 << 21             # v1 segment size
BUCKETS = [1 << 21]

EDGE_INF = 1 << 28        # no edge in a slot (K1's INF)
NO_EDGE = 1 << 29         # no edge reaches a window column
SCAN_INF = 1 << 30        # unreached window cell (K3's INF)
BIGD = 0x7FFFFFFF         # K1's "no payload" marker
MASK25 = (1 << 25) - 1


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """The DP's variant and its cost-model knobs. Each field takes the
    place of one environment variable of the JAX package (which the port
    never reads); the defaults are the port's default bytes.

    mode           BROTLI_TPU_DP: "v3" (suffix-min pre-reduction, K1 +
                   K3) or "v1" (the all-slots wavefront, K7)
    ring_scan      BROTLI_TPU_RING_SCAN=1: v3 prices an edge at the
                   path's last distance in the scan (K8 instead of K3)
    icell          BROTLI_TPU_ICELL=1: that edge's price is also capped
                   by the implicit-distance cell row (needs ring_scan)
    level3         BROTLI_TPU_LEVEL3=1: a third, 16-byte candidate level
    iterations     BROTLI_TPU_DP_ITERS: DP passes, each later one priced
                   and seeded by the one before (v1 streaming runs one)
    fast_first     BROTLI_TPU_FAST_FIRST: dispatch the first v3 segment
                   from a seed parse of its own window (acts for v3 with
                   one iteration on a stream's first bytes beyond one
                   segment)
    cost_sample    BROTLI_TPU_COST_SAMPLE: bytes of the seed parse the
                   cost tables are counted on
    lit_surcharge  BROTLI_TPU_LIT_SURCHARGE: literal cost factor
    ins_scale      BROTLI_TPU_INS_SCALE: insert-length share factor
    cmd_extra      BROTLI_TPU_CMD_EXTRA: factor of a command's base cost
    seed_q         BROTLI_TPU_SEED_Q: quality of the native seed parse

    A field that would change nothing raises ValueError, where the JAX
    package ignores its variable: ring_scan or icell with v1, icell
    without ring_scan, iterations below 1."""
    mode: str = "v3"
    ring_scan: bool = False
    icell: bool = False
    level3: bool = False
    iterations: int = 1
    fast_first: bool = True
    cost_sample: int = 1 << 22
    lit_surcharge: float = 1.1
    ins_scale: float = 1.0
    cmd_extra: float = 1.0
    seed_q: int = 9

    def __post_init__(self):
        if self.mode not in ("v1", "v3"):
            raise ValueError(f"DPConfig.mode must be 'v1' or 'v3', not "
                             f"{self.mode!r}")
        if self.mode == "v1" and (self.ring_scan or self.icell):
            raise ValueError("DPConfig: ring_scan and icell are v3 only")
        if self.icell and not self.ring_scan:
            raise ValueError("DPConfig: icell prices the ring edge, which "
                             "needs ring_scan")
        if self.iterations < 1:
            raise ValueError("DPConfig.iterations must be at least 1")

    @property
    def levels(self):
        return LEVELS + (LEVEL3,) if self.level3 else LEVELS


def _bucket_in(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _bucket_v3(n: int) -> int:
    return _bucket_in(n, BUCKETS_V3)


# ---------------------------------------------------------------------
# device side: edges
# ---------------------------------------------------------------------

def _shift_up(x, k, fill):
    return torch.cat([torch.full((k,), fill, dtype=x.dtype,
                                 device=x.device), x[:-k]])


def _tz_bytes_u32(x):
    b0 = (x & 0xFF) == 0
    b1 = (x & 0xFFFF) == 0
    b2 = (x & 0xFFFFFF) == 0
    b3 = x == 0
    return (b0.to(torch.int64) + b1.to(torch.int64) + b2.to(torch.int64)
            + b3.to(torch.int64))


def _dist_cost_q(dist, dist_sym_bits_q):
    """Quantized explicit-distance cost: symbol bits + extra bits
    (npostfix = ndirect = 0)."""
    d = torch.clamp(dist.to(torch.int64), min=1) - 1
    v = (d + 4) >> 2
    nbits = u32.bit_length(v | 1)
    half = ((d + 4 - (torch.full_like(nbits, 2) << nbits)) >> nbits) & 1
    sym = torch.clamp(16 + (((nbits - 1) << 1) | half), 0, 63)
    return dist_sym_bits_q[sym].to(torch.int64) + nbits * QB


def _words(data, nwords=CAPD // 4):
    """The first `nwords` 32-bit words of the 32 bytes at every position,
    little-endian, the segment's bytes read cyclically (torch.roll wraps
    at the segment end like jnp.roll; the npos + 3 guard of the ranks
    relies on that wrap). int64 lanes holding uint32 values."""
    d = data.to(torch.int64)
    w0 = (d | (torch.roll(d, -1) << 8) | (torch.roll(d, -2) << 16) |
          (torch.roll(d, -3) << 24))
    return [w0] + [torch.roll(w0, -4 * r) for r in range(1, nwords)]


def edge_keys_plain(data, npos, plen):
    """K9, plain version of the key lines of optimal_jax._level_candidates
    with the hashes of _edges_slots: the int32 (n,) sort key of every
    position for the level of `plen` prefix bytes (4, 8 or 16), the JAX
    package's uint32 key minus 2**31 (its bit 31 flipped), so that
    signed int32 order is the uint32 order and a stable torch.sort gives
    lax.sort's permutation. The JAX key is hval << 14 | pos >> 9 below
    the level's `npos` (the segment's npos - (plen - 4), at least 0,
    which the caller passes) and 1 << 31 | pos from there; hval is the
    level's 17-bit hash of the first plen cyclic bytes. Live rows are
    thus negative, padding rows not."""
    w = _words(data, plen // 4)
    if plen == 4:
        hval = u32.shr(u32.mul(w[0], HASH_MUL), 15)
    elif plen == 8:
        hval = u32.shr(u32.mul(w[0], HASH_MUL) ^ u32.mul(w[1], HASH_MUL2),
                       15)
    else:
        hval = u32.shr(u32.mul(w[0], HASH_MUL) ^ u32.mul(w[1], HASH_MUL2) ^
                       u32.mul(w[2], HASH_MUL3) ^ u32.mul(w[3], HASH_MUL4),
                       15)
    pos = torch.arange(data.shape[0], dtype=torch.int64, device=data.device)
    key = torch.where(pos < npos, (hval << 14) | (pos >> 9),
                      (1 << 31) | pos)
    return (key - (1 << 31)).to(torch.int32)


def edge_ranks_plain(key_s, order, data, npos, max_distance, ranks):
    """K10, plain version of the rank loop of optimal_jax._level_candidates
    and its sort back to position order. key_s, order: the stable sort
    of K9's int32 keys and its int64 order (only a stable sort gives the
    JAX package's rank-k neighbours, the key not being unique). For
    sorted row i and rank k, the candidate is row i - k when both share
    the hash (key >> 14, arithmetic: the JAX hash minus 2**17; padding
    rows are not negative, and rows before the head take _shift_up's
    fill of 2**17, above every int32 key >> 14, so neither ever
    matches), the row is live (key < 0), and 0 < dist <= max_distance;
    its length is the common prefix of the 32 cyclic bytes at both
    positions, capped at the level's npos + 3 - pos and dropped below 2.
    Returns int32 (n, len(ranks)) len << 25 | dist (0 where none), in
    position order."""
    n = key_s.shape[0]
    pos_s = order
    w_s = [x[order] for x in _words(data)]
    h_s = key_s >> 14
    live = key_s < 0
    guard = torch.clamp(npos + 3 - pos_s, min=0)
    out = torch.empty((n, len(ranks)), dtype=torch.int32, device=key_s.device)
    packed_s = torch.empty_like(out)
    for j, k in enumerate(ranks):
        same = (h_s == _shift_up(h_s, k, 1 << 17)) & live
        dist = pos_s - _shift_up(pos_s, k, -1)
        valid = same & (dist > 0) & (dist <= max_distance)
        mlen = torch.zeros(n, dtype=torch.int64, device=key_s.device)
        alive = valid
        for ws in w_s:
            x = ws ^ _shift_up(ws, k, 0)
            mlen = mlen + torch.where(alive, _tz_bytes_u32(x), 0)
            alive = alive & (x == 0)
        mlen = torch.minimum(mlen, guard)
        mlen = torch.where(valid & (mlen >= 2), mlen, 0)
        packed_s[:, j] = ((mlen << 25) | torch.where(mlen > 0, dist, 0)).to(
            torch.int32)
    out[order] = packed_s  # back to position order
    return out


def edge_rows_plain(words, nranks):
    """K10's row pass, plain version: the levels' rows (int32 (nlevels,
    n, 16), a level's candidates in its first nranks[l] words) side by
    side in one int32 (n, sum(nranks)) candidate table."""
    return torch.cat([words[lvl, :, :nr] for lvl, nr in enumerate(nranks)],
                     1)


def edge_keys(data, npos, plen):
    """K9: the plain version on the CPU, csrc/edge_keys.cu on the card."""
    if data.device.type == "cpu":
        return edge_keys_plain(data, npos, plen)
    return kernels.edge_keys(data, npos, plen)


def edge_ranks(key_s, order, data, npos, max_distance, ranks, words):
    """K10's level launch into the int32 (n, 16) `words` (position order,
    zero past len(ranks)), filled in place: the plain version on the CPU,
    csrc/edge_ranks.cu on the card."""
    if key_s.device.type == "cpu":
        words.zero_()
        words[:, :len(ranks)] = edge_ranks_plain(key_s, order, data, npos,
                                                 max_distance, ranks)
        return
    kernels.edge_ranks(key_s, order, data, npos, max_distance, ranks, words)


def edge_rows(words, nranks):
    """K10's row pass: the plain version on the CPU, csrc/edge_ranks.cu's
    second kernel on the card."""
    if words.device.type == "cpu":
        return edge_rows_plain(words, nranks)
    return kernels.edge_rows(words, nranks)


def _candidates(data, npos, max_distance, levels=LEVELS):
    """Every level's rank candidates: per level K9, the stable sort and
    K10's level launch (the level's candidates as whole 16-word rows in
    position order), each level on its own npos - (plen - 4); then K10's
    row pass into one int32 (n, ncand) table (13 + 14 columns; 37 with
    the 16-byte level)."""
    n = data.shape[0]
    words = torch.empty((len(levels), n, kernels.MAX_RANKS),
                        dtype=torch.int32, device=data.device)
    for lvl, (plen, ranks) in enumerate(levels):
        lvl_npos = max(npos - (plen - 4), 0)
        key_s, order = torch.sort(edge_keys(data, lvl_npos, plen),
                                  stable=True)
        edge_ranks(key_s, order, data, lvl_npos, max_distance, ranks,
                   words[lvl])
    return edge_rows(words, [len(ranks) for _, ranks in levels])


def _slot_rows(cand, dist_sym_bits_q, seed_pos, seed_len, seed_dist):
    """The slot rows of optimal_jax._edges_slots from the (n, ncand)
    candidates: int32 (nslots, n) (ls_flat, cs_flat, ds_flat), the
    candidates then the continuation slot, block-boundary clipped, and
    the int64 (n,) dist_fill."""
    n = cand.shape[0]
    dev = cand.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    # continuation edges from seed matches: scatter (end, dist) at each
    # match start (amax per field), then fill forward with the latest
    # positive value (seed matches come from a parse, so they never
    # overlap)
    sp = torch.clamp(seed_pos, 0, n - 1)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    ends = zero.scatter_reduce(0, sp, torch.where(
        seed_len > 0, seed_pos + seed_len, 0), "amax", include_self=True)
    sdist = zero.scatter_reduce(0, sp, torch.where(
        seed_len > 0, seed_dist, 0), "amax", include_self=True)
    end_fill = _fill_last_positive(ends)
    dist_fill = _fill_last_positive(sdist)
    cont_len = torch.clamp(end_fill - pos, 0, W - 1)
    cont_dist = torch.where(cont_len >= 2, dist_fill, 0)

    slots_len, slots_cost, slots_dist = [], [], []
    for k in range(cand.shape[1]):
        cp = cand[:, k].to(torch.int64)
        le = torch.clamp(cp >> 25, max=W - 1)
        di = cp & MASK25
        cost = _dist_cost_q(di, dist_sym_bits_q)
        slots_len.append(le.to(torch.int32))
        slots_cost.append(torch.where(le >= 2, cost, EDGE_INF).to(
            torch.int32))
        slots_dist.append(di.to(torch.int32))
    ccost = _dist_cost_q(cont_dist, dist_sym_bits_q)
    slots_len.append(torch.where(cont_dist > 0, cont_len, 0).to(
        torch.int32))
    slots_cost.append(torch.where((cont_len >= 2) & (cont_dist > 0),
                                  ccost, EDGE_INF).to(torch.int32))
    slots_dist.append(cont_dist.to(torch.int32))
    ls_flat = torch.stack(slots_len)
    cs_flat = torch.stack(slots_cost)
    ds_flat = torch.stack(slots_dist)
    # clip edges that would cross the block boundary; kill sub-2 stubs
    room = (B - pos % B).to(torch.int32)[None, :]
    ls_flat = torch.minimum(ls_flat, room)
    cs_flat = torch.where(ls_flat >= 2, cs_flat, EDGE_INF)
    return ls_flat, cs_flat, ds_flat, dist_fill


def _edges_slots(data, npos, max_distance, dist_sym_bits_q,
                 seed_pos, seed_len, seed_dist, levels=LEVELS):
    """Per-slot edges shared by the v1 and v3 pipelines (the counterpart
    of optimal_jax._edges_slots): tiered sort-carry candidate `levels`
    + seed continuation edges, flat (nslots, n) layout, block-boundary
    clipped. Returns int32 (ls_flat, cs_flat, ds_flat, dist_fill),
    dist_fill the distance of the last seed match starting at or before
    each position (the ring scan's entry ring)."""
    ls_flat, cs_flat, ds_flat, dist_fill = _slot_rows(
        _candidates(data, npos, max_distance, levels), dist_sym_bits_q,
        seed_pos, seed_len, seed_dist)
    return ls_flat, cs_flat, ds_flat, dist_fill.to(torch.int32)


def _fill_last_positive(x):
    """out[i] = the last x[j] > 0 with j <= i, else x[0] (the JAX
    associative_scan with where(b > 0, b, a))."""
    idx = torch.arange(x.shape[0], device=x.device)
    src = torch.cummax(torch.where(x > 0, idx, 0), dim=0).values
    return x[src]


def edge_slots_plain(cand, data, max_distance, dist_sym_bits_q, seed_pos,
                     seed_len, seed_dist, lit_tab, ctx_tab=None,
                     dict_pos=None, dict_pay=None, seg_base=0):
    """K11, plain version of the slot rows of optimal_jax._edges_slots,
    the dictionary and literal rows of _dp_v3_impl and, for v1, of
    _edges_kernel. cand: K10's int32 (n, ncand) table.

    v3 (ctx_tab given): the nslots = ncand + 2 slots [candidates, the
    atomic dictionary slot, the continuation slot], the dictionary slot
    inserted after the block clip (its length kept only where the word
    fits the block, its distance past the window at seg_base + pos, its
    dls << 25 wrapping in int32), and the literal cost lit_tab[ctx_tab[p1
    << 8 | p2] << 8 | byte] * 2 (p1, p2 the previous bytes, 0 before the
    segment). v1 (ctx_tab None): ncand + 1 slots without the dictionary
    slot, and the literal cost lit_tab[p1 << 8 | byte], no * 2.

    Returns int32 (nslots, n) pd_flat (len << 25 | dist, dist 0 below
    length 2) and cs_flat (distance cost, EDGE_INF where no edge), in
    the layout K1 and K7 read, and the int32 (n,) litq and dist_fill."""
    n = cand.shape[0]
    ls_flat, cs_flat, ds_flat, dist_fill = _slot_rows(
        cand, dist_sym_bits_q, seed_pos, seed_len, seed_dist)
    pd_flat = (ls_flat << 25) | torch.where(ls_flat >= 2, ds_flat, 0)
    d = data.to(torch.int64)
    p1 = _shift_up(d, 1, 0)
    if ctx_tab is None:
        litq = lit_tab[(p1 << 8) | d].to(torch.int32)
        return (pd_flat.contiguous(), cs_flat.contiguous(), litq,
                dist_fill.to(torch.int32))
    # dict slot row (inserted before the continuation slot)
    pos = torch.arange(n, dtype=torch.int64, device=cand.device)
    val = dict_pay.to(torch.int64)
    dpp = torch.clamp(dict_pos.to(torch.int64), 0, n - 1)
    zero = torch.zeros(n, dtype=torch.int64, device=cand.device)
    dls = zero.scatter_reduce(0, dpp, torch.where(
        val > 0, (val >> 22) & 0x3FF, 0), "amax", include_self=True)
    doff = zero.scatter_reduce(0, dpp, torch.where(
        val > 0, val & ((1 << 17) - 1), 0), "amax", include_self=True)
    dls = torch.where(dls <= B - pos % B, dls, 0)  # atomic: no split
    maxd_at = torch.clamp(seg_base + pos, max=max_distance)
    ddist = torch.where(dls >= 2, maxd_at + 1 + doff, 0)
    dcost = torch.where(dls >= 2, _dist_cost_q(ddist, dist_sym_bits_q),
                        EDGE_INF)
    pdD = (dls << 25) | torch.where(dls >= 2, ddist, 0)
    pd_flat = torch.cat([pd_flat[:-1], pdD.to(torch.int32)[None],
                         pd_flat[-1:]]).contiguous()
    cs_flat = torch.cat([cs_flat[:-1], dcost.to(torch.int32)[None],
                         cs_flat[-1:]]).contiguous()
    # per-position literal cost: ctx = lut0[p1]|lut1[p2], then
    # bits[ctx, byte] (u8 at 1/8 bit -> 1/16 units)
    p2 = _shift_up(d, 2, 0)
    cid = ctx_tab[(p1 << 8) | p2].to(torch.int64)
    litq = (lit_tab[(cid << 8) | d] * 2).to(torch.int32)
    return pd_flat, cs_flat, litq, dist_fill.to(torch.int32)


def edge_slots(cand, data, max_distance, dist_sym_bits_q, seed_pos,
               seed_len, seed_dist, lit_tab, ctx_tab=None, dict_pos=None,
               dict_pay=None, seg_base=0):
    """K11: the plain version on the CPU, csrc/edge_slots.cu on the
    card."""
    if cand.device.type == "cpu":
        return edge_slots_plain(cand, data, max_distance, dist_sym_bits_q,
                                seed_pos, seed_len, seed_dist, lit_tab,
                                ctx_tab, dict_pos, dict_pay, seg_base)
    return kernels.edge_slots(cand, data, max_distance, dist_sym_bits_q,
                              seed_pos, seed_len, seed_dist, lit_tab,
                              ctx_tab, dict_pos, dict_pay, seg_base)


def segment_tables(data, npos, max_distance, bits_tab, ctx_tab,
                   dist_sym_bits_q, seed_pos, seed_len, seed_dist,
                   dict_pos, dict_pay, seg_base, levels=LEVELS):
    """Stage 1 of a v3 segment: the candidates (K9, the sorts, K10) and
    the slot tables (K11): the 29 edge slots (27 candidate ranks, the
    atomic dictionary slot, the continuation slot; 39 with the 16-byte
    level) as int32 (nslots, n) `pd_flat` (len<<25 | dist) and
    `cs_flat` (distance cost), the int32 (n,) per-position literal cost
    and the int32 (n,) `dist_fill` of `_edges_slots`."""
    return edge_slots(_candidates(data, npos, max_distance, levels), data,
                      max_distance, dist_sym_bits_q, seed_pos, seed_len,
                      seed_dist, bits_tab, ctx_tab, dict_pos, dict_pay,
                      seg_base)


def edges_v1(data, npos, max_distance, litbits_q, dist_sym_bits_q,
             seed_pos, seed_len, seed_dist, levels=LEVELS):
    """The v1 edges (optimal_jax._edges_kernel): the 28 slots of
    `_edges_slots` (38 with the 16-byte level; no dictionary slot) as
    int32 (nslots, n) `pd_flat` (len<<25 | dist, dist 0 below length 2)
    and `cs_flat`, and the int32 (n,) literal cost litbits_q[p1, byte]
    from the (256*256,) table, p1 the previous byte (0 at position 0).
    JAX emits the same values transposed to (B, nslots, nb)."""
    pd_flat, cs_flat, litq, _ = edge_slots(
        _candidates(data, npos, max_distance, levels), data, max_distance,
        dist_sym_bits_q, seed_pos, seed_len, seed_dist, litbits_q)
    return pd_flat, cs_flat, litq


# ---------------------------------------------------------------------
# device side: the three kernels and their plain versions
# ---------------------------------------------------------------------

def suffix_min_plain(pd_flat, cs_flat, copyq, chunk=1 << 18):
    """K1, plain version of optimal_jax._suffix_kernel, position-major:
    (nslots, n) slots -> int32 (n, 2W) rows [M | P]. M[c] = min slot
    cost over slots with lo <= c <= len, plus copyq[c] (NO_EDGE when
    none); P[c] = (c << 25) | the argmin's distance (0 when none).
    Strict < in slot order: the lowest slot wins ties. Slot nslots-2
    (dictionary) is atomic: lo = len. Processed in position chunks
    to bound memory; the result does not depend on the chunking."""
    nslots, n = pd_flat.shape
    dev = pd_flat.device
    out = torch.empty((n, 2 * W), dtype=torch.int32, device=dev)
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    cq = copyq[:W].to(torch.int32)[None, :]
    for lo in range(0, n, chunk):
        pd = pd_flat[:, lo:lo + chunk]
        cs = cs_flat[:, lo:lo + chunk]
        m = pd.shape[1]
        acc = torch.full((m, W), EDGE_INF, dtype=torch.int32, device=dev)
        pay = torch.full((m, W), BIGD, dtype=torch.int32, device=dev)
        for s in range(nslots):
            ls = (pd[s] >> 25)[:, None]
            ds = (pd[s] & MASK25)[:, None]
            low = torch.clamp(ls, min=2) if s == nslots - 2 else 2
            hit = (col <= ls) & (col >= low)
            v = torch.where(hit, cs[s][:, None], EDGE_INF)
            upd = v < acc
            acc = torch.where(upd, v, acc)
            pay = torch.where(upd, ds, pay)
        out[lo:lo + m, :W] = torch.where(acc < EDGE_INF, acc + cq, NO_EDGE)
        out[lo:lo + m, W:] = torch.where(pay != BIGD, (col << 25) | pay, 0)
    return out


def suffix_min(pd_flat, cs_flat, copyq):
    """K1: the plain version on the CPU, csrc/suffix_min.cu on the
    card."""
    if pd_flat.device.type == "cpu":
        return suffix_min_plain(pd_flat, cs_flat, copyq)
    return kernels.suffix_min(pd_flat, cs_flat, copyq)


def dp_scan_plain(mp, litq):
    """K3, plain version of optimal_jax._scan_math_v3 (default branch):
    mp (n, 2W) rows from K1 and litq (n,) literal costs, both
    position-major; returns int32 paymat (nb, B+1) with the final
    payload of every in-block position and of the block end. Per step:
    literal relax into column 1 first (strict <, so a literal beats a
    match on ties), then the min-merge of cost_i + M into the window,
    then the shift."""
    n = mp.shape[0]
    nb = n // B
    dev = mp.device
    mpv = mp.view(nb, B, 2 * W)
    lq = litq.view(nb, B)
    F = torch.full((nb, W), SCAN_INF, dtype=torch.int32, device=dev)
    F[:, 0] = 0
    P = torch.zeros((nb, W), dtype=torch.int32, device=dev)
    inf_col = torch.full((nb, 1), SCAN_INF, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
    paymat = torch.empty((nb, B + 1), dtype=torch.int32, device=dev)
    for i in range(B):
        cost_i = F[:, 0].clone()
        paymat[:, i] = P[:, 0]
        lv = cost_i + lq[:, i]
        upd = lv < F[:, 1]
        F[:, 1] = torch.where(upd, lv, F[:, 1])
        P[:, 1] = torch.where(upd, 0, P[:, 1])
        minv = cost_i[:, None] + mpv[:, i, :W]
        better = minv < F
        F = torch.cat([torch.where(better, minv, F)[:, 1:], inf_col], 1)
        P = torch.cat([torch.where(better, mpv[:, i, W:], P)[:, 1:],
                       zero_col], 1)
    paymat[:, B] = P[:, 0]
    return paymat


def dp_scan(mp, litq):
    """K3: the plain version on the CPU, csrc/dp_scan.cu on the card."""
    if mp.device.type == "cpu":
        return dp_scan_plain(mp, litq)
    return kernels.dp_scan(mp, litq)


def dp_scan_v1_plain(pd_flat, cs_flat, litq, copyq):
    """K7, plain version of optimal_jax._scan_kernel, the v1 wavefront:
    (nslots, n) slots (pd = len<<25 | dist, cs = distance cost) and
    (n,) literal costs, position-major; returns int32 paymat (nb, B+1)
    as dp_scan_plain does. Per step, after the literal relax, every
    slot relaxes every column c with 2 <= c <= len at cost_i + cs +
    copyq[c]; minv[c] is the minimum over the slots (SCAN_INF when none
    reaches c) and pay[c] the smallest (c << 25) | dist among the slots
    that give it; then the strict-< merge and the shift."""
    nslots, n = pd_flat.shape
    nb = n // B
    dev = pd_flat.device
    pd = pd_flat.view(nslots, nb, B)
    cs = cs_flat.view(nslots, nb, B)
    lq = litq.view(nb, B)
    col = torch.arange(W, dtype=torch.int32, device=dev)
    cq = copyq[:W].to(torch.int32)
    F = torch.full((nb, W), SCAN_INF, dtype=torch.int32, device=dev)
    F[:, 0] = 0
    P = torch.zeros((nb, W), dtype=torch.int32, device=dev)
    inf_col = torch.full((nb, 1), SCAN_INF, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
    paymat = torch.empty((nb, B + 1), dtype=torch.int32, device=dev)
    for i in range(B):
        cost_i = F[:, 0].clone()
        paymat[:, i] = P[:, 0]
        lv = cost_i + lq[:, i]
        upd = lv < F[:, 1]
        F[:, 1] = torch.where(upd, lv, F[:, 1])
        P[:, 1] = torch.where(upd, 0, P[:, 1])
        pdi = pd[:, :, i, None]
        v = (cost_i[None, :] + cs[:, :, i])[:, :, None]
        hit = (col <= (pdi >> 25)) & (col >= 2)
        M = torch.where(hit, v + cq, SCAN_INF)
        minv = M.min(0).values
        pay = torch.where(M == minv[None], (col << 25) | (pdi & MASK25),
                          BIGD).min(0).values
        better = minv < F
        F = torch.cat([torch.where(better, minv, F)[:, 1:], inf_col], 1)
        P = torch.cat([torch.where(better, pay, P)[:, 1:], zero_col], 1)
    paymat[:, B] = P[:, 0]
    return paymat


def dp_scan_v1(pd_flat, cs_flat, litq, copyq):
    """K7: the plain version on the CPU, csrc/dp_scan_v1.cu on the
    card."""
    if pd_flat.device.type == "cpu":
        return dp_scan_v1_plain(pd_flat, cs_flat, litq, copyq)
    return kernels.dp_scan_v1(pd_flat, cs_flat, litq, copyq)


def dp_scan_ring_plain(mp, litq, data, ring_init, ring_cost, copyq, icell,
                       npos):
    """K8, plain version of the path-ring branch of
    optimal_jax._scan_math_v3: K3 (dp_scan_plain) plus R, the ring[0]
    of the best path into each window column. Per step, after the
    literal relax (whose column inherits R[0]): ring_i = R[0], and when
    ring_i > 0 and src = pos - ring_i >= 0 the ring edge's length is the
    count of equal leading bytes of the 16 at pos and at src (the
    segment's bytes read cyclically, as jnp.roll builds them), capped
    at the block end and at npos + 3 - pos; it prices columns 2..len at
    cost_i + ring_cost + copyq[c], capped by the implicit-cell row
    `icell` when given, else by EDGE_INF (strict <; P = c << 25 |
    ring_i, R = ring_i). Then K1's rows merge as in K3 with R = PY &
    MASK25, and the shift fills (SCAN_INF, 0, 0). R starts at
    ring_init[block]; ring_cost is a (1,) tensor."""
    n = mp.shape[0]
    nb = n // B
    dev = mp.device
    mpv = mp.view(nb, B, 2 * W)
    lq = litq.view(nb, B)
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    cap = icell[:W] if icell is not None else torch.full(
        (W,), EDGE_INF, dtype=torch.int32, device=dev)
    ring_w = torch.minimum(ring_cost[:1] + copyq[:W], cap)[None, :]
    d = data.to(torch.int64)
    w0 = (d | (torch.roll(d, -1) << 8) | (torch.roll(d, -2) << 16) |
          (torch.roll(d, -3) << 24))
    w_full = torch.stack([torch.roll(w0, -4 * k) for k in range(4)])
    lane_base = torch.arange(nb, dtype=torch.int32, device=dev) * B
    F = torch.full((nb, W), SCAN_INF, dtype=torch.int32, device=dev)
    F[:, 0] = 0
    P = torch.zeros((nb, W), dtype=torch.int32, device=dev)
    R = ring_init.to(torch.int32)[:, None].repeat(1, W)
    inf_col = torch.full((nb, 1), SCAN_INF, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
    paymat = torch.empty((nb, B + 1), dtype=torch.int32, device=dev)
    for i in range(B):
        cost_i = F[:, 0].clone()
        paymat[:, i] = P[:, 0]
        lv = cost_i + lq[:, i]
        upd = lv < F[:, 1]
        F[:, 1] = torch.where(upd, lv, F[:, 1])
        P[:, 1] = torch.where(upd, 0, P[:, 1])
        ring_i = R[:, 0].clone()
        R[:, 1] = torch.where(upd, ring_i, R[:, 1])
        pos = lane_base + i
        src = pos - ring_i
        alive = (ring_i > 0) & (src >= 0)
        srcc = torch.clamp(src, 0, n - 1).long()
        rl = torch.zeros(nb, dtype=torch.int64, device=dev)
        for k in range(4):
            x = w_full[k, pos.long()] ^ w_full[k, srcc]
            rl = rl + torch.where(alive, _tz_bytes_u32(x), 0)
            alive = alive & (x == 0)
        rl = torch.minimum(rl, torch.full_like(rl, B - i))
        rl = torch.minimum(rl, torch.clamp(npos + 3 - pos, min=0))[:, None]
        rv = torch.where((col >= 2) & (col <= rl), cost_i[:, None] + ring_w,
                         SCAN_INF)
        rbet = rv < F
        F = torch.where(rbet, rv, F)
        P = torch.where(rbet, (col << 25) | ring_i[:, None], P)
        R = torch.where(rbet, ring_i[:, None], R)
        py = mpv[:, i, W:]
        minv = cost_i[:, None] + mpv[:, i, :W]
        better = minv < F
        F = torch.cat([torch.where(better, minv, F)[:, 1:], inf_col], 1)
        P = torch.cat([torch.where(better, py, P)[:, 1:], zero_col], 1)
        R = torch.cat([torch.where(better, py & MASK25, R)[:, 1:],
                       zero_col], 1)
    paymat[:, B] = P[:, 0]
    return paymat


def dp_scan_ring(mp, litq, data, ring_init, ring_cost, copyq, icell, npos):
    """K8: the plain version on the CPU, csrc/dp_scan_ring.cu on the
    card."""
    if mp.device.type == "cpu":
        return dp_scan_ring_plain(mp, litq, data, ring_init, ring_cost,
                                  copyq, icell, npos)
    return kernels.dp_scan_ring(mp, litq, data, ring_init, ring_cost,
                                copyq, icell, npos)


def dp_backtrack_plain(paymat):
    """K4, plain version of the backtrack of optimal_jax._finish_math:
    walk each block from B over exactly B steps (the step is 0 at
    position 0). Returns int32 (B, nb) global match starts (-1 where
    the step is a literal or a no-op) and the payload read at each
    step, in the JAX scan's (step, block) layout."""
    nb = paymat.shape[0]
    dev = paymat.device
    bidx = torch.arange(nb, device=dev)
    posv = torch.full((nb,), B, dtype=torch.int32, device=dev)
    srcs = torch.empty((B, nb), dtype=torch.int32, device=dev)
    vals = torch.empty((B, nb), dtype=torch.int32, device=dev)
    for k in range(B):
        v = paymat[bidx, posv.long()]
        ln = v >> 25
        stepb = torch.where(posv > 0, torch.clamp(ln, min=1), 0)
        src = posv - stepb
        srcs[k] = torch.where((ln >= 2) & (posv > 0), src, -1)
        vals[k] = v
        posv = src
    gsrc = torch.where(srcs >= 0, srcs + (bidx * B).to(torch.int32)[None],
                       -1)
    return gsrc, vals


def dp_backtrack(paymat):
    """K4: the plain version on the CPU, csrc/dp_backtrack.cu on the
    card."""
    if paymat.device.type == "cpu":
        return dp_backtrack_plain(paymat)
    return kernels.dp_backtrack(paymat)


def compact(gsrc, vals, npos):
    """The stable compaction after the backtrack: match starts in
    position order (key 0xFFFFFFFF for invalid entries, which keep
    their scan order). Returns (count, stacked) with stacked the int64
    (2, n//2) [start; payload] table holding uint32 values."""
    n = gsrc.numel()
    g = gsrc.reshape(-1).to(torch.int64)
    valid = (g >= 0) & (g < npos)
    key = torch.where(valid, g, u32.MASK32)
    pos_c, order = torch.sort(key, stable=True)
    pay_c = vals.reshape(-1).to(torch.int64)[order] & u32.MASK32
    half = n // 2
    return valid.sum(), torch.stack([pos_c[:half], pay_c[:half]])


def dp_v3_segment(data, npos, max_distance, bits_tab, ctx_tab, copyq,
                  dist_sym_bits_q, seed_pos, seed_len, seed_dist,
                  dict_pos, dict_pay, seg_base, *, capm, cfg=DPConfig(),
                  icell_q=None):
    """One segment's optimal parse (counterpart of
    optimal_jax._dp_v3_impl): edges -> K1 -> K3 (K8 with
    cfg.ring_scan, its edge capped by the implicit-cell row `icell_q`
    with cfg.icell) -> K4 -> compaction.

    Returns (packed, stacked): packed is int64 (2, capm + 8) holding
    uint32 values, with the match count at [0, 0] and matches at
    [:, 8 : 8 + capm]; stacked is the uncapped (2, n//2) compaction,
    fetched only on overflow."""
    pd_flat, cs_flat, litq, dist_fill = segment_tables(
        data, npos, max_distance, bits_tab, ctx_tab, dist_sym_bits_q,
        seed_pos, seed_len, seed_dist, dict_pos, dict_pay, seg_base,
        cfg.levels)
    mp = suffix_min(pd_flat, cs_flat, copyq)
    del pd_flat, cs_flat
    if cfg.ring_scan:
        # the seed ring at every block start (blocks are hard parse
        # boundaries, so the entry ring is unknowable)
        ring_init = dist_fill.view(-1, B)[:, 0].contiguous()
        paymat = dp_scan_ring(mp, litq, data, ring_init,
                              dist_sym_bits_q[:1], copyq,
                              icell_q if cfg.icell else None, npos)
    else:
        paymat = dp_scan(mp, litq)
    del mp
    gsrc, vals = dp_backtrack(paymat)
    count, stacked = compact(gsrc, vals, npos)
    packed = torch.zeros((2, capm + 8), dtype=torch.int64,
                         device=data.device)
    packed[0, 0] = count
    packed[:, 8:8 + capm] = stacked[:, :capm]
    return packed, stacked


def dp_v1_segment(data, npos, max_distance, litbits_q, copyq,
                  dist_sym_bits_q, seed_pos, seed_len, seed_dist, *,
                  levels=LEVELS):
    """One v1 segment's optimal parse (counterpart of
    optimal_jax.dp_parse_block): edges_v1 -> K7 -> K4 -> compaction.
    Returns (count, stacked), stacked the uncapped int64 (2, n//2)
    compaction holding uint32 values."""
    pd_flat, cs_flat, litq = edges_v1(
        data, npos, max_distance, litbits_q, dist_sym_bits_q, seed_pos,
        seed_len, seed_dist, levels)
    paymat = dp_scan_v1(pd_flat, cs_flat, litq, copyq)
    del pd_flat, cs_flat
    gsrc, vals = dp_backtrack(paymat)
    return compact(gsrc, vals, npos)


# ---------------------------------------------------------------------
# host side (copied from optimal_jax.py)
# ---------------------------------------------------------------------

def _seg_seed_edges(seeds_list, lo, hi, cap):
    """Seed matches intersected with segment [lo, hi) (a suffix of an
    LZ match is a match at the same distance, so a giant match spanning
    several segments seeds each of them); fixed pad size. Short seeds
    are redundant with the segment-local candidates."""
    spos_parts, slen_parts, sdist_parts = [], [], []
    for (qm, ql, qd, qf) in seeds_list:
        start = np.maximum(qm, lo)
        end = np.minimum(qm + ql, hi)
        in_seg = (end - start >= 16) & (qf < 2)
        spos_parts.append((start[in_seg] - lo).astype(np.int32))
        slen_parts.append((end - start)[in_seg].astype(np.int32))
        sdist_parts.append(qd[in_seg].astype(np.int32))
    spos = np.concatenate(spos_parts)
    slen = np.concatenate(slen_parts)
    sdist = np.concatenate(sdist_parts)
    if len(spos) > cap:  # keep the longest seeds
        keep = np.argsort(slen)[::-1][:cap]
        keep.sort()
        spos, slen, sdist = spos[keep], slen[keep], sdist[keep]
    pad = cap - len(spos)
    return (np.pad(spos, (0, pad)), np.pad(slen, (0, pad)),
            np.pad(sdist, (0, pad)))


def _dict_probe_global(arr, seeds_list, base, max_distance):
    """One native static-dictionary probe over the whole input
    (seed-gated; ~1% of positions). Returns (positions, payloads,
    word lengths). When the hits overflow the probe's output cap (one
    per 8 bytes: text made of dictionary words), the probe fails and
    the DP runs without dictionary edges, as in the JAX package."""
    with trace.stage("dp.dict-probe"):
        qm, ql = seeds_list[0][0], seeds_list[0][1]
        try:
            dpos_g, dpay_g = native.dict_probe_all(
                np.ascontiguousarray(arr).tobytes(), qm, ql, base,
                max_distance)
        except ValueError:
            dpos_g = dpay_g = np.zeros(0, np.uint32)
    dwlen_g = ((dpay_g >> 17) & 0x1F).astype(np.int64)
    return dpos_g, dpay_g, dwlen_g


def _prep_segment_v3(arr, seeds_list, dpos_g, dpay_g, lo, hi, b):
    """Host-side small inputs of one DP segment (seed continuation +
    dictionary edges; the data itself ships once for the whole
    buffer)."""
    spos, slen, sdist = _seg_seed_edges(seeds_list, lo, hi, b // 128)
    # dict edges inside [lo, hi) whose word fits the segment
    douts = (dpay_g >> 22).astype(np.int64)
    in_seg = (dpos_g >= lo) & (dpos_g + douts <= hi)
    dp_loc = (dpos_g[in_seg].astype(np.int64) - lo).astype(np.int32)
    dp_val = dpay_g[in_seg].astype(np.int32)
    cap_d = b // 64
    if len(dp_loc) > cap_d:  # keep the longest words
        keep = np.argsort(dp_val >> 22)[::-1][:cap_d]
        keep.sort()
        dp_loc, dp_val = dp_loc[keep], dp_val[keep]
    pad = cap_d - len(dp_loc)
    return (max(hi - lo - 3, 0), spos, slen, sdist,
            np.pad(dp_loc, (0, pad)), np.pad(dp_val, (0, pad)))


def _slice_seg(dev_big, lo, b):
    """The segment [lo, lo + b) of the uploaded buffer, with the start
    clamped so the slice fits (lax.dynamic_slice semantics)."""
    lo = max(min(lo, dev_big.shape[0] - b), 0)
    return dev_big[lo:lo + b]


def upload_input(arr, n, device):
    """One host-to-device copy of the whole bucket-padded input;
    segments are slices of it."""
    tail = n - (n // SEG_V3) * SEG_V3
    pad_to = (n // SEG_V3) * SEG_V3 + (_bucket_v3(tail) if tail else 0)
    with trace.stage("dp.upload"):
        big = np.zeros(max(pad_to, BUCKETS_V3[0]), np.uint8)
        big[:n] = arr[:n]
        return torch.from_numpy(big).to(device)


def device_tables(tables, device):
    """The v3 cost tables as device tensors: (bits_tab, ctx_tab, copyq,
    dist_sym_bits_q)."""
    bits_tab, copyq, distq, ctx_tab = tables[:4]
    with trace.stage("dp.upload"):
        return (torch.from_numpy(bits_tab.astype(np.int32).reshape(-1)).to(
                    device),
                torch.from_numpy(ctx_tab.astype(np.int32)).to(device),
                torch.from_numpy(copyq[:W].astype(np.int32)).to(device),
                torch.from_numpy(distq.astype(np.int32)).to(device))


def segment_inputs(arr, seeds_list, dict_g, lo, hi, b, device):
    """Per-segment host prep as device tensors: (npos, seed_pos,
    seed_len, seed_dist, dict_pos, dict_pay)."""
    dpos_g, dpay_g, _ = dict_g
    with trace.stage("dp.seg-prep"):
        npos, *rest = _prep_segment_v3(arr, seeds_list, dpos_g, dpay_g,
                                       lo, hi, b)
    with trace.stage("dp.upload"):
        return (npos,) + tuple(
            torch.from_numpy(a.astype(np.int64)).to(device) for a in rest)


def _dispatch_v3(arr, n, max_distance, tables, seeds_list, dev_big, cfg,
                 base=0, dict_g=None, lo_start=0):
    """Run every segment's DP from `lo_start` (device work is queued
    asynchronously; nothing waits for it here; each segment records an
    event when queued, which its collect waits on). Returns (handles,
    dict_table): dict_table = (global hit positions, word lengths) for
    flag recovery at collect time. `dict_g`: an already computed
    _dict_probe_global result."""
    dev = dev_big.device
    bits_tab, ctx_tab, copyq, distq = device_tables(tables, dev)
    icell_q = torch.from_numpy(tables[4].astype(np.int32)).to(dev) \
        if cfg.icell else None
    if dict_g is None:
        dict_g = _dict_probe_global(arr, seeds_list, base, max_distance)
    handles = []
    for lo in range(lo_start, n, SEG_V3):
        hi = min(lo + SEG_V3, n)
        b = _bucket_v3(hi - lo)
        capm = b // CAPM_DIV
        npos, spos, slen, sdist, dloc, dval = segment_inputs(
            arr, seeds_list, dict_g, lo, hi, b, dev)
        with trace.stage("dp.dispatch"):
            packed, full = dp_v3_segment(
                _slice_seg(dev_big, lo, b), npos, max_distance, bits_tab,
                ctx_tab, copyq, distq, spos, slen, sdist, dloc, dval,
                lo + base, capm=capm, cfg=cfg, icell_q=icell_q)
        handles.append((lo, capm, packed, full, fetch.mark(dev)))
    dpos_g, _, dwlen_g = dict_g
    return handles, (dpos_g.astype(np.int64), dwlen_g)


def _dispatch_v1(arr, n, max_distance, tables, seeds_list, cfg, dev):
    """Queue every v1 segment's DP (SEG bytes each, padded to its
    bucket) without waiting for the card. Returns (lo, count, stacked,
    event) handles."""
    litbits, copyq, distq = (
        torch.from_numpy(np.ascontiguousarray(t, np.int32).reshape(-1)).to(
            dev) for t in tables)
    handles = []
    for lo in range(0, n, SEG):
        hi = min(lo + SEG, n)
        padded = np.zeros(_bucket_in(hi - lo, BUCKETS), np.uint8)
        padded[:hi - lo] = arr[lo:hi]
        seg_edges = _seg_seed_edges(seeds_list, lo, hi, SEG // 32)
        with trace.stage("dp.dispatch"):
            count, out = dp_v1_segment(
                torch.from_numpy(padded).to(dev), max(hi - lo - 3, 0),
                max_distance, litbits, copyq, distq,
                *(torch.from_numpy(a.astype(np.int64)).to(dev)
                  for a in seg_edges), levels=cfg.levels)
        handles.append((lo, count, out, fetch.mark(dev)))
    return handles


def _collect_segment(lo, count, out, ev):
    """Read back one v1 segment's compacted matches: the count, then
    2^ceil(log2 count) entries (at least 1,024)."""
    cnt = int(fetch.fetch_after([ev], [count.reshape(1)])[0])
    z = np.zeros(0, np.int64)
    if cnt == 0:
        return z, z, z
    k = min(1 << max(int(np.ceil(np.log2(cnt))), 10), out.shape[1])
    host = _to_u32([ev], [out[:, :k]])[0]
    pay = host[1, :cnt]
    return (host[0, :cnt].astype(np.int64) + lo,
            (pay >> 25).astype(np.int64),
            (pay & np.uint32(MASK25)).astype(np.int64))


def _stream_blocks(arr, handles, n, mb_size, max_distance, base,
                   on_block):
    """v1 streaming: collect segments in order, emitting each finished
    metablock span to `on_block` while later segments compute on the
    card. Matches crossing a span boundary split here; the dictionary
    post-pass runs per span."""
    z = np.zeros(0, np.int64)
    pm, pl, pd = z, z, z    # pending matches (coalesced)
    emitted = 0
    for lo, count, out, ev in handles:
        with trace.stage("dp.fetch"):
            mm, ml, md = _collect_segment(lo, count, out, ev)
        covered = min(lo + SEG, n)
        if len(mm):
            with trace.stage("dp.collect"):
                pm, pl, pd, _ = bridge_matches(arr, *_coalesce(
                    np.concatenate([pm, mm]), np.concatenate([pl, ml]),
                    np.concatenate([pd, md]), np.zeros(len(pm) + len(mm),
                                                       np.int64)))
        while emitted < n:
            mb_hi = min(emitted + mb_size, n)
            if covered < mb_hi:
                break
            pm, pl, pd, _ = split_matches_at(
                pm, pl, pd, np.zeros(len(pm), np.int64), [mb_hi, n + 1])
            take = pm < mb_hi
            bm, bl, bd = pm[take], pl[take], pd[take]
            pm, pl, pd = pm[~take], pl[~take], pd[~take]
            with trace.stage("dp.dict-post"):
                bm, bl, bd, bf = add_dictionary_matches(
                    arr[:mb_hi], bm, bl, bd, np.zeros(len(bm), np.int64),
                    max_distance, base, active_from=emitted)
            on_block(emitted, mb_hi, (bm, bl, bd, bf))
            emitted = mb_hi


def _to_u32(events, tensors):
    return fetch.fetch_after(events, tensors).numpy().astype(np.uint32)


def _collect_v3(handles, dict_table, max_distance, base=0):
    """One stacked device-to-host copy per packed shape, sliced to half
    the match cap (the count-first layout keeps the count inside the
    slice; rare overflows pay a second fetch). Each copy waits only on
    the events of the segments it reads. Matches whose distance
    exceeds the window at their position are the DP's dictionary
    edges; their word-length flags (2000 + wlen) come back from the
    host probe table."""
    dpos_g, dwlen_g = dict_table
    groups = {}
    for i, (_lo, capm, packed, _full, _ev) in enumerate(handles):
        groups.setdefault((tuple(packed.shape), capm), []).append(i)
    fetched = [None] * len(handles)
    with trace.stage("dp.fetch"):
        for (_shape, capm), idxs in groups.items():
            k = 8 + capm // 2
            host = _to_u32([handles[i][4] for i in idxs],
                           [handles[i][2][:, :k] for i in idxs])
            for j, i in enumerate(idxs):
                fetched[i] = host[j]
    all_m, all_l, all_d, all_f = [], [], [], []
    with trace.stage("dp.collect"):
        for (lo, capm, packed, full, ev), hp in zip(handles, fetched):
            cnt = int(hp[0, 0])
            if cnt > capm:  # rare overflow: fetch the uncapped compaction
                hostf = _to_u32([ev], [full[:, :cnt]])[0]
                pos_c, pay_c = hostf[0], hostf[1]
            elif cnt > capm // 2:  # middle tier: fetch the full packed
                hostp = _to_u32([ev], [packed])[0]
                pos_c, pay_c = hostp[0, 8:8 + cnt], hostp[1, 8:8 + cnt]
            else:
                pos_c, pay_c = hp[0, 8:8 + cnt], hp[1, 8:8 + cnt]
            if cnt == 0:
                continue
            mm = pos_c.astype(np.int64) + lo
            ml = (pay_c >> 25).astype(np.int64)
            md = (pay_c & np.uint32((1 << 25) - 1)).astype(np.int64)
            mf = np.zeros(len(mm), np.int64)
            isd = md > np.minimum(mm + base, max_distance)
            if isd.any() and len(dpos_g):
                di = np.searchsorted(dpos_g, mm[isd])
                di = np.minimum(di, len(dpos_g) - 1)
                found = dpos_g[di] == mm[isd]
                w = np.where(found, 2000 + dwlen_g[di], 0)
                mf[np.flatnonzero(isd)] = w
            # a dict-flagged match whose probe lookup failed is
            # unserializable -- drop it (its span falls back to literals)
            keep = ~isd | (mf >= 2000)
            all_m.append(mm[keep])
            all_l.append(ml[keep])
            all_d.append(md[keep])
            all_f.append(mf[keep])
    return all_m, all_l, all_d, all_f


_CTX_TAB2 = None  # (65536,) uint8: lut0[p1] | lut1[p2], UTF8 mode


def _ctx_tab2() -> np.ndarray:
    global _CTX_TAB2
    if _CTX_TAB2 is None:
        lut = ctx.context_lut(2)
        p1 = np.arange(256, dtype=np.int64)
        _CTX_TAB2 = (lut[0][p1][:, None] |
                     lut[1][p1][None, :]).astype(np.uint8).reshape(-1)
    return _CTX_TAB2


def _cost_tables(data: np.ndarray, seed, *, lit_table: bool,
                 cfg: DPConfig):
    """Host-side cost tables from the seed parse (optimal_jax._cost_tables
    without exact_lit), with cfg's cost knobs.

    lit_table (v3): the quantized (64, 256) context-model literal bits,
    the per-length copy cost, the 64 distance-symbol costs, the
    (256*256,) p1p2 -> context lookup and the W-entry implicit-cell
    row (the ring edge's cap with cfg.icell). Otherwise (v1): the int32
    (256, 256) [p1, byte] literal cost with p2 marginalized out, the
    copy cost and the distance-symbol costs."""
    m, lens, dists, flags = seed
    n = len(data)
    cap = cfg.cost_sample
    # table statistics come from a bounded sample of the seed parse;
    # replay keeps whole matches only, literal coverage clips instead
    if n > cap:
        _k = (m + lens) <= cap
        sm, sl = m[_k], lens[_k]
        sd, sf = dists[_k], flags[_k]
        cm_, cl_ = m[m < cap], lens[m < cap]
        sdata, sn = data[:cap], cap
    else:
        sm, sl, sd, sf = m, lens, dists, flags
        cm_, cl_ = m, lens
        sdata, sn = data, n
    covered = np.zeros(sn + 1, np.int16)
    np.add.at(covered, np.minimum(cm_, sn), np.int16(1))
    np.add.at(covered, np.minimum(cm_ + cl_, sn), np.int16(-1))
    is_lit = np.cumsum(covered[:sn], dtype=np.int32) == 0
    lut = ctx.context_lut(2)
    lp = np.flatnonzero(is_lit).astype(np.int32)
    p1l = sdata[np.maximum(lp - 1, 0)].astype(np.int32)
    p2l = sdata[np.maximum(lp - 2, 0)].astype(np.int32)
    cidl = (lut[0][p1l] | lut[1][p2l]).astype(np.int32)
    hist = np.bincount((cidl << 8) | sdata[lp],
                       minlength=64 * 256)[:64 * 256].reshape(
                           64, 256) + 1
    bits = -np.log2(hist / hist.sum(axis=1, keepdims=True))

    # copy-code + distance symbol costs
    ccode, _, _ = bitstream._encode_values(
        np.maximum(sl, 2), prefix.COPY_BASE, prefix.COPY_EXTRA)
    cc_hist = np.bincount(ccode, minlength=24).astype(np.float64) + 0.2
    cc_p = cc_hist / cc_hist.sum()
    ins_share = 3.0
    jh = None
    if len(sm) > 16:
        prev_end = np.concatenate([[0], (sm + sl)[:-1]])
        ins_lens = np.maximum(sm - prev_end, 0)
        icode, _, _ = bitstream._encode_values(
            ins_lens, prefix.INSERT_BASE, prefix.INSERT_EXTRA)
        syms = bitstream._combine_codes(icode, ccode,
                                        np.zeros(len(sm), bool))
        jh = np.bincount(syms, minlength=704).astype(np.float64)
        jp = jh / jh.sum()
        joint_avg = float(-(jp[jh > 0] * np.log2(jp[jh > 0])).sum())
        copy_avg = float(-(cc_p * np.log2(cc_p)).sum())
        ins_share = max(joint_avg - copy_avg, 0.5) * cfg.ins_scale
    cc_bits = -np.log2(cc_p) + ins_share

    def copy_cost_q(ls):
        lc = np.searchsorted(prefix.COPY_BASE, np.maximum(ls, 2),
                             side="right") - 1
        return ((cc_bits[lc] + prefix.COPY_EXTRA[lc]) * QB).astype(
            np.int64)
    # distance-symbol cost from the seed parse's actual emission (ring
    # codes included): replay through plan_commands
    if len(sm):
        cmds = matches_to_commands(sm, sl, sd, sf, 0, sn)
        plan, _ = bitstream.plan_commands(*cmds[:3], None, cmds[3])
        dsym = plan["dist_syms"][plan["has_dist"]]
        dh = np.bincount(dsym, minlength=64).astype(np.float64)[:64]
    else:
        dh = np.zeros(64, np.float64)
    dh += 0.2
    dist_sym_bits = -np.log2(dh / dh.sum())
    sur = cfg.lit_surcharge
    if lit_table:
        litbits_q = np.clip(np.round(bits * sur * QB / 2), 0,
                            255).astype(np.uint8)  # (64, 256)
    else:
        # marginalize p2 exactly: ctx = lut0[p1] | lut1[p2], and lut1
        # takes only a handful of values -- weight each by
        # P(lut1[p2] | p1) over adjacent byte pairs of the first 4 MiB.
        # A p1 value absent from the sample gets uniform weights (all
        # zero would price its literals at 0)
        samp = data[:1 << 22]
        l1v = lut[1][samp[:-1].astype(np.int64)]  # lut1 of p2 w/ p1
        p1v = samp[1:].astype(np.int64)
        vals = np.unique(lut[1])
        wt = np.zeros((256, len(vals)), np.float64)
        for j, v in enumerate(vals):
            wt[:, j] = np.bincount(p1v[l1v == v], minlength=256)
        unseen = wt.sum(axis=1) == 0
        wt[unseen] = 1.0
        wt /= np.maximum(wt.sum(axis=1, keepdims=True), 1)
        tab = np.zeros((256, 256), np.float64)
        l0 = lut[0][np.arange(256)].astype(np.int64)
        for j, v in enumerate(vals):
            tab += wt[:, j:j + 1] * bits[l0 | v]
        litbits_q = np.minimum(tab * sur * QB, 24 * QB).astype(np.int32)
    lens_all = np.arange(W)
    copyq = (copy_cost_q(np.maximum(lens_all, 2)) +
             int(cfg.cmd_extra * CMD_BASE_Q)).astype(np.int32)
    copyq[:2] = 1 << 28
    dist_sym_bits_q = (dist_sym_bits * QB).astype(np.int32)
    if not lit_table:
        return litbits_q, copyq, dist_sym_bits_q
    # implicit-distance cell priced by landed length: a command whose
    # distance rides the joint cell pays no distance symbol
    icell_q = np.full(W, 1 << 28, np.int32)
    lc_all = np.searchsorted(prefix.COPY_BASE, np.maximum(lens_all, 2),
                             side="right") - 1
    if jh is not None and jh.sum() > 16:
        jtot = jh.sum()
        for c in range(W):
            cc = int(lc_all[c])
            if cc > 15:
                continue
            f = 0.2 + sum(jh[(64 if cc >= 8 else 0) + (ic << 3) + (cc & 7)]
                          for ic in range(8))
            icell_q[c] = int((-np.log2(f / jtot) +
                              prefix.COPY_EXTRA[cc]) * QB)
    else:
        icell_q = (copyq + dist_sym_bits_q[0]).astype(np.int32)
    icell_q[:2] = 1 << 28
    return litbits_q, copyq, dist_sym_bits_q, _ctx_tab2(), icell_q


def _seed_parse(arr: np.ndarray, max_distance: int, base: int,
                device=None, seed_q: int = DPConfig.seed_q):
    """Greedy/lazy seed parse for the DP. The native C matcher at
    `seed_q` when the input starts the stream (base == 0) and the
    window is a standard lgwin (maxback == 2^lgwin - 16); the device
    matcher at q5 on `device` otherwise, as the JAX package does."""
    lgwin = int(max_distance + 16).bit_length() - 1
    if (base == 0 and 10 <= lgwin <= 24 and
            C.max_backward_distance(lgwin) == max_distance):
        p, l, d = native.find_matches(np.ascontiguousarray(arr).tobytes(),
                                      seed_q, lgwin)
        z = np.zeros(len(p), np.int64)
        return (p.astype(np.int64), l.astype(np.int64), d.astype(np.int64),
                z)
    from .matcher import find_matches_device  # ops.matcher imports this
    return find_matches_device(arr, max_distance, quality=5, base=base,
                               use_dict=False, device=device)


def find_matches_optimal(data: np.ndarray, max_distance: int,
                         base: int = 0, on_block=None, mb_size=None,
                         device=None, *, dp=None):
    """Device q10/q11 parse: native seed -> host cost tables -> device
    DP per segment -> coalesce + dictionary post-pass. `dp`: the
    DPConfig (None = DPConfig()); with iterations > 1, each later pass
    prices with tables from the pass before and seeds with it too.

    v3 with one iteration dispatches the first segment early from a
    seed parse local to its window (cfg.fast_first), so the full-input
    seed and dictionary probe run while the card works on it.

    Streaming mode: with `on_block(mb_lo, mb_hi, matches)` set (and
    `mb_size`), finished metablock spans are emitted as soon as their
    segments are collected (v1 then runs one iteration). Returns None
    in that mode, else the (pos, len, dist, flag) int64 match
    arrays."""
    cfg = DPConfig() if dp is None else dp
    dev = resolve(device)
    n = len(data)
    arr = np.asarray(data)
    v3 = cfg.mode == "v3"
    iterations = 1 if on_block is not None and not v3 else cfg.iterations
    dev_big = upload_input(arr, n, dev) if v3 else None
    handles0 = None
    if (v3 and cfg.fast_first and n > SEG_V3 and base == 0 and
            iterations == 1):
        with trace.stage("dp.seed1"):
            seed1 = _seed_parse(arr[:SEG_V3], max_distance, base, dev,
                                cfg.seed_q)
        with trace.stage("dp.cost-tables1"):
            tables1 = _cost_tables(arr[:SEG_V3], seed1, lit_table=True,
                                   cfg=cfg)
        dict1 = _dict_probe_global(arr[:SEG_V3], [seed1], base,
                                   max_distance)
        handles0, _ = _dispatch_v3(arr, SEG_V3, max_distance, tables1,
                                   [seed1], dev_big, cfg, base,
                                   dict_g=dict1)
    with trace.stage("dp.seed"):
        seed = _seed_parse(arr, max_distance, base, dev, cfg.seed_q)
    m = lens = dists = flags = None
    for it in range(iterations):
        prev = seed if it == 0 else (m, lens, dists, flags)
        with trace.stage("dp.cost-tables"):
            tables = _cost_tables(arr, prev, lit_table=v3, cfg=cfg)
        seeds_list = [seed] if it == 0 else [seed, prev]
        if v3:
            early = handles0 is not None and it == 0
            handles, dict_table = _dispatch_v3(
                arr, n, max_distance, tables, seeds_list, dev_big,
                cfg, base, lo_start=SEG_V3 if early else 0)
            if early:
                # merge segment 1 (dispatched early) + its dict
                # probe's edges (flag recovery at collect needs
                # every position either probe selected)
                handles = handles0 + handles
                with trace.stage("dp.collect"):
                    dp0, _, dw0 = dict1
                    dpos_g, dwlen_g = dict_table
                    mp = np.concatenate([dp0.astype(np.int64), dpos_g])
                    mw = np.concatenate([dw0, dwlen_g])
                    order = np.argsort(mp, kind="stable")
                    mp, mw = mp[order], mw[order]
                    if len(mp):
                        keep = np.concatenate([[True], np.diff(mp) != 0])
                        mp, mw = mp[keep], mw[keep]
                    dict_table = (mp, mw)
            if (on_block is not None and it == iterations - 1 and
                    SEG_V3 % mb_size == 0):
                # stream: emit the first half's spans while the card
                # computes the rest. Groups cover whole metablocks
                # only when mb_size divides SEG_V3; otherwise fall
                # through to the full collect + one _emit_spans(0, n)
                _stream_v3(arr, handles, dict_table, n, mb_size,
                           max_distance, base, on_block)
                return None
            all_m, all_l, all_d, all_f = _collect_v3(
                handles, dict_table, max_distance, base)
        else:
            handles = _dispatch_v1(arr, n, max_distance, tables,
                                   seeds_list, cfg, dev)
            if on_block is not None:
                _stream_blocks(arr, handles, n, mb_size, max_distance,
                               base, on_block)
                return None
            all_m, all_l, all_d, all_f = [], [], [], []
            with trace.stage("dp.fetch"):
                for h in handles:
                    mm, ml, md = _collect_segment(*h)
                    if len(mm):
                        all_m.append(mm)
                        all_l.append(ml)
                        all_d.append(md)
                        all_f.append(np.zeros(len(mm), np.int64))
        if not all_m:
            z = np.zeros(0, np.int64)
            if on_block is not None:
                _emit_spans(arr, z, z, z, z, n, mb_size, max_distance,
                            base, on_block)
                return None
            return z, z, z, z
        with trace.stage("dp.collect"):
            m, lens, dists, flags = bridge_matches(arr, *_coalesce(
                np.concatenate(all_m), np.concatenate(all_l),
                np.concatenate(all_d), np.concatenate(all_f)))
    if on_block is not None:
        _emit_spans(arr, m, lens, dists, flags, n, mb_size, max_distance,
                    base, on_block)
        return None
    with trace.stage("dp.dict-post"):
        return add_dictionary_matches(arr, m, lens, dists, flags,
                                      max_distance, base)


def find_matches_optimal_sharded(arr, bounds, max_distance, devices,
                                 dp=None, seg=None):
    """The q10/q11 parse of the mesh (optimal_jax.find_matches_optimal_
    sharded): shard si's DP runs on devices[si]; a device named more
    than once queues its shards there.

    Per shard, on a thread pool: up to `seg` bytes of the input before
    it as candidate window history, so matches reach across the seam;
    the seed parse (native for the shard that
    starts the stream, else the device matcher, K2, on its device); the
    cost tables; the dictionary probe. Then per round k every shard's
    k-th segment runs `dp_v3_segment` on its device, all padded to one
    common bucket. A shard already out of segments runs nothing: the
    JAX mesh's one program runs a zero segment there and drops its
    result, but the port queues each device on its own. Then per shard:
    the collect, coalesce, bridge and dictionary post-pass, keeping the
    matches past its halo.

    `seg`: the DP segment, which is also the halo's cap; None means
    SEG_V3 with the BUCKETS_V3 pads, any other size pads to itself (the
    JAX package's dry run sets SEG_V3 and its buckets to 64 KiB so); on
    the card a multiple of 16, as K9 and K10 read the segment in aligned
    16-byte chunks (their wrappers raise otherwise).

    Of `dp` (a DPConfig, None = the default) only what the JAX mesh's
    functions read reaches this path: ring_scan and icell (K8 in place
    of K3), level3, the cost knobs and seed_q. The JAX mesh always runs
    v3 and reads neither BROTLI_TPU_DP, DP_ITERS nor FAST_FIRST, so
    `mode`, `iterations` and `fast_first` are ignored here.

    Returns per-shard (m, lens, dists, flags) with m relative to the
    shard's [lo, hi) span."""
    cfg = DPConfig() if dp is None else dp
    n_shards = len(bounds) - 1
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards, {len(devices)} devices")
    devs = [resolve(d) for d in devices]
    seg, buckets = (SEG_V3, BUCKETS_V3) if seg is None else (seg, [seg])
    carried = trace.carry()  # the pool's threads work for this request

    def prep_shard(si):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        h = min(int(max_distance), lo, seg)
        buf = np.ascontiguousarray(arr[lo - h:hi])
        base = lo - h
        with trace.adopt(carried):
            with trace.stage("dp.seed"):
                seed = _seed_parse(buf, max_distance, base, devs[si],
                                   cfg.seed_q)
            with trace.stage("dp.cost-tables"):
                tables = _cost_tables(buf, seed, lit_table=True, cfg=cfg)
            dict_g = _dict_probe_global(buf, [seed], base, max_distance)
        return dict(lo=lo, hi=hi, h=h, buf=buf, base=base, seed=seed,
                    tables=tables, dict_g=dict_g)

    with futures.ThreadPoolExecutor(max_workers=min(n_shards, 8)) as ex:
        shards = list(ex.map(prep_shard, range(n_shards)))

    # one common bucket: the JAX mesh compiles one program for every
    # (shard, round)
    b = max(_bucket_in(min(len(s["buf"]), seg), buckets) for s in shards)
    capm = b // CAPM_DIV
    rounds = max((len(s["buf"]) + seg - 1) // seg for s in shards)
    for s, dev in zip(shards, devs):
        s["dtabs"] = device_tables(s["tables"], dev)
        s["icell"] = torch.from_numpy(s["tables"][4].astype(np.int32)).to(
            dev) if cfg.icell else None

    handles = [[] for _ in range(n_shards)]
    for k in range(rounds):
        lo_k = k * seg
        for si, (s, dev) in enumerate(zip(shards, devs)):
            nbuf = len(s["buf"])
            if lo_k >= nbuf:  # shard exhausted
                continue
            hi_k = min(lo_k + seg, nbuf)
            padded = np.zeros(b, np.uint8)
            padded[:hi_k - lo_k] = s["buf"][lo_k:hi_k]
            npos, spos, slen, sdist, dloc, dval = segment_inputs(
                s["buf"], [s["seed"]], s["dict_g"], lo_k, hi_k, b, dev)
            bits_tab, ctx_tab, copyq, distq = s["dtabs"]
            with trace.stage("dp.dispatch"):
                packed, full = dp_v3_segment(
                    torch.from_numpy(padded).to(dev), npos, max_distance,
                    bits_tab, ctx_tab, copyq, distq, spos, slen, sdist,
                    dloc, dval, lo_k + s["base"], capm=capm, cfg=cfg,
                    icell_q=s["icell"])
            handles[si].append((lo_k, capm, packed, full, fetch.mark(dev)))

    out = []
    for si, s in enumerate(shards):
        all_m, all_l, all_d, all_f = _collect_v3(
            handles[si], (s["dict_g"][0].astype(np.int64), s["dict_g"][2]),
            max_distance, s["base"])
        if not all_m:
            z = np.zeros(0, np.int64)
            out.append((z, z, z, z))
            continue
        with trace.stage("dp.collect"):
            m, lens, dists, flags = bridge_matches(s["buf"], *_coalesce(
                np.concatenate(all_m), np.concatenate(all_l),
                np.concatenate(all_d), np.concatenate(all_f)))
        with trace.stage("dp.dict-post"):
            m, lens, dists, flags = add_dictionary_matches(
                s["buf"], m, lens, dists, flags, max_distance, s["base"])
        keep = m >= s["h"]
        out.append((m[keep] - s["h"], lens[keep], dists[keep],
                    flags[keep]))
    return out


def _stream_v3(arr, handles, dict_table, n, mb_size, max_distance,
               base, on_block):
    """Chunked streaming collect: fetch the first half of the segments
    and emit their spans (native serialization on the host worker)
    while the card still computes the second half. Segment boundaries
    are hard parse boundaries and mb_size divides SEG_V3, so each group
    covers whole metablocks."""
    half = (len(handles) + 1) // 2
    z = np.zeros(0, np.int64)
    for group in (handles[:half], handles[half:]):
        if not group:
            continue
        glo = group[0][0]
        ghi = min(group[-1][0] + SEG_V3, n)
        am, al, ad, af = _collect_v3(group, dict_table, max_distance,
                                     base)
        if am:
            with trace.stage("dp.collect"):
                gm, gl, gd, gf = bridge_matches(arr, *_coalesce(
                    np.concatenate(am), np.concatenate(al),
                    np.concatenate(ad), np.concatenate(af)))
        else:
            gm = gl = gd = gf = z
        _emit_spans(arr, gm, gl, gd, gf, n, mb_size, max_distance,
                    base, on_block, lo=glo, hi=ghi)


def _emit_spans(arr, m, lens, dists, flags, n, mb_size, max_distance,
                base, on_block, lo=0, hi=None):
    """Emit the finished parse as metablock spans ([lo, hi) restricts
    to one collected group's span range)."""
    pm, pl, pd, pf = m, lens, dists, flags
    emitted = lo
    if hi is None:
        hi = n
    while emitted < hi:
        mb_hi = min(emitted + mb_size, n)
        with trace.stage("dp.span-split"):
            pm, pl, pd, pf = split_matches_at(
                pm, pl, pd, pf, [mb_hi, n + 1])
            take = pm < mb_hi
            bm, bl, bd, bf = pm[take], pl[take], pd[take], pf[take]
            pm, pl, pd, pf = (pm[~take], pl[~take], pd[~take],
                              pf[~take])
        with trace.stage("dp.dict-post"):
            bm, bl, bd, bf = add_dictionary_matches(
                arr[:mb_hi], bm, bl, bd, bf, max_distance, base,
                active_from=emitted)
        on_block(emitted, mb_hi, (bm, bl, bd, bf))
        emitted = mb_hi
