"""The device LZ matcher (q<=9), the PyTorch/CUDA counterpart of
brotli_tpu.ops.matcher_jax: sort-carry candidates, the greedy chain
walk (K2) and a compaction, per segment of the input.

Per segment the card sorts every position by (hash, coarse position),
carrying the 16 data bytes at it, so the k nearest prior occurrences of
a hash are the k previous rows and candidate distance and capped match
length are shifted-vector ops. The best (len, dist) go back to position
order by the inverse permutation of the sort (its key order is the
position, so no second sort is needed), a score gate and lazy matching
give each position's skip, K2 walks the greedy chain, and a stable sort
compacts the taken matches so only they cross to the host. The host
extends matches that hit the 16-byte cap and probes the static
dictionary in the gaps.

uint32 lanes of the JAX code ride in int64 tensors (utils/u32.py); the
sorts are stable, as `lax.sort` is. Every result is bit-equal to the
JAX package.
"""

import numpy as np
import torch

from ..enc.matcher import MIN_MATCH, _extend_capped, add_dictionary_matches
from ..utils import fetch, trace, u32
from ..utils.device import resolve
from .chain import chain_select
from .optimal import _shift_up, _tz_bytes_u32

HASH_MUL = 0x1E35A7BD
CAP = 16  # parallel match-length cap (bytes); the host extends cap-hits

# pad buckets (the JAX package's: one compiled shape per bucket there)
_BUCKETS = [1 << 20, 1 << 23]
SEG_BYTES = _BUCKETS[-1]
MASK25 = (1 << 25) - 1


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def match_skip(data, npos: int, max_distance: int, num_candidates: int = 2):
    """The part of match_block before the chain walk: every position's
    best capped match (len, dist) and its skip (the match length where
    the greedy parse would take the match there, else 1), each int64
    (n,) in position order. data: uint8 (n,) on the device, padded."""
    n = data.shape[0]
    dev = data.device
    d = data.to(torch.int64)
    # 16 data bytes at every position as 4 little-endian words; roll
    # wraps at the bucket end like jnp.roll (the npos + 3 clamp below
    # relies on that)
    w0 = (d | (torch.roll(d, -1) << 8) | (torch.roll(d, -2) << 16) |
          (torch.roll(d, -3) << 24))
    w = [w0, torch.roll(w0, -4), torch.roll(w0, -8), torch.roll(w0, -12)]
    h = u32.shr(u32.mul(w0, HASH_MUL), 15)  # 17-bit hash
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    # packed key hash << 14 | pos >> 9 (not unique: only a stable sort
    # gives the JAX package's order); padding rows get unique high keys
    key = torch.where(pos < npos, (h << 14) | (pos >> 9), (1 << 31) | pos)
    key_s, order = torch.sort(key, stable=True)
    pos_s = order
    w_s = [x[order] for x in w]
    h_s = key_s >> 14
    live = key_s < (1 << 31)

    best_len_s = torch.zeros(n, dtype=torch.int64, device=dev)
    best_dist_s = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(1, num_candidates + 1):
        same = (h_s == _shift_up(h_s, k, u32.MASK32)) & live
        dist = pos_s - _shift_up(pos_s, k, -1)
        valid = same & (dist > 0) & (dist <= max_distance)
        # capped common-prefix length via carried-word compares
        mlen = torch.zeros(n, dtype=torch.int64, device=dev)
        alive = valid
        for ws in w_s:
            x = ws ^ _shift_up(ws, k, 0)
            mlen = mlen + torch.where(alive, _tz_bytes_u32(x), 0)
            alive = alive & (x == 0)
        mlen = torch.where(valid, mlen, 0)
        better = mlen > best_len_s
        best_len_s = torch.where(better, mlen, best_len_s)
        best_dist_s = torch.where(better, dist, best_dist_s)

    # matches must not run into the padded tail (w words wrap at n)
    best_len_s = torch.minimum(best_len_s,
                               torch.clamp(npos + 3 - pos_s, min=0))
    # back to position order: the sort's inverse permutation
    best_len = torch.empty_like(best_len_s)
    best_len[order] = best_len_s
    best_dist = torch.empty_like(best_dist_s)
    best_dist[order] = best_dist_s

    # score gate (longer minimum match for far distances) and lazy
    # matching (defer to a strictly longer match at pos + 1)
    min_len = torch.where(best_dist >= (1 << 18), 6,
                          torch.where(best_dist >= (1 << 12), 5, MIN_MATCH))
    take = best_len >= min_len
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    nxt_len = torch.cat([best_len[1:], zero])
    nxt_take = torch.cat([take[1:], zero.bool()])
    take = take & ~(nxt_take & (nxt_len > best_len + 1))
    skip = torch.where(take, torch.clamp(best_len, max=n), 1)
    return best_len, best_dist, skip


def match_block(data, npos: int, max_distance: int, num_candidates: int = 2,
                start: int = 0):
    """Greedy-selected matches of one padded segment, compacted.

    data: uint8 (n,) on the device. `start`: first match-eligible
    position (positions before it are window history). Returns (count,
    packed, err): count an int64 scalar tensor, packed int64 (2, n // 4)
    holding uint32 values, packed[0, :count] the match positions and
    packed[1, :count] = len << 25 | dist, in position order; the rest
    holds the other positions in order, as the JAX package's sort
    leaves them. err, an int64 scalar tensor, is K2's error flag
    (non-zero when a skip lay outside [1, 16]), unread."""
    n = data.shape[0]
    best_len, best_dist, skip = match_skip(data, npos, max_distance,
                                           num_candidates)
    # greedy parse: the chain walk (K2 on the card)
    selm, err = chain_select(skip.to(torch.int32), n, start)
    pos = torch.arange(n, dtype=torch.int64, device=data.device)
    taken = selm > 0
    key = torch.where(taken, pos, u32.MASK32)
    packed = (best_len << 25) | best_dist
    key_c, order = torch.sort(key, stable=True)
    nslots = n // MIN_MATCH
    count = taken.sum()
    return (count, torch.stack([key_c[:nslots], packed[order[:nslots]]]),
            err[0].to(torch.int64))


def _run_segment(padded: np.ndarray, npos: int, max_distance: int,
                 ncand: int, start: int, device):
    """Queue one segment on the device (nothing waits for it); returns
    (count, err, packed, event) handles, the event recorded after it."""
    dev_data = torch.from_numpy(padded).to(device)
    count, out, err = match_block(dev_data, npos, max_distance,
                                  num_candidates=ncand, start=start)
    return count, err, out, fetch.mark(device)


def _collect_segment(handles):
    """Read back one segment's compacted matches (blocking until the
    segment is done, and only it). Raises ValueError when K2 met a skip
    outside [1, 16]."""
    count, err, out, ev = handles
    cnt, bad = fetch.fetch_after([ev], [count, err]).tolist()
    if bad:
        raise ValueError("chain_select: a skip lies outside [1, 16]")
    if cnt == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    # bucket the readback size, as the JAX package does
    k = 1 << max(int(np.ceil(np.log2(cnt))), 10)
    k = min(k, out.shape[1])
    host = fetch.fetch_after([ev], [out[:, :k]])[0].numpy()
    m = host[0, :cnt].astype(np.int64)
    pay = host[1, :cnt]
    lens = (pay >> 25).astype(np.int64)
    dists = (pay & MASK25).astype(np.int64)
    return m, lens, dists


def _post_segment(buf, handles, start, base, max_distance, use_dict):
    """The host's post-pass over one segment queued with `_run_segment`:
    read back its matches, extend the cap-hit ones, probe the static
    dictionary over weak-match gaps when `use_dict`, and keep the
    matches from `start` on (buf[:start] is window history). `base` is
    the absolute stream offset of buf[0]. Returns (pos, len, dist,
    flag) with pos relative to `start`."""
    with trace.stage("match.fetch"):
        m, lens, dists = _collect_segment(handles)
    flags = np.zeros(len(m), np.int64)
    with trace.stage("match.extend"):
        m, lens, dists, flags = _extend_capped(buf, m, lens, dists, flags,
                                               CAP, 1 << 24)
    if use_dict:
        with trace.stage("match.dict-post"):
            m, lens, dists, flags = add_dictionary_matches(
                buf, m, lens, dists, flags, max_distance, base,
                active_from=start)
    keep = m >= start
    return m[keep] - start, lens[keep], dists[keep], flags[keep]


def find_matches_device(data: np.ndarray, max_distance: int,
                        quality: int = 1, base: int = 0, use_dict=None,
                        device=None):
    """The device matcher over a whole input (the device branch of
    find_matches_jax): pad segments to buckets, queue every segment on
    `device` (None = "cuda"), then collect them in order, extend
    cap-hit matches and probe the static dictionary on the host.

    Segments advance by half a buffer; the other half carries window
    history so matches reach across segment seams. `base` is the
    absolute stream offset of data[0]. Returns (pos, len, dist, flag)
    int64 arrays."""
    dev = resolve(device)
    if use_dict is None:
        use_dict = quality >= 5
    ncand = 4 if quality >= 5 else 2
    n = len(data)
    adv = SEG_BYTES // 2 if n > SEG_BYTES else SEG_BYTES
    handles = []
    for lo in range(0, n, adv):
        hi = min(lo + adv, n)
        ctx_lo = max(0, lo - (SEG_BYTES - adv))
        buf = np.asarray(data[ctx_lo:hi])
        b = _bucket(len(buf))
        padded = np.zeros(b, np.uint8)
        padded[:len(buf)] = buf
        npos = max(len(buf) - 3, 0)
        with trace.stage("match.dispatch"):
            handles.append((lo, ctx_lo, buf, _run_segment(
                padded, npos, max_distance, ncand, lo - ctx_lo, dev)))
    all_m, all_l, all_d, all_f = [], [], [], []
    for lo, ctx_lo, buf, h in handles:
        m, m_l, m_d, m_f = _post_segment(buf, h, lo - ctx_lo, base + ctx_lo,
                                         max_distance, use_dict)
        all_m.append(m + lo)
        all_l.append(m_l)
        all_d.append(m_d)
        all_f.append(m_f)
    if not all_m:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    return (np.concatenate(all_m), np.concatenate(all_l),
            np.concatenate(all_d), np.concatenate(all_f))
