"""2nd-order literal context modeling + histogram clustering (q>=5).

Per-context literal histograms are accumulated with LUT gathers
(vector ops); clustering is greedy agglomerative over entropy cost --
a batched O(k^2) reduction over at most 64 histograms, which maps to
one small matrix op per merge on device. (Parity anchors:
c/enc/metablock.c BrotliBuildMetaBlock, c/enc/cluster_inc.h,
c/common/context.h.)
"""

import numpy as np

from ..format import constants as C
from ..format import context as ctx


def choose_context_mode(data: np.ndarray) -> int:
    """UTF8 for mostly-UTF8 data, SIGNED otherwise (parity:
    c/enc/encode.c ChooseContextMode / utf8_util)."""
    if len(data) == 0:
        return ctx.CONTEXT_LSB6
    sample = data[:1 << 16]
    ascii_ish = np.mean((sample < 128) | (sample >= 0xC2))
    return ctx.CONTEXT_UTF8 if ascii_ish > 0.75 else ctx.CONTEXT_SIGNED


def literal_context_ids(data: np.ndarray, lit_pos: np.ndarray,
                        mode: int, floor: int = 0) -> np.ndarray:
    """Context id of each literal position (vectorized LUT gather).

    `floor`: stream start within `data` (decoder sees zeros before it,
    e.g. when `data` carries a dictionary prefix)."""
    lut0, lut1 = ctx.context_lut(mode)
    p1 = np.where(lit_pos >= floor + 1, data[np.maximum(lit_pos - 1, 0)], 0)
    p2 = np.where(lit_pos >= floor + 2, data[np.maximum(lit_pos - 2, 0)], 0)
    return (lut0[p1] | lut1[p2]).astype(np.int64)


def context_histograms(values: np.ndarray, ctx_ids: np.ndarray,
                       num_contexts: int, alphabet: int) -> np.ndarray:
    """hist[c, v] = count of value v in context c (one bincount)."""
    flat = ctx_ids * alphabet + values.astype(np.int64)
    h = np.bincount(flat, minlength=num_contexts * alphabet)
    return h.reshape(num_contexts, alphabet)


def _pop_cost(hist: np.ndarray) -> float:
    """Approximate bits to store symbols + code description."""
    total = hist.sum()
    if total == 0:
        return 12.0
    nz = hist > 0
    p = hist[nz] / total
    bits = float(-(hist[nz] * np.log2(p)).sum())
    # code description overhead estimate (lengths RLE)
    return bits + 14.0 + 4.0 * int(nz.sum()) ** 0.5


def _entropy_bits(H: np.ndarray) -> np.ndarray:
    """Shannon bits of histogram rows (batched; 0 log 0 := 0)."""
    T = H.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.where(H > 0, np.log2(np.maximum(H, 1) /
                                     np.maximum(T, 1)), 0.0)
    return -(H * lg).sum(axis=-1)


DESC_BITS_PER_SYMBOL = 1.5  # serialized-tree cost per used symbol
# (code-description role of BrotliPopulationCost; swept on the native
# serializer: dense binary histograms stop over-splitting)


def cluster_histograms(hists: np.ndarray, max_trees: int,
                       table_cost_bits: float = 60.0):
    """Greedy agglomerative clustering by entropy-cost delta, with the
    pairwise merge-gain matrix computed as one batched reduction per
    step (maps to a single matrix op on device). Merge gains include a
    support-size tree-description estimate: desc(a) + desc(b) -
    desc(merged), desc = DESC_BITS_PER_SYMBOL * nnz.

    Returns (assignment int array over input histograms, merged
    histograms in tree order).
    """
    k = len(hists)
    if k > 128:
        # hierarchical: pre-cluster fixed-size slices to bound the
        # pairwise tensor, then cluster the survivors jointly
        slice_sz = 64
        sub_assign = np.zeros(k, np.int64)
        sub_hists = []
        offset = 0
        # pre-cluster budget must be < slice_sz so every level shrinks
        # the survivor set (a budget >= slice_sz can leave all rows
        # unmerged -> the joint call recurses on the same k forever)
        pre_budget = min(max(max_trees, 16), slice_sz // 2)
        for lo in range(0, k, slice_sz):
            a, h = cluster_histograms(hists[lo:lo + slice_sz],
                                      pre_budget, table_cost_bits)
            sub_assign[lo:lo + slice_sz] = a + offset
            offset += len(h)
            sub_hists.append(h)
        joint_a, joint_h = cluster_histograms(
            np.concatenate(sub_hists), max_trees, table_cost_bits)
        return joint_a[sub_assign], joint_h
    H = hists.astype(np.float64)
    groups = [[i] for i in range(k)]
    alive = np.ones(k, bool)
    cost = _entropy_bits(H)
    desc = DESC_BITS_PER_SYMBOL * (H > 0).sum(axis=-1)
    # pairwise merge costs once; incremental row/col updates per merge
    pair = _entropy_bits(H[:, None, :] + H[None, :, :])
    gain = (cost[:, None] + cost[None, :] - pair + table_cost_bits +
            desc[:, None] + desc[None, :] -
            np.maximum(desc[:, None], desc[None, :]))
    np.fill_diagonal(gain, -np.inf)
    n_alive = k
    while n_alive > 1:
        idx = np.argmax(gain)
        a, b = np.unravel_index(idx, gain.shape)
        if gain[a, b] <= 0 and n_alive <= max_trees:
            break
        a, b = min(a, b), max(a, b)
        H[a] += H[b]
        groups[a].extend(groups[b])
        groups[b] = None
        alive[b] = False
        gain[b, :] = -np.inf
        gain[:, b] = -np.inf
        n_alive -= 1
        cost[a] = _entropy_bits(H[a][None])[0]
        desc[a] = DESC_BITS_PER_SYMBOL * int((H[a] > 0).sum())
        live = np.flatnonzero(alive)
        pr = _entropy_bits(H[a][None, :] + H[live])
        g = (cost[a] + cost[live] - pr + table_cost_bits +
             desc[a] + desc[live] - np.maximum(desc[a], desc[live]))
        gain[a, live] = g
        gain[live, a] = g
        gain[a, a] = -np.inf
    out_groups = [g for g in groups if g]
    assignment = np.zeros(k, dtype=np.int64)
    merged = []
    for t, g in enumerate(out_groups):
        assignment[g] = t
        merged.append(H[g[0]])
    return assignment, np.asarray(merged).astype(np.int64)


def mtf_transform(values: np.ndarray) -> np.ndarray:
    """Forward move-to-front (inverse of the decoder's IMTF)."""
    mtf = list(range(256))
    out = np.empty_like(values)
    for i, v in enumerate(values):
        j = mtf.index(int(v))
        out[i] = j
        mtf.pop(j)
        mtf.insert(0, int(v))
    return out
