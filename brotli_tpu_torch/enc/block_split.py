"""Block splitting: partition the literal/command streams into block
types with separate entropy codes (RFC 6; parity anchor
c/enc/block_splitter.c + block_splitter_inc.h -- redesigned as batched
chunk clustering instead of sampled iterative refinement).

Chunks of the symbol stream get per-chunk histograms (one bincount);
k-means-style refinement against seed histograms runs as a (chunks x
types x alphabet) batched cost reduction; adjacent same-type chunks
merge into blocks.
"""

import numpy as np

from .context_model import _entropy_bits


def split_symbols(symbols: np.ndarray, alphabet: int,
                  chunk: int = 512, max_types: int = 8,
                  min_chunks: int = 8):
    """Returns (block_types, block_lengths, type_of_symbol) or None when
    splitting isn't worthwhile (single type)."""
    n = len(symbols)
    if n < chunk * min_chunks or max_types <= 1:
        return None
    nch = n // chunk
    trimmed = symbols[:nch * chunk].reshape(nch, chunk)
    # per-chunk histograms in one pass
    offs = (np.arange(nch, dtype=np.int64) * alphabet)[:, None]
    H = np.bincount((trimmed + offs).ravel(),
                    minlength=nch * alphabet).reshape(nch, alphabet)
    H = H.astype(np.float64)

    # seed types from evenly spaced chunks, then refine assignments
    k = min(max_types, max(2, nch // 4))
    seeds = H[np.linspace(0, nch - 1, k).astype(int)].copy()
    assign = np.zeros(nch, np.int64)
    for _ in range(4):
        # cost of each chunk under each seed: cross-entropy bits
        T = seeds.sum(axis=1, keepdims=True)
        with np.errstate(divide="ignore"):
            logp = np.log2(np.maximum(seeds, 0.5) / np.maximum(T, 1))
        cost = -(H @ logp.T)  # (nch, k) -- batched matmul (MXU-friendly)
        new_assign = np.argmin(cost, axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for t in range(k):
            sel = assign == t
            seeds[t] = H[sel].sum(axis=0) + 1e-3 if sel.any() else seeds[t]

    # smooth: merge isolated single-chunk islands into neighbors
    for i in range(1, nch - 1):
        if assign[i] != assign[i - 1] and assign[i] != assign[i + 1]:
            assign[i] = assign[i - 1]

    # drop the split if it doesn't actually help (entropy gain check)
    base_cost = float(_entropy_bits(H.sum(axis=0)[None, :])[0])
    split_cost = 0.0
    for t in np.unique(assign):
        split_cost += float(_entropy_bits(
            H[assign == t].sum(axis=0)[None, :])[0])
    nswitches = int(np.count_nonzero(np.diff(assign)))
    overhead = 256 * len(np.unique(assign)) + 12 * nswitches + 100
    if base_cost - split_cost < overhead:
        return None

    # renumber types in first-appearance order & build runs
    remap = {}
    seq = []
    for t in assign:
        if int(t) not in remap:
            remap[int(t)] = len(remap)
        seq.append(remap[int(t)])
    seq = np.array(seq, np.int64)
    if len(remap) <= 1:
        return None
    change = np.flatnonzero(np.diff(seq)) + 1
    run_starts = np.concatenate([[0], change])
    run_types = seq[run_starts]
    run_len_chunks = np.diff(np.concatenate([run_starts, [nch]]))
    block_lengths = run_len_chunks * chunk
    block_lengths[-1] += n - nch * chunk  # tail joins the last block
    type_of_symbol = np.repeat(run_types, block_lengths)
    return run_types, block_lengths, type_of_symbol
