"""Position-in-UTF8-codepoint literal cost model for the optimal parse
(role parity: c/enc/literal_cost.c BrotliEstimateBitCostsForLiterals).

The reference slides a +-495-byte window per byte; here the window is
blockwise (256-byte blocks, each costed against the histogram of its
+-2 neighbor blocks, a ~1280-byte centered window) so the whole model
is a handful of bincounts and gathers -- no per-byte loop. Class
definition, cost formula, squash and prologue surcharge follow the
reference exactly.
"""

import numpy as np

_BLOCK = 256
_NEIGH = 2  # +-2 blocks -> ~1280-byte window (ref: +-495)


def utf8_positions(data: np.ndarray, max_utf8: int) -> np.ndarray:
    """Class of each position: 0 = codepoint start (or ASCII), 1 =
    byte 2, 2 = byte 3 (clamped); literal_cost.c:20-33."""
    n = len(data)
    c = np.zeros(n, np.int64)   # previous byte
    last = np.zeros(n, np.int64)  # byte before that
    c[1:] = data[:-1]
    last[2:] = data[:-2]
    pos = np.where(c < 128, 0,
                   np.where(c >= 192, min(1, max_utf8),
                            np.where(last < 0xE0, 0, min(2, max_utf8))))
    return pos


def stats_level(data: np.ndarray) -> int:
    """DecideMultiByteStatsLevel (literal_cost.c:35-53)."""
    pos = utf8_positions(data, 2)
    counts = np.bincount(pos, minlength=3)
    max_utf8 = 1  # ref: "should be 2, but 1 compresses better"
    if counts[2] < 500:
        max_utf8 = 1
    if counts[1] + counts[2] < 25:
        max_utf8 = 0
    return max_utf8


def is_mostly_utf8(data: np.ndarray, min_ratio: float = 0.75) -> bool:
    from .context_model import choose_context_mode
    return choose_context_mode(data) == 2


def estimate_literal_bits(data: np.ndarray) -> np.ndarray:
    """Per-position literal bit cost, float32. UTF8 inputs get the
    3-class position-in-codepoint model; binary inputs a plain sliding
    histogram (both windowed locally)."""
    n = len(data)
    if n == 0:
        return np.zeros(0, np.float32)
    d = data.astype(np.int64)
    if is_mostly_utf8(data):
        max_utf8 = stats_level(data)
        cls = utf8_positions(data, max_utf8)
        ncls = 3
    else:
        cls = np.zeros(n, np.int64)
        ncls = 1
    nb = (n + _BLOCK - 1) // _BLOCK
    blk = np.arange(n) // _BLOCK
    # per-block histograms over (class, byte)
    hist = np.bincount((blk * ncls + cls) * 256 + d,
                       minlength=nb * ncls * 256).reshape(nb, ncls, 256)
    # windowed: each block sums its +-_NEIGH neighbors
    csum = np.concatenate([np.zeros((1, ncls, 256), hist.dtype),
                           np.cumsum(hist, axis=0)])
    lo = np.maximum(np.arange(nb) - _NEIGH, 0)
    hi = np.minimum(np.arange(nb) + _NEIGH + 1, nb)
    win = csum[hi] - csum[lo]               # (nb, ncls, 256)
    tot = win.sum(axis=2)                    # (nb, ncls)
    histo = win[blk, cls, d].astype(np.float64)
    np.maximum(histo, 1.0, out=histo)
    cost = (np.log2(np.maximum(tot[blk, cls], 1)) - np.log2(histo) +
            0.02905)
    # squash cheap symbols toward 1 bit (literal_cost.c:113-116)
    cheap = cost < 1.0
    cost[cheap] = cost[cheap] * 0.5 + 0.5
    # prologue surcharge (literal_cost.c:117-124)
    prologue = min(2000, n)
    i = np.arange(prologue, dtype=np.float64)
    cost[:prologue] += 0.35 + (0.35 / 2000.0) * i
    return cost.astype(np.float32)
