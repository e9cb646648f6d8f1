"""Optimal backward-reference finder (research tool; copy of
brotli_tpu.tools.optref).

Role parity: research/find_opt_references.cc -- for every position,
the longest match against any earlier position (the "longest previous
factor"), emitted as `position distance length` records for
draw_histogram.py. The reference builds a sais suffix array; here the
suffix array comes from vectorized prefix-doubling (O(n log^2 n) numpy
sorts), LCP from Kasai's algorithm, and the LPF from the classic
delete-in-decreasing-position linked-list sweep (Crochemore & Ilie).
"""

import sys

import numpy as np


def suffix_array(data: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array, fully vectorized."""
    n = len(data)
    if n == 0:
        return np.zeros(0, np.int64)
    rank = data.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    tmp = np.zeros(n, np.int64)
    while k < n:
        key2 = np.full(n, -1, np.int64)
        key2[:n - k] = rank[k:]
        sa = np.lexsort((key2, rank))
        tmp[sa[0]] = 0
        r1 = rank[sa[1:]] != rank[sa[:-1]]
        r2 = key2[sa[1:]] != key2[sa[:-1]]
        tmp[sa[1:]] = np.cumsum(r1 | r2)
        rank = tmp.copy()
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


def lcp_array(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai: lcp[r] = LCP(suffix sa[r], suffix sa[r-1]); lcp[0] = 0."""
    n = len(data)
    rank = np.zeros(n, np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, np.int64)
    h = 0
    for i in range(n):
        r = int(rank[i])
        if r > 0:
            j = int(sa[r - 1])
            while i + h < n and j + h < n and data[i + h] == data[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


def longest_previous_factor(data: np.ndarray):
    """(length, source) of the longest match at each position against
    any EARLIER position; length 0 when none. Exact (LPF)."""
    n = len(data)
    sa = suffix_array(data)
    lcp = lcp_array(data, sa)
    rank = np.zeros(n, np.int64)
    rank[sa] = np.arange(n)
    prv = np.arange(-1, n - 1)   # linked list over SA ranks
    nxt = np.arange(1, n + 1)
    lcp_w = lcp.copy()           # lcp_w[r] = LCP(list-prev(r), r)
    best_len = np.zeros(n, np.int64)
    best_src = np.full(n, -1, np.int64)
    for i in range(n - 1, -1, -1):
        r = int(rank[i])
        p, q = int(prv[r]), int(nxt[r])
        # neighbors now hold only positions < i
        if p >= 0 and lcp_w[r] > best_len[i]:
            best_len[i] = lcp_w[r]
            best_src[i] = sa[p]
        if q < n and lcp_w[q] > best_len[i]:
            best_len[i] = lcp_w[q]
            best_src[i] = sa[q]
        # delete r from the list
        if q < n:
            lcp_w[q] = min(lcp_w[q], lcp_w[r])
            prv[q] = p
        if p >= 0:
            nxt[p] = q
    return best_len, best_src


def find_references(data: np.ndarray, min_length: int = 1):
    """Records (position, distance, length), one per position with a
    match (find_opt_references.cc simple mode)."""
    ln, src = longest_previous_factor(data)
    sel = np.flatnonzero(ln >= max(min_length, 1))
    return sel, sel - src[sel], ln[sel]


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="optimal backward references (research tool)")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--min_length", type=int, default=4)
    args = ap.parse_args(argv)
    data = np.fromfile(args.input, dtype=np.uint8)
    pos, dist, ln = find_references(data, args.min_length)
    with open(args.output, "w") as f:
        for p, d, l2 in zip(pos, dist, ln):
            f.write(f"{p} {d} {l2}\n")
    print(f"{len(pos)} references", file=sys.stderr)


if __name__ == "__main__":
    main()
