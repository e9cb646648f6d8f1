"""Custom-dictionary generator (copy of brotli_tpu.tools.dictgen; role
parity: research/dictionary_generator.cc with its deorummolae/sieve/durchschlag engines -- re-designed as one
vectorized pipeline instead of three C++ engines).

Mines a corpus for high-value repeated substrings with a
prefix-doubling suffix sort + capped LCP scan (all NumPy array ops,
the same batched style as the encoder), scores candidates by
(occurrences - 1) * length - overhead, and packs winners into a raw
LZ77 dictionary. The most valuable strings go at the END of the
dictionary where compound-dictionary distances are cheapest
(enc/encoder._lift_dictionary_matches: distance grows with D - src).

Usage:
  python -m brotli_tpu_torch.tools.dictgen --size 16384 -o dict.bin FILES...
"""

import argparse
import os
import pathlib
import sys

import numpy as np

MIN_LEN = 6
MAX_LEN = 256


def suffix_sort(data: np.ndarray, max_doubling: int = 9) -> np.ndarray:
    """Order of suffixes by their first 2^max_doubling bytes
    (prefix-doubling over np.lexsort; plenty for MAX_LEN-capped LCP)."""
    n = len(data)
    rank = data.astype(np.int64)
    k = 1
    for _ in range(max_doubling):
        if k >= n:
            break
        rank2 = np.concatenate([rank[k:], np.full(k, -1, np.int64)])
        order = np.lexsort((rank2, rank))
        # re-rank
        r_o = rank[order]
        r2_o = rank2[order]
        new = np.concatenate(
            [[0], np.cumsum((r_o[1:] != r_o[:-1]) |
                            (r2_o[1:] != r2_o[:-1]))])
        rank = np.empty(n, np.int64)
        rank[order] = new
        if new[-1] == n - 1:
            break
        k <<= 1
    return np.argsort(rank, kind="stable")


def _lcp_adjacent(data: np.ndarray, sa: np.ndarray,
                  cap: int = MAX_LEN) -> np.ndarray:
    """LCP of adjacent sorted suffixes, capped (chunked vector compare)."""
    n = len(data)
    a, b = sa[:-1], sa[1:]
    lcp = np.zeros(len(a), np.int64)
    alive = np.ones(len(a), bool)
    step = 32
    for off in range(0, cap, step):
        if not alive.any():
            break
        idx = np.flatnonzero(alive)
        pa = a[idx] + off
        pb = b[idx] + off
        span = np.arange(step)
        xa = data[np.minimum(pa[:, None] + span, n - 1)]
        xb = data[np.minimum(pb[:, None] + span, n - 1)]
        limit = np.minimum(n - pa, n - pb)[:, None] > span
        eq = (xa == xb) & limit
        first = np.where(eq.all(axis=1), step, np.argmin(eq, axis=1))
        lcp[idx] += first
        alive[idx] = first == step
    return lcp


def generate(corpus: bytes, dict_size: int = 16384,
             min_len: int = MIN_LEN, block: int = 1024) -> bytes:
    """Build a raw LZ77 dictionary of <= dict_size bytes.

    Default engine: block-coverage selection (the durchschlag/cover
    idea): score fixed-size corpus blocks by how much of the rest of
    the corpus their shingles cover, keep the top blocks in corpus
    order (contiguous context compresses better than fragment packs).
    """
    data = np.frombuffer(corpus, np.uint8)
    n = len(data)
    if n <= dict_size:
        return corpus
    # 8-byte shingle hashes at every position
    w = np.zeros(n, np.uint64)
    for i in range(8):
        w[:n - i] |= data[i:].astype(np.uint64) << np.uint64(8 * i)
    h = ((w * np.uint64(0x9E3779B97F4A7C15)) >>
         np.uint64(40)).astype(np.int64)  # 24-bit shingle hash
    counts = np.bincount(h, minlength=1 << 24)
    # value of a position: its shingle recurs elsewhere
    rec = counts[h] - 1
    val = np.minimum(rec, 8).astype(np.float64)
    nb = n // block
    score = val[:nb * block].reshape(nb, block).sum(axis=1)
    nkeep = max(dict_size // block, 1)
    keep = np.sort(np.argsort(score)[::-1][:nkeep])  # corpus order
    out = b"".join(corpus[b * block:(b + 1) * block] for b in keep)
    return out[-dict_size:]


def generate_mined(corpus: bytes, dict_size: int = 16384,
                   min_len: int = MIN_LEN) -> bytes:
    """Alternative engine: suffix-sort substring mining (the
    deorummolae/sieve role). Packs high-score repeated substrings."""
    data = np.frombuffer(corpus, np.uint8)
    n = len(data)
    if n < 64:
        return corpus[:dict_size]
    sa = suffix_sort(data)
    lcp = _lcp_adjacent(data, sa)

    # candidate substrings: runs of sorted suffixes sharing a prefix of
    # length L have frequency = run length + 1. Score each maximal run
    # at its minimum LCP: gain ~ (freq - 1) * L - L (dict space).
    cands = []  # (score, start_pos, length)
    # quantized lengths keep the run scan cheap
    for L in (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        if L < min_len:
            continue
        good = lcp >= L
        if not good.any():
            continue
        # run-length encode the `good` mask
        gi = np.flatnonzero(good)
        run_break = np.flatnonzero(np.diff(gi) > 1)
        starts = np.concatenate([[0], run_break + 1])
        ends = np.concatenate([run_break, [len(gi) - 1]])
        freq = (ends - starts + 2)  # suffix count in the run
        score = (freq - 1) * L - L
        keep = score > 0
        for s, sc in zip(gi[starts[keep]], score[keep]):
            cands.append((int(sc), int(sa[s]), L))
    cands.sort(reverse=True)

    # greedy packing, dedup by content, most valuable at the end
    chosen = []
    seen = set()
    total = 0
    for sc, pos, L in cands:
        frag = corpus[pos:pos + L]
        if frag in seen:
            continue
        # skip if contained in an already-chosen fragment
        if any(frag in c for c in chosen[-64:]):
            continue
        seen.add(frag)
        chosen.append(frag)
        total += L
        if total >= dict_size:
            break
    chosen.reverse()  # highest score last = cheapest distances
    out = b"".join(chosen)
    return out[-dict_size:]


def _slice_popularity(samples, slice_len: int):
    """Occurrence count of every slice_len-gram over the concatenated
    samples (the durchschlag ScoreSlices role, research/durchschlag.cc):
    popular[i] = population of the slice starting at i."""
    data = np.frombuffer(b"".join(samples), np.uint8)
    n = len(data)
    end = n - slice_len + 1
    if end <= 0:
        return data, np.zeros(0, np.int64)
    # hash the grams (polynomial rolling hash, 64-bit): collisions
    # only ever overcount popularity, which is the safe direction for
    # corpus cleaning (a kept byte costs nothing; a lost one does)
    h = np.zeros(end, np.uint64)
    mult = np.uint64(1099511628211)
    for k in range(slice_len):
        h = h * mult + data[k:end + k].astype(np.uint64)
    _uniq, inv, counts = np.unique(h, return_inverse=True,
                                   return_counts=True)
    return data, counts[inv]


def _coverage_keep(pop, n: int, slice_len: int, min_pop: int):
    """keep[p] = position p is inside some popular slice (the
    lastNonUniquePos rule: p < max over starts s <= p with
    pop[s] >= min_pop of s + slice_len)."""
    keep_until = np.where(pop >= min_pop,
                          np.arange(len(pop), dtype=np.int64) + slice_len,
                          0)
    cm = np.maximum.accumulate(keep_until) if len(keep_until) else \
        np.zeros(0, np.int64)
    keep = np.zeros(n, bool)
    if len(cm):
        idx = np.minimum(np.arange(n), len(cm) - 1)
        keep = np.arange(n) < cm[idx]
    return keep


def distill(samples, slice_len: int = 16, min_pop: int = 2):
    """Rewrite samples REMOVING text that never repeats across the
    corpus (durchschlag_distill role, research/durchschlag.cc:656):
    the condensed samples train better dictionaries because unique
    content cannot be referenced anyway."""
    data, pop = _slice_popularity(samples, slice_len)
    keep = _coverage_keep(pop, len(data), slice_len, min_pop)
    out = []
    pos = 0
    for s in samples:
        m = keep[pos:pos + len(s)]
        out.append(np.frombuffer(s, np.uint8)[m].tobytes())
        pos += len(s)
    return out


def purify(samples, slice_len: int = 16, min_pop: int = 2):
    """Rewrite samples ZEROING text that never repeats (durchschlag_
    purify role, research/durchschlag.cc:698): sizes are preserved, so
    sample alignment survives for downstream tooling."""
    data, pop = _slice_popularity(samples, slice_len)
    keep = _coverage_keep(pop, len(data), slice_len, min_pop)
    out = []
    pos = 0
    for s in samples:
        a = np.frombuffer(s, np.uint8).copy()
        a[~keep[pos:pos + len(s)]] = 0
        out.append(a.tobytes())
        pos += len(s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="brotli_tpu_torch.tools.dictgen")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--size", type=int, default=16384,
                    help="dictionary size in bytes")
    ap.add_argument("--engine", choices=["cover", "mined"],
                    default="cover",
                    help="cover = block-coverage (durchschlag role); "
                         "mined = suffix-sort substring mining "
                         "(deorummolae/sieve role)")
    ap.add_argument("--distill", action="store_true",
                    help="rewrite samples next to the output: unique "
                         "text parts are REMOVED (corpus cleaning)")
    ap.add_argument("--purify", action="store_true",
                    help="rewrite samples next to the output: unique "
                         "text parts are ZEROED")
    ap.add_argument("--slice_len", type=int, default=16)
    ap.add_argument("--min_slice_pop", type=int, default=2)
    args = ap.parse_args(argv)
    samples = [open(f, "rb").read() for f in args.files]
    if args.distill or args.purify:
        fn = distill if args.distill else purify
        rewritten = fn(samples, args.slice_len, args.min_slice_pop)
        for path, blob in zip(args.files, rewritten):
            out = args.output + "." + pathlib.Path(path).name
            with open(out, "wb") as f:
                f.write(blob)
            print(f"{out}: {len(blob)} bytes (was {os.path.getsize(path)})")
        return 0
    corpus = b"".join(samples)
    gen = generate_mined if args.engine == "mined" else generate
    d = gen(corpus, args.size)
    with open(args.output, "wb") as f:
        f.write(d)
    print(f"dictionary: {len(d)} bytes from {len(corpus)} corpus bytes "
          f"({args.engine})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
