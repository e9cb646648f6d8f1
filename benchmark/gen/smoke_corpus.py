"""The port's smoke corpus: C sources, dictionary words, random bytes.

A frozen, vectorized copy of the port's `tools/corpus.build_corpus`: it
gives the same bytes for the same size and seed, but reads only the
copies in benchmark/data, so a later edit to the port's C sources cannot
move the benchmark's input. It is synthetic and stands for no public
corpus. A document of `size` bytes concatenates, in order:

  * btpu_enc.c and btpu_dec.c as they were frozen (277,736 B, 1.7% of a
    16 MiB document): real code with long-range repeats;
  * text of RFC 7932 static-dictionary words drawn with Zipf weights
    (exponent 1.1) from numpy.random.default_rng(seed), joined by
    spaces, punctuation and newlines (93.3%: about 80.5% of the document
    is dictionary words, 12.8% separators): word references and
    short-distance matches. The dictionary holds words of many
    languages, so this text is no language's, and the dictionary probe
    finds far more of it than it would in real text;
  * 5% seeded random bytes: incompressible input.

Which words are common (a fixed shuffle of the word list) is the
corpus's vocabulary, drawn from `vocab_seed` and the same for every
document, so documents of every seed compress alike; each document draws
its words, separators and random tail from its own seed. Document i of a
pool made from the run's seed s has the seed s * pool + i; its generator
draws a shuffle first (the vocabulary's when the two seeds agree), so
vocabulary 0 and seed 0 give build_corpus()'s bytes.
"""

import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"

# log2(number of words) for each word length 0..24 (RFC 7932 Appendix A)
_SIZE_BITS_BY_LENGTH = (
    0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8,
    7, 7, 8, 7, 7, 6, 6, 5, 5)
_SEPARATORS = (b" ",) * 12 + (b", ", b". ", b".\n", b"\n", b"; ",
                              b": ", b" (", b") ", b" - ", b"\n\n")


def _pieces():
    """(blob, offsets, lengths, number of words): the dictionary's words
    in order, then the separators, as one byte array."""
    blob = (DATA / "static_dictionary_rfc7932.bin").read_bytes()
    offs, lens, off = [], [], 0
    for length, bits in enumerate(_SIZE_BITS_BY_LENGTH):
        if length < 4:
            continue
        offs.append(off + length * np.arange(1 << bits))
        lens.append(np.full(1 << bits, length))
        off += length << bits
    nwords = sum(len(o) for o in offs)
    sep = b"".join(_SEPARATORS)
    sep_len = np.array([len(s) for s in _SEPARATORS])
    offs.append(len(blob) + np.concatenate([[0], np.cumsum(sep_len)[:-1]]))
    lens.append(sep_len)
    return (np.frombuffer(blob + sep, np.uint8), np.concatenate(offs),
            np.concatenate(lens), nwords)


def _gather(blob, offs, lens, ids):
    """The bytes of pieces `ids`, concatenated."""
    ln = lens[ids]
    ends = np.cumsum(ln)
    idx = np.repeat(offs[ids] - (ends - ln), ln) + np.arange(int(ends[-1]))
    return blob[idx]


def document(size: int, seed: int, vocab_seed: int = None) -> bytes:
    """`size` bytes: the frozen C sources, Zipf-weighted dictionary text,
    then 5% random bytes (all cut to fit `size`); the vocabulary is
    drawn from `vocab_seed` (None: from `seed`, as build_corpus)."""
    rng = np.random.default_rng(seed)
    n_random = size // 20
    head = b"".join((DATA / f).read_bytes()
                    for f in ("btpu_enc.c", "btpu_dec.c"))
    head = head[:size - n_random]
    n_text = size - n_random - len(head)
    blob, offs, lens, nwords = _pieces()
    # a fixed shuffle of the word list picks which words are common
    rank = rng.permutation(nwords)
    if vocab_seed is not None:
        rank = np.random.default_rng(vocab_seed).permutation(nwords)
    weights = 1.0 / np.arange(1, nwords + 1) ** 1.1
    weights /= weights.sum()
    parts, have = [], 0
    while have < n_text:
        k = max((n_text - have) // 6, 1024)
        wi = rank[rng.choice(nwords, size=k, p=weights)]
        si = rng.integers(0, len(_SEPARATORS), size=k)
        ids = np.empty(2 * k, np.int64)
        ids[0::2] = wi
        ids[1::2] = nwords + si
        chunk = _gather(blob, offs, lens, ids)
        parts.append(chunk)
        have += len(chunk)
    text = np.concatenate(parts)[:n_text].tobytes() if parts else b""
    tail = rng.integers(0, 256, size=n_random, dtype=np.uint8).tobytes()
    return head + text + tail


def documents(seed: int, doc_bytes: int, pool: int,
              vocab_seed: int = None) -> list:
    """The pool of `pool` documents of `doc_bytes` each for a run's
    seed."""
    return [document(doc_bytes, (seed * pool + i) % (1 << 128), vocab_seed)
            for i in range(pool)]
