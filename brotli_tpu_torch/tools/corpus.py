"""A deterministic input for driving the port, made from the repo alone.

`build_corpus(size, seed)` concatenates, in order:
  * the port's own C sources (btpu_enc.c, btpu_dec.c): real code with
    long-range repeats;
  * text of RFC 7932 static-dictionary words drawn with Zipf weights
    from numpy.random.default_rng(seed), joined by spaces, punctuation
    and newlines: word references and short-distance matches;
  * 5% seeded random bytes: incompressible input.
Nothing is downloaded.
"""

import pathlib

import numpy as np

from ..format.dictionary import dictionary_data

_NATIVE = pathlib.Path(__file__).resolve().parent.parent / "native"

# log2(number of words) for each word length 0..24 (RFC 7932 Appendix A)
_SIZE_BITS_BY_LENGTH = (
    0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8,
    7, 7, 8, 7, 7, 6, 6, 5, 5)
_SEPARATORS = (b" ",) * 12 + (b", ", b". ", b".\n", b"\n", b"; ",
                              b": ", b" (", b") ", b" - ", b"\n\n")


def _dictionary_words():
    blob = dictionary_data()
    words, off = [], 0
    for length, bits in enumerate(_SIZE_BITS_BY_LENGTH):
        if length < 4:
            continue
        for i in range(1 << bits):
            words.append(blob[off + i * length:off + (i + 1) * length])
        off += length << bits
    return words


def build_corpus(size: int = 16 << 20, seed: int = 0,
                 sources=_NATIVE) -> bytes:
    """`size` bytes: the C sources (btpu_enc.c and btpu_dec.c in the
    directory `sources`, the port's by default), Zipf-weighted
    dictionary text, then 5% random bytes (all cut to fit `size`)."""
    rng = np.random.default_rng(seed)
    n_random = size // 20
    head = b"".join((pathlib.Path(sources) / f).read_bytes()
                    for f in ("btpu_enc.c", "btpu_dec.c"))
    head = head[:size - n_random]
    n_text = size - n_random - len(head)
    words = _dictionary_words()
    # a fixed shuffle of the word list picks which words are common
    rank = rng.permutation(len(words))
    weights = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    weights /= weights.sum()
    parts, have = [], 0
    while have < n_text:
        k = max((n_text - have) // 6, 1024)
        wi = rank[rng.choice(len(words), size=k, p=weights)]
        si = rng.integers(0, len(_SEPARATORS), size=k)
        chunk = b"".join(words[w] + _SEPARATORS[s]
                         for w, s in zip(wi.tolist(), si.tolist()))
        parts.append(chunk)
        have += len(chunk)
    text = b"".join(parts)[:n_text]
    tail = rng.integers(0, 256, size=n_random, dtype=np.uint8).tobytes()
    return head + text + tail
