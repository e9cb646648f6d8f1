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


def base64_page(corpus: bytes, size: int, seed: int = 0) -> bytes:
    """`size` bytes of markup made from `corpus`: slices of it as text,
    each followed by an inline image whose payload is the base64 of
    another slice (`<img src="data:image/png;base64,...">`), the input
    of base64 mode (enc/base64_mode.py)."""
    import base64
    rng = np.random.default_rng(seed)
    parts, have = [], 0
    while have < size:
        t0, b0 = rng.integers(0, len(corpus) - (64 << 10), size=2)
        text = corpus[t0:t0 + int(rng.integers(8 << 10, 48 << 10))]
        blob = base64.b64encode(
            corpus[b0:b0 + int(rng.integers(1 << 10, 12 << 10))])
        piece = text + b'\n<img src="data:image/png;base64,' + blob + \
            b'">\n'
        parts.append(piece)
        have += len(piece)
    return b"".join(parts)[:size]


def custom_dictionary(sample: bytes, prefix_size: int = 16 << 10,
                      max_words: int = 256) -> bytes:
    """A serialized shared dictionary (format/shared_dictionary.py) drawn
    from `sample` by tools/dictgen: a raw prefix of `prefix_size` bytes
    (its block-coverage engine) and one custom word list of the
    8-byte strings that recur most in `sample` (its suffix sort and LCP
    scan; a power of two of them, at most `max_words`), with the
    identity transform only."""
    from ..format import shared_dictionary as shd
    from . import dictgen
    prefix = dictgen.generate(sample, prefix_size)
    arr = np.frombuffer(sample, np.uint8)
    sa = dictgen.suffix_sort(arr, 3)  # ordered by their first 8 bytes
    lcp = dictgen._lcp_adjacent(arr, sa, 8)
    # a run of k adjacent suffixes sharing 8 bytes: a string seen k + 1
    # times
    same = np.concatenate([[False], lcp >= 8, [False]]).astype(np.int8)
    starts = np.flatnonzero(np.diff(same) == 1)
    ends = np.flatnonzero(np.diff(same) == -1)
    order = np.argsort(-(ends - starts), kind="stable")
    words = [sample[int(sa[starts[i]]):int(sa[starts[i]]) + 8]
             for i in order[:max_words]]
    bits = int(np.log2(max(len(words), 1)))
    data = b"".join(words[:1 << bits])
    size_bits = [0] * 25
    size_bits[8] = bits
    wl = shd.WordList(size_bits, [0] * 9 + [len(data)] * 16, data)
    tl = shd.TransformList([b""], [(0, shd.T_IDENTITY, 0)], [0])
    return shd.serialize(prefixes=[prefix], word_lists=[wl],
                         transform_lists=[tl], dictionaries=[(0, 0)])
