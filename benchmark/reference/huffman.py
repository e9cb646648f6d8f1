"""Canonical prefix (Huffman) codes, shared by encoder and decoder.

Brotli reads bits LSB-first; canonical codes are assigned shortest-first,
then by symbol order, and each code's bits are emitted most-significant
first -- equivalently, the stored per-symbol code value here has bit k =
(k+1)-th bit read. Parity anchors: c/dec/huffman.c BrotliBuildHuffmanTable,
c/enc/entropy_encode.c BrotliConvertBitDepthsToSymbols.
"""

import numpy as np

from . import constants as C


def _reverse_bits(v: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def lengths_to_codes(lengths) -> np.ndarray:
    """Canonical code assignment; returns per-symbol code values (bit k of
    the value = (k+1)-th bit written to the stream)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(lengths.shape, dtype=np.uint32)
    code = 0
    prev_len = 0
    order = np.lexsort((np.arange(len(lengths)), lengths))
    for sym in order:
        ln = int(lengths[sym])
        if ln == 0:
            continue
        code <<= (ln - prev_len)
        codes[sym] = _reverse_bits(code, ln)
        code += 1
        prev_len = ln
    return codes


class DecodeTable:
    """Flat LSB-first lookup table: peek MAX_LEN bits -> (symbol, length).

    Built as two NumPy arrays for O(1) symbol decode from Python and as
    gatherable arrays for vectorized decode kernels.
    """

    __slots__ = ("symbols", "nbits", "max_len")

    def __init__(self, lengths, max_len: int = C.HUFFMAN_MAX_CODE_LENGTH):
        lengths = np.asarray(lengths, dtype=np.int32)
        used = np.flatnonzero(lengths)
        if len(used) == 0:
            raise ValueError("empty code")
        if len(used) == 1:
            # Degenerate single-symbol code: zero bits per symbol.
            self.max_len = 0
            self.symbols = np.full(1, used[0], dtype=np.int32)
            self.nbits = np.zeros(1, dtype=np.int8)
            return
        max_len = int(lengths.max())
        self.max_len = max_len
        size = 1 << max_len
        self.symbols = np.zeros(size, dtype=np.int32)
        self.nbits = np.zeros(size, dtype=np.int8)
        codes = lengths_to_codes(lengths)
        # Check completeness (a valid brotli complex code must fill the
        # space exactly; simple codes arrive via `simple_table`).
        space = np.sum((1 << (max_len - lengths[used])).astype(np.int64))
        if space != size:
            raise ValueError("under/over-subscribed prefix code")
        for sym in used:
            ln = int(lengths[sym])
            base = int(codes[sym])
            step = 1 << ln
            idx = np.arange(base, size, step)
            self.symbols[idx] = sym
            self.nbits[idx] = ln

    def decode(self, peeked_bits: int):
        """(symbol, bits_consumed) from up to max_len peeked bits."""
        if self.max_len == 0:
            return int(self.symbols[0]), 0
        i = peeked_bits & ((1 << self.max_len) - 1)
        return int(self.symbols[i]), int(self.nbits[i])

    @classmethod
    def degenerate(cls, symbol: int) -> "DecodeTable":
        """Zero-bit code over a single symbol."""
        t = cls.__new__(cls)
        t.max_len = 0
        t.symbols = np.array([symbol], dtype=np.int32)
        t.nbits = np.zeros(1, dtype=np.int8)
        return t


def simple_lengths(num_symbols: int, tree_select: bool) -> list:
    """Code lengths for the 'simple' Huffman code shapes (RFC 3.4)."""
    return {
        (1, False): [0],
        (2, False): [1, 1],
        (3, False): [1, 2, 2],
        (4, False): [2, 2, 2, 2],
        (4, True): [1, 2, 3, 3],
    }[(num_symbols, tree_select)]


def simple_table(symbols, tree_select: bool, alphabet_size: int):
    """DecodeTable for a simple code over explicit symbols."""
    if len(symbols) == 1:
        return DecodeTable.degenerate(symbols[0])
    lengths = np.zeros(alphabet_size, dtype=np.int32)
    for ln, sym in zip(simple_lengths(len(symbols), tree_select), symbols):
        lengths[sym] = ln
    return DecodeTable(lengths)
