"""Canonical prefix (Huffman) codes (trimmed copy of
brotli_tpu.format.huffman: the encoder's code assignment only).

Brotli reads bits LSB-first; canonical codes are assigned shortest-first,
then by symbol order, and each code's bits are emitted most-significant
first -- equivalently, the stored per-symbol code value here has bit k =
(k+1)-th bit read. Parity anchor: c/enc/entropy_encode.c
BrotliConvertBitDepthsToSymbols.
"""

import numpy as np


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
