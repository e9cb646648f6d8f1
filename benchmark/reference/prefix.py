"""RFC 7932 prefix-code value ranges: insert/copy lengths, block counts,
combined insert-and-copy command codes, and distance codes.

Everything here is derived from the RFC's closed-form rules; tables are
materialised as NumPy arrays so both the host codec and the JAX/Pallas
kernels can gather from them. Parity anchors: c/dec/prefix.h (kCmdLut),
c/dec/decode.c CalculateDistanceLut, c/common/constants.h.
"""

from functools import lru_cache

import numpy as np

from . import constants as C

# --- Insert / copy length codes (RFC 7932 section 5) -----------------------

INSERT_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14,
     24], dtype=np.int32)
COPY_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10,
     24], dtype=np.int32)


def _bases(extra: np.ndarray, first: int) -> np.ndarray:
    sizes = (1 << extra.astype(np.int64))
    return (first + np.concatenate([[0], np.cumsum(sizes)[:-1]])).astype(
        np.int32)


INSERT_BASE = _bases(INSERT_EXTRA, 0)   # insert lengths start at 0
COPY_BASE = _bases(COPY_EXTRA, 2)       # copy lengths start at 2

# --- Block count codes (RFC 7932 section 6) --------------------------------

BLOCK_COUNT_EXTRA = np.array(
    [2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     12, 13, 24], dtype=np.int32)
BLOCK_COUNT_BASE = _bases(BLOCK_COUNT_EXTRA, 1)  # block counts start at 1


def encode_value(value: int, base: np.ndarray, extra: np.ndarray) -> tuple:
    """Map a value to (code, extra_bits_value, extra_bits_count)."""
    code = int(np.searchsorted(base, value, side="right")) - 1
    return code, value - int(base[code]), int(extra[code])


# --- Combined insert-and-copy command codes (RFC 7932 section 5) -----------
#
# The 704 command symbols are arranged in 11 cells of 64. Each cell covers an
# (insert code range, copy code range) pair; within a cell the low 6 bits are
# (insert_code & 7) << 3 | (copy_code & 7). The first two cells additionally
# imply "distance code 0" (reuse last distance, no distance symbol emitted).
#
#   cell  codes      insert range  copy range  implicit dist0
_CMD_CELLS = (
    (0,   0, 0, True),    # codes   0..63   insert 0..7   copy 0..7
    (64,  0, 1, True),    # codes  64..127  insert 0..7   copy 8..15
    (128, 0, 0, False),
    (192, 0, 1, False),
    (256, 1, 0, False),
    (320, 1, 1, False),
    (384, 0, 2, False),
    (448, 2, 0, False),
    (512, 1, 2, False),
    (576, 2, 1, False),
    (640, 2, 2, False),
)


@lru_cache(maxsize=None)
def cmd_lut():
    """Per-command-symbol decode table, shape (704,) structured arrays.

    Returns dict of arrays: insert_code, copy_code, insert_base,
    insert_extra, copy_base, copy_extra, implicit_dist0 (bool),
    dist_context (0..3).
    """
    n = C.NUM_COMMAND_SYMBOLS
    icode = np.zeros(n, np.int32)
    ccode = np.zeros(n, np.int32)
    dist0 = np.zeros(n, bool)
    for start, ihi, chi, implicit in _CMD_CELLS:
        for low in range(64):
            ic = (ihi << 3) | (low >> 3)
            cc = (chi << 3) | (low & 7)
            icode[start + low] = ic
            ccode[start + low] = cc
            dist0[start + low] = implicit
    copy_base = COPY_BASE[ccode]
    # distance context = min(copy_len - 2, 3) evaluated at the code's base
    # copy length (copy lengths within one code share a context because the
    # code boundaries align with the 2,3,4,5+ split). RFC 7.2.
    dctx = np.minimum(copy_base - 2, 3).astype(np.int32)
    out = {
        "insert_code": icode,
        "copy_code": ccode,
        "insert_base": INSERT_BASE[icode],
        "insert_extra": INSERT_EXTRA[icode],
        "copy_base": copy_base,
        "copy_extra": COPY_EXTRA[ccode],
        "implicit_dist0": dist0,
        "dist_context": dctx,
    }
    for v in out.values():
        v.setflags(write=False)
    return out


def combine_cmd_code(insert_code: int, copy_code: int,
                     implicit_dist0: bool) -> int:
    """Inverse mapping: (insert code, copy code, dist0 flag) -> symbol."""
    ihi, chi = insert_code >> 3, copy_code >> 3
    low = ((insert_code & 7) << 3) | (copy_code & 7)
    if implicit_dist0:
        if ihi != 0 or chi > 1:
            raise ValueError("implicit dist0 requires insert<8 and copy<16")
        return (0 if chi == 0 else 64) + low
    for start, i, c, implicit in _CMD_CELLS:
        if not implicit and i == ihi and c == chi:
            return start + low
    raise ValueError(f"bad codes {insert_code} {copy_code}")


# --- Distance codes (RFC 7932 section 4) ------------------------------------

# Short codes 0..15: (ring_index, delta). ring_index 0 = last distance,
# 1 = second last. Parity: c/dec/decode.c TakeDistanceFromRingBuffer.
DISTANCE_SHORT_CODES = (
    (0, 0), (1, 0), (2, 0), (3, 0),
    (0, -1), (0, 1), (0, -2), (0, 2), (0, -3), (0, 3),
    (1, -1), (1, 1), (1, -2), (1, 2), (1, -3), (1, 3),
)


@lru_cache(maxsize=None)
def distance_lut(npostfix: int, ndirect: int,
                 maxnbits: int = C.MAX_DISTANCE_BITS):
    """(extra_bits, offset) int32 arrays over the distance alphabet.

    For code >= 16 + ndirect:  distance = offset[code] + (extra << npostfix).
    Codes < 16 are ring-buffer short codes (extra = 0 here; resolved
    separately). Direct codes map to distances 1..ndirect.
    """
    size = C.distance_alphabet_size(npostfix, ndirect, maxnbits)
    extra = np.zeros(size, np.int64)
    offset = np.zeros(size, np.int64)  # large-window offsets pass 2^31
    i = C.NUM_DISTANCE_SHORT_CODES
    for j in range(ndirect):
        offset[i] = j + 1
        i += 1
    postfix = 1 << npostfix
    bits, half = 1, 0
    while i < size:
        base = ndirect + ((((2 + half) << bits) - 4) << npostfix) + 1
        for j in range(postfix):
            extra[i] = bits
            # top large-window codes describe distances past 2^62 --
            # far beyond MAX_ALLOWED_DISTANCE; clamp (they only need to
            # be "too large" so the decoder rejects them)
            offset[i] = min(base + j, 1 << 56)
            i += 1
        bits += half
        half ^= 1
    extra.setflags(write=False)
    offset.setflags(write=False)
    return extra, offset


def encode_distance(distance: int, npostfix: int, ndirect: int) -> tuple:
    """Map an explicit distance (>= 1) to (dcode, extra_value, extra_bits).

    Does not consider ring-buffer short codes -- callers pick those
    separately when profitable.
    """
    distance = int(distance)
    if distance <= ndirect:
        return C.NUM_DISTANCE_SHORT_CODES + distance - 1, 0, 0
    pmask = (1 << npostfix) - 1
    d = distance - ndirect - 1
    postfix = d & pmask
    hcode = d >> npostfix
    nbits = max((hcode + 4).bit_length() - 2, 1)  # ndistbits
    # invert: d >> npostfix = ((2 + half) << nbits) - 4 + extra
    rest = hcode - (((2 << nbits) - 4))
    half = rest >> nbits
    extra_val = rest - (half << nbits)
    dcode = (C.NUM_DISTANCE_SHORT_CODES + ndirect +
             ((((nbits - 1) << 1) | half) << npostfix) + postfix)
    return dcode, extra_val, nbits
