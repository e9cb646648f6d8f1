"""RFC 7932 section 7.1 literal context modeling.

The four context modes are generated algorithmically from the RFC's rules
rather than stored as a table. ``context_lut(mode)`` returns the pair of
256-entry uint8 LUTs such that ``context = lut0[p1] | lut1[p2]`` -- the same
lookup contract as the reference's ``_kBrotliContextLookupTable``
(c/common/context.h:93-110), which is the parity anchor in tests.
"""

from functools import lru_cache

import numpy as np

CONTEXT_LSB6 = 0
CONTEXT_MSB6 = 1
CONTEXT_UTF8 = 2
CONTEXT_SIGNED = 3

_UPPER_VOWELS = frozenset(b"AEIOU")
_LOWER_VOWELS = frozenset(b"aeiou")


def _utf8_class1(b: int) -> int:
    """First-order class of the previous byte, UTF8 mode (RFC 7.1)."""
    if b < 128:
        c = bytes([b])
        if b in (9, 10, 13):  # \t \n \r
            return 1
        if b < 32 or b == 127:
            return 0  # non-printable control
        if b == 32:
            return 2  # space
        if c in (b'"', b"'"):
            return 4
        if c == b"%":
            return 5
        if c in (b"(", b"<", b"[", b"{"):
            return 6
        if c in (b")", b">", b"]", b"}"):
            return 7
        if c in (b",", b";", b":"):
            return 8
        if c == b".":
            return 9
        if c == b"=":
            return 10
        if b"0"[0] <= b <= b"9"[0]:
            return 11
        if b"A"[0] <= b <= b"Z"[0]:
            return 12 if b in _UPPER_VOWELS else 13
        if b"a"[0] <= b <= b"z"[0]:
            return 14 if b in _LOWER_VOWELS else 15
        return 3  # other punctuation
    raise AssertionError("class1 only defined for ASCII")


def _utf8_class2(b: int) -> int:
    """Second-order class of the byte before previous, UTF8 mode."""
    if b < 32 or b == 32 or b == 127:
        return 0  # control or space
    if b"0"[0] <= b <= b"9"[0] or b"A"[0] <= b <= b"Z"[0]:
        return 2  # upper-case letter or number
    if b"a"[0] <= b <= b"z"[0]:
        return 3  # lower-case letter
    return 1  # punctuation


def _signed_quantile(b: int) -> int:
    """9-ish level quantization of a byte for the SIGNED mode."""
    if b == 0:
        return 0
    if b <= 15:
        return 1
    if b <= 63:
        return 2
    if b <= 127:
        return 3
    if b <= 191:
        return 4
    if b <= 239:
        return 5
    if b <= 254:
        return 6
    return 7


@lru_cache(maxsize=None)
def context_lut(mode: int):
    """(lut0, lut1) uint8 arrays; context = lut0[p1] | lut1[p2]."""
    lut0 = np.zeros(256, dtype=np.uint8)
    lut1 = np.zeros(256, dtype=np.uint8)
    if mode == CONTEXT_LSB6:
        lut0[:] = np.arange(256) & 0x3F
    elif mode == CONTEXT_MSB6:
        lut0[:] = np.arange(256) >> 2
    elif mode == CONTEXT_UTF8:
        for b in range(256):
            if b < 128:
                lut0[b] = 4 * _utf8_class1(b)
                lut1[b] = _utf8_class2(b)
            elif b < 192:
                # continuation byte: next is likely ASCII/lead -> context 0/1
                lut0[b] = b & 1
                lut1[b] = 0
            else:
                # lead byte: next is a continuation byte -> context 2/3
                lut0[b] = 2 + (b & 1)
                # as second-last: >= 224 (3+-byte lead) implies the last
                # byte is a continuation byte of a long rune
                lut1[b] = 2 if b >= 224 else 0
    elif mode == CONTEXT_SIGNED:
        for b in range(256):
            lut0[b] = _signed_quantile(b) << 3
            lut1[b] = _signed_quantile(b)
    else:
        raise ValueError(f"invalid context mode {mode}")
    lut0.setflags(write=False)
    lut1.setflags(write=False)
    return lut0, lut1


def literal_context(mode: int, p1, p2):
    """Vectorizable context id computation."""
    lut0, lut1 = context_lut(mode)
    return lut0[p1] | lut1[p2]


def distance_context(copy_len: int) -> int:
    """Distance context from copy length (RFC 7.2)."""
    return 3 if copy_len > 4 else copy_len - 2
