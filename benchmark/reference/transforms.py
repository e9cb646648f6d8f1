"""RFC 7932 Appendix B: the 121 word transforms.

Each transform is (prefix, operation, suffix): output = prefix +
op(dictionary_word) + suffix. Operations: IDENTITY, OMIT_FIRST_n /
OMIT_LAST_n (n in 1..9), UPPERCASE_FIRST, UPPERCASE_ALL. The table below is
the RFC's normative Appendix B list, written out in reading order
(transform id 0..120). Parity anchor: c/common/transform.c
BrotliTransformDictionaryWord.
"""

import numpy as np

IDENTITY = "IDENTITY"
UPPERCASE_FIRST = "UPPERCASE_FIRST"
UPPERCASE_ALL = "UPPERCASE_ALL"

TRANSFORMS = (
    (b'', 'IDENTITY', b''),
    (b'', 'IDENTITY', b' '),
    (b' ', 'IDENTITY', b' '),
    (b'', 'OMIT_FIRST_1', b''),
    (b'', 'UPPERCASE_FIRST', b' '),
    (b'', 'IDENTITY', b' the '),
    (b' ', 'IDENTITY', b''),
    (b's ', 'IDENTITY', b' '),
    (b'', 'IDENTITY', b' of '),
    (b'', 'UPPERCASE_FIRST', b''),
    (b'', 'IDENTITY', b' and '),
    (b'', 'OMIT_FIRST_2', b''),
    (b'', 'OMIT_LAST_1', b''),
    (b', ', 'IDENTITY', b' '),
    (b'', 'IDENTITY', b', '),
    (b' ', 'UPPERCASE_FIRST', b' '),
    (b'', 'IDENTITY', b' in '),
    (b'', 'IDENTITY', b' to '),
    (b'e ', 'IDENTITY', b' '),
    (b'', 'IDENTITY', b'"'),
    (b'', 'IDENTITY', b'.'),
    (b'', 'IDENTITY', b'">'),
    (b'', 'IDENTITY', b'\n'),
    (b'', 'OMIT_LAST_3', b''),
    (b'', 'IDENTITY', b']'),
    (b'', 'IDENTITY', b' for '),
    (b'', 'OMIT_FIRST_3', b''),
    (b'', 'OMIT_LAST_2', b''),
    (b'', 'IDENTITY', b' a '),
    (b'', 'IDENTITY', b' that '),
    (b' ', 'UPPERCASE_FIRST', b''),
    (b'', 'IDENTITY', b'. '),
    (b'.', 'IDENTITY', b''),
    (b' ', 'IDENTITY', b', '),
    (b'', 'OMIT_FIRST_4', b''),
    (b'', 'IDENTITY', b' with '),
    (b'', 'IDENTITY', b"'"),
    (b'', 'IDENTITY', b' from '),
    (b'', 'IDENTITY', b' by '),
    (b'', 'OMIT_FIRST_5', b''),
    (b'', 'OMIT_FIRST_6', b''),
    (b' the ', 'IDENTITY', b''),
    (b'', 'OMIT_LAST_4', b''),
    (b'', 'IDENTITY', b'. The '),
    (b'', 'UPPERCASE_ALL', b''),
    (b'', 'IDENTITY', b' on '),
    (b'', 'IDENTITY', b' as '),
    (b'', 'IDENTITY', b' is '),
    (b'', 'OMIT_LAST_7', b''),
    (b'', 'OMIT_LAST_1', b'ing '),
    (b'', 'IDENTITY', b'\n\t'),
    (b'', 'IDENTITY', b':'),
    (b' ', 'IDENTITY', b'. '),
    (b'', 'IDENTITY', b'ed '),
    (b'', 'OMIT_FIRST_9', b''),
    (b'', 'OMIT_FIRST_7', b''),
    (b'', 'OMIT_LAST_6', b''),
    (b'', 'IDENTITY', b'('),
    (b'', 'UPPERCASE_FIRST', b', '),
    (b'', 'OMIT_LAST_8', b''),
    (b'', 'IDENTITY', b' at '),
    (b'', 'IDENTITY', b'ly '),
    (b' the ', 'IDENTITY', b' of '),
    (b'', 'OMIT_LAST_5', b''),
    (b'', 'OMIT_LAST_9', b''),
    (b' ', 'UPPERCASE_FIRST', b', '),
    (b'', 'UPPERCASE_FIRST', b'"'),
    (b'.', 'IDENTITY', b'('),
    (b'', 'UPPERCASE_ALL', b' '),
    (b'', 'UPPERCASE_FIRST', b'">'),
    (b'', 'IDENTITY', b'="'),
    (b' ', 'IDENTITY', b'.'),
    (b'.com/', 'IDENTITY', b''),
    (b' the ', 'IDENTITY', b' of the '),
    (b'', 'UPPERCASE_FIRST', b"'"),
    (b'', 'IDENTITY', b'. This '),
    (b'', 'IDENTITY', b','),
    (b'.', 'IDENTITY', b' '),
    (b'', 'UPPERCASE_FIRST', b'('),
    (b'', 'UPPERCASE_FIRST', b'.'),
    (b'', 'IDENTITY', b' not '),
    (b' ', 'IDENTITY', b'="'),
    (b'', 'IDENTITY', b'er '),
    (b' ', 'UPPERCASE_ALL', b' '),
    (b'', 'IDENTITY', b'al '),
    (b' ', 'UPPERCASE_ALL', b''),
    (b'', 'IDENTITY', b"='"),
    (b'', 'UPPERCASE_ALL', b'"'),
    (b'', 'UPPERCASE_FIRST', b'. '),
    (b' ', 'IDENTITY', b'('),
    (b'', 'IDENTITY', b'ful '),
    (b' ', 'UPPERCASE_FIRST', b'. '),
    (b'', 'IDENTITY', b'ive '),
    (b'', 'IDENTITY', b'less '),
    (b'', 'UPPERCASE_ALL', b"'"),
    (b'', 'IDENTITY', b'est '),
    (b' ', 'UPPERCASE_FIRST', b'.'),
    (b'', 'UPPERCASE_ALL', b'">'),
    (b' ', 'IDENTITY', b"='"),
    (b'', 'UPPERCASE_FIRST', b','),
    (b'', 'IDENTITY', b'ize '),
    (b'', 'UPPERCASE_ALL', b'.'),
    (b'\xc2\xa0', 'IDENTITY', b''),
    (b' ', 'IDENTITY', b','),
    (b'', 'UPPERCASE_FIRST', b'="'),
    (b'', 'UPPERCASE_ALL', b'="'),
    (b'', 'IDENTITY', b'ous '),
    (b'', 'UPPERCASE_ALL', b', '),
    (b'', 'UPPERCASE_FIRST', b"='"),
    (b' ', 'UPPERCASE_FIRST', b','),
    (b' ', 'UPPERCASE_ALL', b'="'),
    (b' ', 'UPPERCASE_ALL', b', '),
    (b'', 'UPPERCASE_ALL', b','),
    (b'', 'UPPERCASE_ALL', b'('),
    (b'', 'UPPERCASE_ALL', b'. '),
    (b' ', 'UPPERCASE_ALL', b'.'),
    (b'', 'UPPERCASE_ALL', b"='"),
    (b' ', 'UPPERCASE_ALL', b'. '),
    (b' ', 'UPPERCASE_FIRST', b'="'),
    (b' ', 'UPPERCASE_ALL', b"='"),
    (b' ', 'UPPERCASE_FIRST', b"='"),
)

NUM_TRANSFORMS = len(TRANSFORMS)
assert NUM_TRANSFORMS == 121

# Transform id of the plain-copy transform (used by the encoder fast path;
# RFC: transform 0 is IDENTITY with empty prefix/suffix).
IDENTITY_TRANSFORM = 0

# Cut-off transforms: for k in 0..9, the transform id that is exactly
# OMIT_LAST_k with no prefix/suffix (k=0 -> identity). The encoder uses
# these to signal "match the first len-k bytes of a word". RFC Appendix B.
CUTOFF_TRANSFORMS = tuple(
    next(i for i, (p, t, s) in enumerate(TRANSFORMS)
         if p == b"" and s == b"" and
         t == (IDENTITY if k == 0 else f"OMIT_LAST_{k}"))
    for k in range(10)
)


def _uppercase_rune(data: bytearray, i: int) -> int:
    """Uppercase one crude-UTF-8 rune in place; returns its byte length.

    The format's uppercasing is deliberately simplistic (RFC 8): ASCII
    a-z flips bit 5; a 2-byte rune flips bit 5 of its continuation byte; a
    3+-byte rune xors its third byte with 5. Writes that would land beyond
    the word are dropped (in the reference they land in scratch space that
    the suffix then overwrites).
    """
    c = data[i]
    if c < 0xC0:
        if 0x61 <= c <= 0x7A:
            data[i] ^= 32
        return 1
    if c < 0xE0:
        if i + 1 < len(data):
            data[i + 1] ^= 32
        return 2
    if i + 2 < len(data):
        data[i + 2] ^= 5
    return 3


def transform_word(word: bytes, transform_id: int) -> bytes:
    """Apply transform `transform_id` to a dictionary word."""
    prefix, op, suffix = TRANSFORMS[transform_id]
    if op == IDENTITY:
        mid = word
    elif op == UPPERCASE_FIRST:
        buf = bytearray(word)
        if buf:
            _uppercase_rune(buf, 0)
        mid = bytes(buf)
    elif op == UPPERCASE_ALL:
        buf = bytearray(word)
        i = 0
        while i < len(buf):
            i += _uppercase_rune(buf, i)
        mid = bytes(buf)
    elif op.startswith("OMIT_FIRST_"):
        mid = word[int(op[11:]):]
    elif op.startswith("OMIT_LAST_"):
        n = int(op[10:])
        mid = word[:-n] if n < len(word) else b""
    else:  # pragma: no cover
        raise ValueError(op)
    return prefix + mid + suffix


def max_transformed_length(word_len: int) -> int:
    """Upper bound of transformed output length for buffer sizing."""
    return word_len + 13  # longest prefix+suffix is " the " + " of the "
