"""RFC 7932 Appendix A static dictionary.

13,504 words of lengths 4..24, stored length-bucketed in a single 122,784
byte blob (the frozen copy in ``benchmark/data``). Parity anchor: c/common/dictionary.c
kBrotliDictionary.
"""

from functools import lru_cache
from pathlib import Path

import numpy as np

from . import constants as C
from . import transforms

_DATA_PATH = Path(__file__).resolve().parent.parent / "data" / \
    "static_dictionary_rfc7932.bin"

# log2(number of words) for each word length 0..31 (RFC Appendix A).
SIZE_BITS_BY_LENGTH = (
    0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8,
    7, 7, 8, 7, 7, 6, 6, 5, 5, 0, 0, 0, 0, 0, 0, 0)

def _bucket_offsets():
    """Byte offset of each length bucket: bucket l holds 2^bits[l] words of
    l bytes each (lengths with bits=0 hold no words)."""
    offs, pos = [], 0
    for length, bits in enumerate(SIZE_BITS_BY_LENGTH):
        offs.append(pos)
        if 4 <= length <= 24:
            pos += length * (1 << bits)
    return tuple(offs)


# Byte offset of each length bucket inside the blob.
OFFSETS_BY_LENGTH = _bucket_offsets()
assert OFFSETS_BY_LENGTH[25] == 122784


@lru_cache(maxsize=1)
def dictionary_data() -> bytes:
    """The RFC 7932 dictionary blob. Cached so every caller sees ONE
    stable object: the native library keys its global dictionary
    index on the blob POINTER (btpu_enc.c dict_index_init) and keeps
    it after the call returns -- a fresh bytes object per call both
    dangles that pointer and forces an index rebuild, which races
    concurrent probes on the streaming encoder's worker thread
    (use-after-free -> corrupt dictionary matches)."""
    data = _DATA_PATH.read_bytes()
    if len(data) != 122784:
        raise RuntimeError("static dictionary blob corrupted")
    return data


@lru_cache(maxsize=1)
def dictionary_array() -> np.ndarray:
    """Dictionary as a read-only uint8 array (device-uploadable)."""
    arr = np.frombuffer(dictionary_data(), dtype=np.uint8)
    arr.setflags(write=False)
    return arr


def word(length: int, index: int) -> bytes:
    """The `index`-th dictionary word of a given length."""
    nbits = SIZE_BITS_BY_LENGTH[length]
    if nbits == 0:
        raise ValueError(f"no dictionary words of length {length}")
    off = OFFSETS_BY_LENGTH[length] + index * length
    return dictionary_data()[off:off + length]


def decode_reference(copy_len: int, address: int):
    """Resolve a static-dictionary reference (RFC 8).

    `address` = distance - max_distance - 1. Returns the transformed word
    bytes, or None if the reference is invalid.
    """
    if not (C.MIN_DICTIONARY_WORD_LENGTH <= copy_len
            <= C.MAX_DICTIONARY_WORD_LENGTH):
        return None
    nbits = SIZE_BITS_BY_LENGTH[copy_len]
    if nbits == 0:
        return None
    word_idx = address & ((1 << nbits) - 1)
    transform_idx = address >> nbits
    if transform_idx >= transforms.NUM_TRANSFORMS:
        return None
    w = word(copy_len, word_idx)
    if transform_idx == transforms.IDENTITY_TRANSFORM:
        return w
    out = transforms.transform_word(w, transform_idx)
    if len(out) == 0:
        return None  # length-0 word after transform is a format error
    return out
