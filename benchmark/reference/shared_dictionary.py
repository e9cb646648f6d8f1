"""Serialized shared-dictionary format (shared-brotli; copy of
brotli_tpu.format.shared_dictionary).

Parser + word expansion for the custom-dictionary container the
reference ships behind BROTLI_EXPERIMENTAL (format learned from
c/common/shared_dictionary.c ParseDictionary and
c/common/transform.c BrotliTransformDictionaryWord/Shift; re-written
as a validating Python parser over typed dataclasses).

Container grammar (all little-endian):
  magic 0x91 0x00
  varint32 raw-prefix length; that many raw LZ77 dictionary bytes
  u8 NUM_WORD_LISTS; each: 21 bytes size_bits for lengths 4..24
      (each <= 15), then the packed words (sum of len << bits bytes)
  u8 NUM_TRANSFORM_LISTS; each:
      u16 prefix/suffix pool length; pool of [len byte][bytes...]
          stringlets ending with a 0-length stringlet at pool end
      u8 NUM_TRANSFORMS; 3 bytes each (prefix_id, type, suffix_id);
      if any type is SHIFT_FIRST/SHIFT_ALL: u16 param per transform
  if any custom lists: u8 NUM_DICTIONARIES (1..64); per dictionary
      u8 words_index, u8 transforms_index (== count -> RFC built-in);
      u8 CONTEXT_ENABLED; if set: 64 x u8 context map entries
"""

import dataclasses

import numpy as np

from . import constants as C
from . import dictionary as builtin_dict
from . import transforms as builtin_transforms

MAGIC = b"\x91\x00"
MAX_CONTEXTS = 64
MAX_SIZE_BITS = 15

# transform type ids (c/common/transform.h BrotliWordTransformType)
T_IDENTITY = 0
T_OMIT_LAST_1, T_OMIT_LAST_9 = 1, 9
T_UPPERCASE_FIRST = 10
T_UPPERCASE_ALL = 11
T_OMIT_FIRST_1, T_OMIT_FIRST_9 = 12, 20
T_SHIFT_FIRST = 21
T_SHIFT_ALL = 22
NUM_TRANSFORM_TYPES = 23


class ParseError(ValueError):
    pass


@dataclasses.dataclass
class WordList:
    size_bits: list          # per length 0..24
    offsets: list
    data: bytes

    def word(self, length: int, index: int) -> bytes:
        off = self.offsets[length] + index * length
        return self.data[off:off + length]


@dataclasses.dataclass
class TransformList:
    stringlets: list          # prefix/suffix byte strings by id
    triples: list             # (prefix_id, type, suffix_id)
    params: list              # u16 per transform (0 when absent)


@dataclasses.dataclass
class SharedDictionary:
    prefixes: list            # raw LZ77 dictionaries (bytes)
    word_lists: list
    transform_lists: list
    dictionaries: list        # (WordList|None, TransformList|None);
                              # None = RFC built-in
    context_based: bool
    context_map: list         # 64 entries into `dictionaries`


class _Reader:
    def __init__(self, blob: bytes):
        self.b = blob
        self.pos = 0

    def u8(self) -> int:
        if self.pos >= len(self.b):
            raise ParseError("truncated shared dictionary")
        v = self.b[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        return self.u8() | (self.u8() << 8)

    def varint32(self) -> int:
        v = 0
        for shift in range(0, 35, 7):
            byte = self.u8()
            v |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return v
        raise ParseError("overlong varint")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.b):
            raise ParseError("truncated shared dictionary")
        v = self.b[self.pos:self.pos + n]
        self.pos += n
        return v


def _parse_word_list(r: _Reader) -> WordList:
    lo = C.MIN_DICTIONARY_WORD_LENGTH
    hi = C.MAX_DICTIONARY_WORD_LENGTH
    bits = [0] * lo + list(r.take(hi - lo + 1))
    if any(b > MAX_SIZE_BITS for b in bits):
        raise ParseError("word-list size_bits > 15")
    offsets = []
    pos = 0
    for i in range(hi + 1):
        offsets.append(pos)
        if bits[i]:
            pos += i << bits[i]
    return WordList(bits, offsets, r.take(pos))


def _parse_transform_list(r: _Reader) -> TransformList:
    pool_len = r.u16()
    if pool_len < 1:
        raise ParseError("empty prefix/suffix pool")
    pool = r.take(pool_len)
    stringlets = []
    off = 0
    while True:
        ln = pool[off]
        stringlets.append(bytes(pool[off + 1:off + 1 + ln]))
        off += 1
        if ln == 0:
            if off != pool_len:
                raise ParseError("pool terminator not at pool end")
            break
        if len(stringlets) > 255:
            raise ParseError("too many stringlets")
        off += ln
        if off >= pool_len:
            raise ParseError("stringlet overruns pool")
    ntr = r.u8()
    raw = r.take(ntr * 3)
    triples = []
    has_params = False
    for i in range(ntr):
        pid, typ, sid = raw[3 * i], raw[3 * i + 1], raw[3 * i + 2]
        if pid >= len(stringlets) or sid >= len(stringlets):
            raise ParseError("stringlet id out of range")
        if typ >= NUM_TRANSFORM_TYPES:
            raise ParseError("bad transform type")
        if typ in (T_SHIFT_FIRST, T_SHIFT_ALL):
            has_params = True
        triples.append((pid, typ, sid))
    params = [0] * ntr
    if has_params:
        praw = r.take(ntr * 2)
        for i in range(ntr):
            params[i] = praw[2 * i] | (praw[2 * i + 1] << 8)
            if triples[i][1] not in (T_SHIFT_FIRST, T_SHIFT_ALL) and \
                    params[i]:
                raise ParseError("params on non-shift transform")
    return TransformList(stringlets, triples, params)


def parse(blob: bytes) -> SharedDictionary:
    """Parse and validate a serialized shared dictionary."""
    if len(blob) < 2 or blob[:2] != MAGIC:
        raise ParseError("bad shared-dictionary magic")
    r = _Reader(blob)
    r.pos = 2
    prefixes = []
    chunk = r.varint32()
    if chunk:
        prefixes.append(r.take(chunk))
    nwl = r.u8()
    if nwl > MAX_CONTEXTS:
        raise ParseError("too many word lists")
    word_lists = [_parse_word_list(r) for _ in range(nwl)]
    ntl = r.u8()
    if ntl > MAX_CONTEXTS:
        raise ParseError("too many transform lists")
    transform_lists = [_parse_transform_list(r) for _ in range(ntl)]

    dictionaries = [(None, None)]
    context_based = False
    context_map = [0] * MAX_CONTEXTS
    if nwl or ntl:
        nd = r.u8()
        if not 1 <= nd <= MAX_CONTEXTS:
            raise ParseError("bad dictionary count")
        dictionaries = []
        for _ in range(nd):
            wi = r.u8()
            ti = r.u8()
            if wi > nwl or ti > ntl:
                raise ParseError("dictionary index out of range")
            dictionaries.append((word_lists[wi] if wi < nwl else None,
                                 transform_lists[ti] if ti < ntl else
                                 None))
        context_based = bool(r.u8())
        if context_based:
            context_map = list(r.take(MAX_CONTEXTS))
            if any(e >= nd for e in context_map):
                raise ParseError("context map entry out of range")
    return SharedDictionary(prefixes, word_lists, transform_lists,
                            dictionaries, context_based, context_map)


def _shift_rune(buf: bytearray, i: int, end: int, param: int) -> int:
    """Shift one UTF-8 rune's scalar by the signed 15-bit param
    (transform.c Shift); returns the rune's byte length."""
    scalar = (param & 0x7FFF) + (0x1000000 - (param & 0x8000))
    c = buf[i]
    rem = end - i
    if c < 0x80:
        scalar += c
        buf[i] = scalar & 0x7F
        return 1
    if c < 0xC0:
        return 1
    if c < 0xE0:
        if rem < 2:
            return 1
        scalar += (buf[i + 1] & 0x3F) | ((c & 0x1F) << 6)
        buf[i] = 0xC0 | ((scalar >> 6) & 0x1F)
        buf[i + 1] = (buf[i + 1] & 0xC0) | (scalar & 0x3F)
        return 2
    if c < 0xF0:
        if rem < 3:
            return rem
        scalar += (buf[i + 2] & 0x3F) | ((buf[i + 1] & 0x3F) << 6) | \
            ((c & 0x0F) << 12)
        buf[i] = 0xE0 | ((scalar >> 12) & 0x0F)
        buf[i + 1] = (buf[i + 1] & 0xC0) | ((scalar >> 6) & 0x3F)
        buf[i + 2] = (buf[i + 2] & 0xC0) | (scalar & 0x3F)
        return 3
    if c < 0xF8:
        if rem < 4:
            return rem
        scalar += (buf[i + 3] & 0x3F) | ((buf[i + 2] & 0x3F) << 6) | \
            ((buf[i + 1] & 0x3F) << 12) | ((c & 0x07) << 18)
        buf[i] = 0xF0 | ((scalar >> 18) & 0x07)
        buf[i + 1] = (buf[i + 1] & 0xC0) | ((scalar >> 12) & 0x3F)
        buf[i + 2] = (buf[i + 2] & 0xC0) | ((scalar >> 6) & 0x3F)
        buf[i + 3] = (buf[i + 3] & 0xC0) | (scalar & 0x3F)
        return 4
    return 1


def apply_transform(word: bytes, triple, param: int) -> bytes:
    """Apply one custom transform (prefix, type, suffix already
    resolved to byte strings by the caller for the stringlet ids)."""
    prefix, typ, suffix = triple
    mid = bytearray(word)
    if T_OMIT_LAST_1 <= typ <= T_OMIT_LAST_9:
        mid = mid[:-typ] if typ < len(mid) else bytearray()
    elif T_OMIT_FIRST_1 <= typ <= T_OMIT_FIRST_9:
        mid = mid[typ - (T_OMIT_FIRST_1 - 1):]
    elif typ == T_UPPERCASE_FIRST:
        if mid:
            builtin_transforms._uppercase_rune(mid, 0)
    elif typ == T_UPPERCASE_ALL:
        i = 0
        while i < len(mid):
            i += builtin_transforms._uppercase_rune(mid, i)
    elif typ == T_SHIFT_FIRST:
        if mid:
            _shift_rune(mid, 0, len(mid), param)
    elif typ == T_SHIFT_ALL:
        i = 0
        while i < len(mid):
            i += max(_shift_rune(mid, i, len(mid), param), 1)
    return prefix + bytes(mid) + suffix


def decode_reference(sd: SharedDictionary, copy_len: int, address: int,
                     p1: int, p2: int, context_lut) -> bytes:
    """Resolve a dictionary word reference against the attached
    dictionary set (decode.c:2234: the contextual dictionary is chosen
    by the literal context of the last two output bytes)."""
    if sd.context_based:
        ctx = int(context_lut[0][p1] | context_lut[1][p2])
        words, tlist = sd.dictionaries[sd.context_map[ctx]]
    else:
        words, tlist = sd.dictionaries[0]
    if words is None and tlist is None:
        return builtin_dict.decode_reference(copy_len, address)
    if words is None:
        size_bits = builtin_dict.SIZE_BITS_BY_LENGTH
        get_word = builtin_dict.word
    else:
        size_bits = words.size_bits
        get_word = words.word
    if not 0 <= copy_len < len(size_bits):
        return None
    nbits = int(size_bits[copy_len])
    if nbits == 0:
        return None  # no words of that length in this list
    mask = (1 << nbits) - 1
    word_idx = address & mask
    transform_idx = address >> nbits
    w = get_word(copy_len, word_idx)
    if len(w) != copy_len:
        return None
    if tlist is None:
        if transform_idx >= builtin_transforms.NUM_TRANSFORMS:
            return None
        if transform_idx == builtin_transforms.IDENTITY_TRANSFORM:
            return w
        out = builtin_transforms.transform_word(w, transform_idx)
    else:
        if transform_idx >= len(tlist.triples):
            return None
        pid, typ, sid = tlist.triples[transform_idx]
        out = apply_transform(
            w, (tlist.stringlets[pid], typ, tlist.stringlets[sid]),
            tlist.params[transform_idx])
    return out if out else None


def serialize(prefixes=(), word_lists=(), transform_lists=(),
              dictionaries=(), context_based=False,
              context_map=None) -> bytes:
    """Build a serialized shared dictionary (inverse of `parse`;
    the reference has no public writer -- research tooling role)."""
    out = bytearray(MAGIC)
    if len(prefixes) > 1:
        raise ValueError("serialized container carries one raw prefix")
    raw = prefixes[0] if prefixes else b""
    v = len(raw)
    while True:
        byte = v & 0x7F
        v >>= 7
        out.append(byte | (0x80 if v else 0))
        if not v:
            break
    out += raw
    out.append(len(word_lists))
    for wl in word_lists:
        lo = C.MIN_DICTIONARY_WORD_LENGTH
        out += bytes(wl.size_bits[lo:C.MAX_DICTIONARY_WORD_LENGTH + 1])
        out += wl.data
    out.append(len(transform_lists))
    for tl in transform_lists:
        # the 0-length stringlet terminates the pool AND is a valid
        # id -- it must be the last entry
        if tl.stringlets[-1] != b"" or \
                any(not st for st in tl.stringlets[:-1]):
            raise ValueError("empty stringlet must be last (terminator)")
        pool = bytearray()
        for st in tl.stringlets[:-1]:
            pool.append(len(st))
            pool += st
        pool.append(0)
        out += len(pool).to_bytes(2, "little")
        out += pool
        out.append(len(tl.triples))
        for t in tl.triples:
            out += bytes(t)
        if any(t[1] in (T_SHIFT_FIRST, T_SHIFT_ALL) for t in tl.triples):
            for p in tl.params:
                out += int(p).to_bytes(2, "little")
    if word_lists or transform_lists:
        out.append(len(dictionaries))
        for wi, ti in dictionaries:
            out.append(wi)
            out.append(ti)
        out.append(1 if context_based else 0)
        if context_based:
            out += bytes(context_map)
    return bytes(out)
