"""LSB-first bit input/output over byte buffers.

The reader keeps a 64-bit-ish accumulator over a NumPy view of the input;
the writer accumulates (value, nbits) pairs and packs them in one
vectorized pass (exclusive scan of the lengths + scatter-OR into an
int64 word stream; parity anchors: c/dec/bit_reader.h,
c/enc/write_bits.h). A copy of brotli_tpu.format.bitio, with
`BitReader.read_symbol` added for the Python decoder.
"""

import numpy as np


class BitReader:
    """Resumable LSB-first bit reader."""

    __slots__ = ("data", "bitpos", "nbits")

    def __init__(self, data):
        self.data = np.frombuffer(bytes(data), dtype=np.uint8)
        self.bitpos = 0
        self.nbits = len(self.data) * 8

    def available(self) -> int:
        return self.nbits - self.bitpos

    def peek(self, n: int) -> int:
        """Peek up to n bits (short reads near EOF are zero-padded)."""
        byte0 = self.bitpos >> 3
        shift = self.bitpos & 7
        end = min(byte0 + ((n + shift + 7) >> 3), len(self.data))
        window = int.from_bytes(self.data[byte0:end].tobytes(), "little")
        return (window >> shift) & ((1 << n) - 1)

    def read_symbol(self, table) -> int:
        """One symbol of a prefix code (format/huffman.DecodeTable)."""
        sym, used = table.decode(self.peek(table.max_len))
        self.skip(used)
        return sym

    def take(self, n: int) -> int:
        if self.bitpos + n > self.nbits:
            raise NeedMoreInput()
        v = self.peek(n)
        self.bitpos += n
        return v

    def skip(self, n: int) -> None:
        if self.bitpos + n > self.nbits:
            raise NeedMoreInput()
        self.bitpos += n

    def align_to_byte(self) -> int:
        """Jump to next byte boundary; returns the discarded bits."""
        pad = (-self.bitpos) & 7
        v = self.take(pad) if pad else 0
        return v

    def read_bytes(self, n: int) -> bytes:
        assert self.bitpos & 7 == 0
        byte0 = self.bitpos >> 3
        if (byte0 + n) * 8 > self.nbits:
            raise NeedMoreInput()
        self.bitpos += n * 8
        return self.data[byte0:byte0 + n].tobytes()


class NeedMoreInput(Exception):
    """Input exhausted mid-symbol (streaming decode suspension point)."""


class BitWriter:
    """Records (value, nbits) pairs; packs once at the end.

    Deferred packing keeps the host writer O(n) vectorized and mirrors the
    device bit-packer: bit offsets are an exclusive scan of the lengths and
    each value is scatter-OR'd into a byte (here: int64 word) stream.
    """

    __slots__ = ("_vals", "_bits", "_nbits")

    def __init__(self):
        self._vals = []
        self._bits = []
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._vals.append(value)
        self._bits.append(nbits)
        self._nbits += nbits

    def write_arrays(self, values, nbits) -> None:
        """Bulk append of per-symbol (value, nbits) arrays."""
        values = np.asarray(values, dtype=np.int64)
        nbits = np.asarray(nbits, dtype=np.int64)
        keep = nbits > 0
        self._vals.extend(values[keep].tolist())
        self._bits.extend(nbits[keep].tolist())
        self._nbits += int(nbits[keep].sum())

    def align_to_byte(self) -> None:
        pad = (-self._nbits) & 7
        if pad:
            self.write(0, pad)

    @property
    def bit_length(self) -> int:
        return self._nbits

    def getvalue(self) -> bytes:
        """Pack all recorded codes into bytes (vectorized)."""
        if not self._vals:
            return b""
        vals = np.array(self._vals, dtype=np.uint64)
        bits = np.array(self._bits, dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(bits)[:-1]])
        total_bits = int(starts[-1] + bits[-1])
        nwords = (total_bits + 63) // 64 + 1
        # Each value may straddle a 64-bit word boundary: emit two
        # contributions and accumulate with scatter-add (bit ranges are
        # disjoint, so add == or).
        word = starts >> 6
        shift = (starts & 63).astype(np.uint64)
        lo = (vals << shift)  # uint64 wraps; low part
        hi_shift = (64 - shift) & np.uint64(63)
        hi = np.where(shift > 0, vals >> hi_shift, 0).astype(np.uint64)
        acc = np.zeros(nwords, dtype=np.uint64)
        np.add.at(acc, word, lo)
        np.add.at(acc, word + 1, hi)
        out = acc.astype("<u8").view(np.uint8)
        nbytes = (total_bits + 7) // 8
        return out[:nbytes].tobytes()
