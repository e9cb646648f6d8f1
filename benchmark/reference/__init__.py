"""The benchmark's plain reference: an RFC 7932 decoder and the stream
header reader that the correctness check uses. Frozen copies of the
port's pure-NumPy decoder and the format modules it needs, plus the
static dictionary in benchmark/data; nothing here imports the measured
program, jax, or the JAX package."""

from .bitio import BitReader
from .decoder import Decoder, FormatError, _read_window_bits


def window_bits(stream: bytes) -> int:
    """The window bits (WBITS) that a stream's header declares."""
    return _read_window_bits(BitReader(bytes(stream[:8])), True)[0]


def decompress(stream: bytes, dictionary: bytes = None) -> bytes:
    """The bytes a stream decodes to, with `dictionary`, where given, as
    its raw (compound) LZ77 dictionary; raises FormatError on an invalid
    stream."""
    return Decoder(dictionary=dictionary).decompress(bytes(stream))


__all__ = ["FormatError", "decompress", "window_bits"]
