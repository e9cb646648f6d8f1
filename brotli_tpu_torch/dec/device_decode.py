"""Device-path decompression: native symbol parse + device LZ resolve
(counterpart of brotli_tpu.dec.device_decode).

Stage A on the host parses headers, prefix codes and the symbol stream
(bit-serial: each code's length gates the next code's position) in
native C (btpu_dec.c btpu_parse_stream); stage B resolves the LZ copy
graph on the card by pointer doubling (ops/lz_resolve.py, K5).
Reference role: c/dec/decode.c:2401-2406 ProcessCommands, re-split so
the byte movement is data-parallel.

A stream the native parse does not take raises; nothing falls back.
A dictionary sends `api.decompress` to the Python decoder before this
path is chosen, as in the JAX package.
"""

from .. import native
from ..ops import lz_resolve
from ..utils import trace
from ..utils.device import resolve


def decompress_device(data: bytes, large_window: bool = False,
                      device=None) -> bytes:
    """Decode a brotli stream with the copy resolution on `device`
    (None = "cuda"; "cpu" runs the plain resolve). Raises
    native.DecodeError (a ValueError) on a stream the parse rejects."""
    dev = resolve(device)
    with trace.stage("decode.parse"):
        lits, cn, cc, cd, depth = native.parse_stream(bytes(data),
                                                      large_window)
    with trace.stage("decode.resolve"):
        return lz_resolve.resolve(lits, cn, cc, cd, max_depth=depth,
                                  device=dev)
