"""Public API of the port: one-shot `compress` through the q10/q11
device optimal-parse pipeline, `decompress` through the native decoder
or the device decoder, and one `error` type (the brotli_tpu.api
surface, without the streaming classes yet). The q<=9 device encode is
`parallel.shard.compress_sharded`."""

import numpy as np

from . import native
from .dec.device_decode import decompress_device
from .enc.encoder import (_encode_q11_streamed, _sanitize_params,
                          _store_uncompressed)
from .format import constants as C
from .utils.device import resolve

MIN_DEVICE_INPUT = 1 << 18  # the JAX package's device-encode threshold


class error(Exception):
    """Raised on invalid input or parameters (parity: brotli.error)."""


def compress(string, mode=0, quality=11, lgwin=22, lgblock=0,
             dictionary=None, large_window=False, base64_mode=False, *,
             device=None) -> bytes:
    """One-shot q10/q11 compression on `device` (None = "cuda"; "cpu"
    runs the plain PyTorch versions of the kernels). The positional
    order is brotli_tpu.compress's. Qualities up to 9, inputs under
    256 KiB, dictionaries, large windows, base64 mode and modes other
    than generic are not ported yet and raise NotImplementedError."""
    quality, lgwin, lgblock = _sanitize_params(quality, lgwin, lgblock)
    raw = bytes(string)
    n = len(raw)
    if quality < 10:
        raise NotImplementedError(
            "quality <= 9: the native one-shot encoder, and the device "
            "matcher's route through the Python metablock writer "
            "(ROADMAP M13; parallel.shard.compress_sharded runs the "
            "device matcher)")
    if n < MIN_DEVICE_INPUT:
        raise NotImplementedError(
            "inputs under 256 KiB take the host tiers (ROADMAP M13)")
    if dictionary is not None or large_window or mode != 0 or base64_mode:
        raise NotImplementedError(
            "dictionaries, large windows, base64 mode and modes "
            "(ROADMAP M13)")
    dev = resolve(device)
    arr = np.frombuffer(raw, dtype=np.uint8)
    try:
        out = _encode_q11_streamed(arr, n, C.max_backward_distance(lgwin),
                                   quality, lgblock, lgwin, dev)
    except ValueError as e:
        raise error(str(e)) from e
    if len(out) >= n + 4:
        return _store_uncompressed(arr, lgwin)
    return out


def decompress(string, dictionary=None, large_window=False, *,
               decoder="native", device=None) -> bytes:
    """Decode a complete brotli stream; the positional order is
    brotli_tpu.decompress's. `decoder` takes the place of the JAX
    package's BROTLI_TPU_DECODER: "native" is the native decoder;
    "device" the native symbol parse (which takes `large_window`) and
    the LZ resolve on `device` (None = "cuda", raising without it;
    "cpu" runs the plain resolve); "python", the Python decoder, is not
    ported yet. Dictionaries, and `large_window` through the native
    decoder, raise NotImplementedError (ROADMAP M13)."""
    if decoder == "python":
        raise NotImplementedError("the Python decoder (ROADMAP M13)")
    if decoder not in ("native", "device"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if dictionary:
        raise NotImplementedError("decoding with a dictionary (ROADMAP M13)")
    if large_window and decoder == "native":
        raise NotImplementedError(
            "large windows through the native decoder (ROADMAP M13; "
            "decoder=\"device\" takes them)")
    try:
        if decoder == "device":
            return decompress_device(bytes(string), large_window,
                                     device=device)
        return native.decode(bytes(string))
    except ValueError as e:
        raise error(str(e)) from e
