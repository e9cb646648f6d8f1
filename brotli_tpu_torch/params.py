"""Validated encoder/decoder parameter surface (copy of
brotli_tpu.params; `compress_with` calls the port's `compress`).

Role parity: the reference's parameter enums + SetParameter validation
(c/include/brotli/encode.h BrotliEncoderParameter,
c/include/brotli/decode.h BrotliDecoderParameter, c/enc/encode.c
BrotliEncoderSetParameter / SanitizeParams). Python callers usually
pass keyword arguments; this module is the single place their ranges
and interactions are checked, and the named-constant surface for
tooling that wants the reference's vocabulary.
"""

import dataclasses
import enum

from .format import constants as C


class Mode(enum.IntEnum):
    """BrotliEncoderMode (encode.h:46-58)."""
    GENERIC = 0
    TEXT = 1
    FONT = 2


class EncoderParameter(enum.IntEnum):
    """BrotliEncoderParameter (encode.h:161-260)."""
    MODE = 0
    QUALITY = 1
    LGWIN = 2
    LGBLOCK = 3
    DISABLE_LITERAL_CONTEXT_MODELING = 4
    SIZE_HINT = 5
    LARGE_WINDOW = 6
    NPOSTFIX = 7
    NDIRECT = 8
    STREAM_OFFSET = 9
    BASE64_MODE = 10


class DecoderParameter(enum.IntEnum):
    """BrotliDecoderParameter (decode.h:115-130)."""
    DISABLE_RING_BUFFER_REALLOCATION = 0
    LARGE_WINDOW = 1


MIN_QUALITY = 0
MAX_QUALITY = 11
MIN_WINDOW_BITS = C.MIN_WINDOW_BITS
MAX_WINDOW_BITS = C.MAX_WINDOW_BITS
LARGE_MAX_WINDOW_BITS = C.LARGE_MAX_WINDOW_BITS
MIN_INPUT_BLOCK_BITS = C.MIN_INPUT_BLOCK_BITS
MAX_INPUT_BLOCK_BITS = C.MAX_INPUT_BLOCK_BITS


@dataclasses.dataclass
class EncoderParams:
    """Checked parameter bundle; raises ValueError on invalid values
    (strict where the reference's SetParameter would reject; the
    quality/window clamps of SanitizeParams are applied on `sanitize`).
    """

    mode: int = Mode.GENERIC
    quality: int = 11
    lgwin: int = 22
    lgblock: int = 0
    large_window: bool = False
    base64_mode: bool = False
    dictionary: bytes = None

    def validate(self) -> "EncoderParams":
        if self.mode not in (Mode.GENERIC, Mode.TEXT, Mode.FONT):
            raise ValueError(f"invalid mode {self.mode}")
        if not isinstance(self.quality, int) or not (
                MIN_QUALITY <= self.quality <= MAX_QUALITY):
            raise ValueError(f"invalid quality {self.quality}")
        cap = LARGE_MAX_WINDOW_BITS if self.large_window \
            else MAX_WINDOW_BITS
        if self.lgwin != 0 and not (
                MIN_WINDOW_BITS <= self.lgwin <= cap):
            raise ValueError(f"invalid lgwin {self.lgwin}")
        if self.lgblock != 0 and not (
                MIN_INPUT_BLOCK_BITS <= self.lgblock
                <= MAX_INPUT_BLOCK_BITS):
            raise ValueError(f"invalid lgblock {self.lgblock}")
        return self

    def sanitize(self) -> "EncoderParams":
        """Clamp semantics of c/enc/encode.c SanitizeParams."""
        from .enc.encoder import _sanitize_params
        q, w, b = _sanitize_params(self.quality, self.lgwin or 22,
                                   self.lgblock, self.large_window)
        return dataclasses.replace(self, quality=q, lgwin=w, lgblock=b)


def compress_with(params: EncoderParams, data: bytes) -> bytes:
    """Compress through a validated parameter bundle."""
    from . import compress
    p = params.validate()
    return compress(data, mode=p.mode, quality=p.quality, lgwin=p.lgwin,
                    lgblock=p.lgblock, dictionary=p.dictionary,
                    large_window=p.large_window,
                    base64_mode=p.base64_mode)
