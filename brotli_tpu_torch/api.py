"""Public API of the port (the brotli_tpu.api surface): module-level
``compress``/``decompress``/``decompress_concatenated``, streaming
``Compressor``/``Decompressor`` (with ``output_buffer_limit``
back-pressure), ``estimate_peak_memory``, the reporting hooks and a
single ``error`` exception type.

``compress`` routes as brotli_tpu does (enc/encoder.encode): q10/q11 on
256 KiB or more runs the device DP on the card, what the native runtime
takes runs there, and the rest (encoder="device" or "python", base64
mode, serialized dictionaries, a dictionary with mode 1 or 2, ...) the
Python pipeline, whose match finders take the card unless
backend="numpy". The default decoders are the native runtime's;
``decompress(decoder="device")`` resolves on the card, and
``decoder="python"`` takes the Python decoder (dec/decoder.py,
dec/stream.py), as do serialized dictionaries with custom words or
transforms.
"""

from . import native
from .dec.decoder import Decoder, FormatError
from .dec.device_decode import decompress_device
from .dec.stream import StreamDecoder
from .enc.encoder import StreamingEncoder, encode
from .format import shared_dictionary as shd
from .utils import trace

# Compression modes (parity: c/include/brotli/encode.h BrotliEncoderMode).
MODE_GENERIC = 0
MODE_TEXT = 1
MODE_FONT = 2

_QUALITY_DEFAULT = 11
_LGWIN_DEFAULT = 22


class error(Exception):
    """Raised on invalid input or parameters (parity: brotli.error)."""


# reporting seam (BrotliEncoderOnStart/OnFinish role): process-wide
# hooks observing every compress call
_on_start = None
_on_finish = None


def set_reporting_callbacks(on_start=None, on_finish=None):
    """Install metrics hooks: on_start(op: str, in_len: int) and
    on_finish(op: str, in_len: int, out_len: int)."""
    global _on_start, _on_finish
    _on_start = on_start
    _on_finish = on_finish


def estimate_peak_memory(input_size, quality=_QUALITY_DEFAULT,
                         lgwin=_LGWIN_DEFAULT) -> int:
    """Upper bound (bytes) on the native encoder's transient heap for a
    one-shot encode of `input_size` bytes (the
    BrotliEncoderEstimatePeakMemoryUsage role), excluding the caller's
    own input and output copies. The device route's memory is the
    card's (torch.cuda.max_memory_allocated)."""
    return native.peak_memory(input_size, quality, lgwin)


def _serialized(dictionary) -> bool:
    """A serialized shared dictionary (magic 0x91 0x00), not raw bytes."""
    return bool(dictionary) and bytes(dictionary[:2]) == b"\x91\x00"


def _split_dictionary(dictionary):
    """(raw LZ77 bytes or None, the parsed serialized dictionary or
    None). A serialized one must be parsed for every decoder: its
    container bytes taken as raw compound data decode to other bytes."""
    if _serialized(dictionary):
        return None, shd.parse(bytes(dictionary))
    return (bytes(dictionary) if dictionary else None), None


def _compound(raw, shared) -> bytes:
    """The native decoder's compound data: the raw dictionary, or the
    serialized one's prefixes."""
    if shared is not None:
        return b"".join(shared.prefixes)
    return raw or b""


def _needs_python_decoder(shared) -> bool:
    """Custom word lists or transforms: only the Python decoder takes
    them; raw prefixes attach to the native decoder as compound data."""
    return shared is not None and bool(shared.word_lists
                                       or shared.transform_lists)


def compress(string, mode=MODE_GENERIC, quality=_QUALITY_DEFAULT,
             lgwin=_LGWIN_DEFAULT, lgblock=0, dictionary=None,
             large_window=False, base64_mode=False, *, encoder="auto",
             backend="auto", device=None, dp=None) -> bytes:
    """One-shot compression; the positional order is
    brotli_tpu.compress's. `large_window` allows lgwin up to 30 (non-RFC
    extension; the receiver must opt in too). `dictionary` may be raw
    LZ77 bytes or a serialized shared dictionary (its raw prefixes
    attach as compound data; its custom word lists are matched by the
    encoder).

    `encoder` takes the place of the JAX package's BROTLI_TPU_ENCODER:
    "auto" runs q10/q11 on 256 KiB or more (mode 0, no dictionary,
    lgwin <= 24) on `device` (None = "cuda", raising without it; "cpu"
    runs the plain versions of the kernels) and what the native encoder
    takes there; "native" takes the native encoder wherever it can;
    "device" and "python" the Python pipeline, "device" with the card's
    q10/q11 route first, a raw dictionary included (RFC 9842 `dcb`: the
    dictionary is the parse's history). `backend` takes the place of its
    BROTLI_TPU_BACKEND: "auto" lets the Python pipeline's match finders
    take the card where the JAX package takes its device, "numpy" keeps
    them on the host. See enc/encoder.encode.

    `dp` takes the place of the variables of the JAX package's device DP
    (BROTLI_TPU_DP, BROTLI_TPU_RING_SCAN, ...): a
    brotli_tpu_torch.DPConfig, None for the default v3 parse. Only the
    card's routes read it."""
    shared = None
    if _serialized(dictionary):
        sd = shd.parse(bytes(dictionary))
        dictionary = b"".join(sd.prefixes) or None
        if sd.word_lists:
            shared = sd  # custom-word matching in the encoder
    if _on_start is not None:
        _on_start("compress", len(string))
    with trace.request("compress", len(string)) as req:
        try:
            out = encode(bytes(string), quality=quality, lgwin=lgwin,
                         lgblock=lgblock, mode=mode, dictionary=dictionary,
                         large_window=large_window, base64_mode=base64_mode,
                         shared=shared, encoder=encoder, backend=backend,
                         device=device, dp=dp)
        except ValueError as e:
            raise error(str(e)) from e
        req.done(len(out))
    if _on_finish is not None:
        _on_finish("compress", len(string), len(out))
    return out


def decompress(string, dictionary=None, large_window=False, *,
               decoder="native", device=None) -> bytes:
    """Decode a complete brotli stream; the positional order is
    brotli_tpu.decompress's. `dictionary`: raw LZ77 bytes (compound
    dictionary) or a serialized shared dictionary (magic 0x91 0x00);
    `large_window`: accept the non-RFC large-window extension.
    `decoder` takes the place of the JAX package's BROTLI_TPU_DECODER:
    "native" is the native decoder; "python" the Python decoder
    (dec/decoder.py); "device" the native symbol parse and the LZ
    resolve on `device` (None = "cuda", raising without it; "cpu" runs
    the plain resolve). As in the JAX package, a dictionary with
    decoder="device", and a serialized dictionary with custom word
    lists or transforms, take the Python decoder."""
    if decoder not in ("native", "device", "python"):
        raise ValueError(f"unknown decoder {decoder!r}")
    data = bytes(string)
    dictionary, shared = _split_dictionary(dictionary)
    if decoder == "device" and (dictionary or shared is not None):
        decoder = "python"
    if decoder == "native" and _needs_python_decoder(shared):
        decoder = "python"
    if decoder == "python":
        try:
            return Decoder(dictionary=dictionary, shared=shared,
                           large_window=large_window).decompress(data)
        except FormatError as e:
            raise error(str(e)) from e
        except Exception as e:  # truncated input etc.
            raise error(f"decompression failed: {e}") from e
    try:
        if decoder == "device":
            return decompress_device(data, large_window, device=device)
        return native.decode(data, compound=_compound(dictionary, shared),
                             large_window=large_window)
    except ValueError as e:
        raise error(str(e)) from e


def decompress_concatenated(string) -> bytes:
    """Decode back-to-back concatenated streams (the reference CLI's
    brcat / --concatenated mode): the chunked native decoder reports
    the exact end of each stream."""
    data = bytes(string)
    out = []
    offset = 0
    while offset < len(data):
        sd = native.StreamDecoder(allow_trailing=True)
        try:
            out.append(sd.feed(data[offset:]))
        except native.DecodeError as e:
            raise error(str(e)) from e
        if not sd.finished:
            raise error("truncated concatenated stream")
        consumed = sd.consumed
        if consumed == 0:
            raise error("stalled decoding concatenated stream")
        offset += consumed
    return b"".join(out)


class Compressor:
    """Streaming compressor (process/flush/finish). ``flush`` emits a
    byte-aligned, independently decodable prefix (FLUSH semantics of
    BrotliEncoderCompressStream); ``finish`` closes the stream. Mode 0
    runs the native stream encoder; modes 1 and 2 (and
    encoder="python") buffer the input and run the Python pipeline at
    each flush, its match finders on `device` unless backend="numpy"
    (enc/encoder.StreamingEncoder)."""

    def __init__(self, mode=MODE_GENERIC, quality=_QUALITY_DEFAULT,
                 lgwin=_LGWIN_DEFAULT, lgblock=0, *, encoder="auto",
                 backend="auto", device=None, dp=None):
        self._enc = StreamingEncoder(quality=quality, lgwin=lgwin,
                                     lgblock=lgblock, mode=mode,
                                     encoder=encoder, backend=backend,
                                     device=device, dp=dp)

    def process(self, string) -> bytes:
        return self._enc.process(bytes(string))

    def flush(self) -> bytes:
        return self._enc.flush()

    def emit_metadata(self, payload) -> bytes:
        """Emit buffered input, then a metadata block (parity:
        BROTLI_OPERATION_EMIT_METADATA)."""
        return self._enc.emit_metadata(bytes(payload))

    def finish(self) -> bytes:
        return self._enc.finish()


class Decompressor:
    """Streaming decompressor with output back-pressure:
    ``output_buffer_limit`` caps the bytes one ``process`` call returns
    (parity: python/_brotli.c Decompressor). `decoder` takes the place
    of the JAX package's BROTLI_TPU_DECODER: "native" is the native
    chunked decoder, which suspends at the cap, mid-metablock or
    mid-copy; "python" the Python streaming core (dec/stream.py), whose
    decoder thread parks once undrained output reaches the cap, at one
    emitted chunk's granularity. Either way a small chunk that expands
    enormously is never materialized. While output is pending,
    ``can_accept_more_data()`` is False and ``process(b"")`` drains the
    next slice. A raw dictionary attaches as compound data, and so do
    the prefixes of a serialized one; custom word lists or transforms
    take the Python core, as in the JAX package."""

    def __init__(self, dictionary=None, *, decoder="native"):
        if decoder not in ("native", "python"):
            raise ValueError(f"unknown decoder {decoder!r}")
        raw, shared = _split_dictionary(dictionary)
        self._native = (decoder == "native"
                        and not _needs_python_decoder(shared))
        if self._native:
            self._inc = native.StreamDecoder(
                compound=_compound(raw, shared))
        else:
            self._inc = StreamDecoder(dictionary=raw, shared=shared)
        self._pending = bytearray()

    def process(self, string=b"", output_buffer_limit=None) -> bytes:
        if string and not self.can_accept_more_data():
            raise error("cannot accept more data: drain pending output")
        if self._native:
            self._inc.set_output_limit(output_buffer_limit or 0)
            try:
                return self._inc.feed(bytes(string))
            except ValueError as e:
                raise error(str(e)) from e
        self._inc.set_output_limit(output_buffer_limit)
        try:
            self._pending += self._inc.feed(bytes(string))
        except (FormatError, ValueError) as e:
            raise error(str(e)) from e
        if output_buffer_limit is None:
            out = bytes(self._pending)
            self._pending.clear()
            return out
        out = bytes(self._pending[:output_buffer_limit])
        del self._pending[:output_buffer_limit]
        return out

    def is_finished(self) -> bool:
        return (self._inc.finished and not self._pending
                and not self._inc.pending_output)

    def can_accept_more_data(self) -> bool:
        return (not self._inc.finished and not self._pending
                and not self._inc.pending_output)
