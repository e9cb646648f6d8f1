"""Encoder routing (counterpart of brotli_tpu.enc.encoder.encode and
StreamingEncoder, their native halves): the q10/q11 device encode, where
the optimal-parse DP streams finished metablock spans into a native
serialization worker, and the native one-shot and streaming encoders
for everything else the port serves.
"""

import queue
import threading

import numpy as np

from .. import native
from ..format import constants as C
from ..format.bitio import BitWriter
from ..ops.optimal import find_matches_optimal
from ..utils import trace
from ..utils.device import resolve
from . import bitstream

_DEFAULT_MB_BITS = 22  # metablock size (lgblock); <= 24
MIN_DEVICE_INPUT = 1 << 18  # the JAX package's device-encode threshold
ENCODERS = ("auto", "native", "device", "python")
_SECOND_SLICE = "ROADMAP M13, second slice"


def _serialized(dictionary) -> bool:
    """A serialized shared dictionary (magic 0x91 0x00), not raw bytes."""
    return bool(dictionary) and bytes(dictionary[:2]) == b"\x91\x00"


def _sanitize_params(quality, lgwin, lgblock, large_window=False):
    quality = max(0, min(11, int(quality)))
    cap = C.LARGE_MAX_WINDOW_BITS if large_window else C.MAX_WINDOW_BITS
    lgwin = max(C.MIN_WINDOW_BITS, min(cap, int(lgwin)))
    if lgblock == 0:
        lgblock = min(_DEFAULT_MB_BITS, max(16, lgwin))
    lgblock = max(C.MIN_INPUT_BLOCK_BITS,
                  min(C.MAX_INPUT_BLOCK_BITS, int(lgblock)))
    return quality, lgwin, lgblock


def encode(data: bytes, quality: int = 11, lgwin: int = 22,
           lgblock: int = 0, mode: int = 0, dictionary=None,
           large_window: bool = False, base64_mode: bool = False, *,
           encoder: str = "auto", device=None, dp=None) -> bytes:
    """One-shot encode, routed by the JAX package's own conditions
    before any work (brotli_tpu.enc.encoder.encode), with `encoder` in
    place of its BROTLI_TPU_ENCODER:

    - an empty input: the stream header and an empty last metablock;
    - a raw dictionary (mode 0, no base64, lgwin <= 24): the native
      encoder with the dictionary attached ("auto", "native");
    - q10/q11 on 256 KiB or more, mode 0, no dictionary, no base64,
      lgwin <= 24: the device DP on `device` ("auto", "device"; None
      means the card and raises without one), the native q10/q11 tier
      with "native";
    - any other input in mode 0, 1 or 2 with no dictionary and no
      base64: the native one-shot encoder ("auto", "native").

    `dp`: the device DP's ops.optimal.DPConfig (None = the default v3
    parse), in place of the JAX package's BROTLI_TPU_DP and the other
    variables of its DP; the native routes ignore it.

    A route never gives way to another after a failure. What only the
    JAX package's Python pipeline serves raises NotImplementedError:
    serialized dictionaries, base64 mode, a dictionary with mode 1 or
    2, a raw dictionary beyond lgwin 24, `dictionary=b""`,
    encoder="python", and encoder="device" off the DP's inputs."""
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {encoder!r}")
    if encoder == "python":
        raise NotImplementedError(
            f"encoder='python', the Python pipeline ({_SECOND_SLICE})")
    quality, lgwin, lgblock = _sanitize_params(quality, lgwin, lgblock,
                                               large_window)
    raw = bytes(data)
    n = len(raw)
    if n == 0:
        bw = BitWriter()
        bitstream.write_stream_header(bw, lgwin)
        bitstream.write_last_empty(bw)
        return bw.getvalue()
    if _serialized(dictionary):
        raise NotImplementedError(
            f"serialized shared dictionaries ({_SECOND_SLICE})")
    plain = (mode == 0 and not base64_mode
             and lgwin <= C.MAX_WINDOW_BITS)
    if dictionary is not None and len(dictionary) > 0 and plain:
        if encoder == "device":
            raise NotImplementedError(
                f"encoder='device' with a dictionary ({_SECOND_SLICE})")
        return native.encode_with_dict(raw, quality, lgwin,
                                       bytes(dictionary))
    if (dictionary is None and plain and quality >= 10
            and n >= MIN_DEVICE_INPUT and encoder != "native"):
        arr = np.frombuffer(raw, dtype=np.uint8)
        out = _encode_q11_streamed(arr, n, C.max_backward_distance(lgwin),
                                   quality, lgblock, lgwin,
                                   resolve(device), dp)
        if len(out) >= n + 4:
            return _store_uncompressed(arr, lgwin)
        return out
    if encoder == "device":
        raise NotImplementedError(
            "encoder='device' below q10, under 256 KiB, in modes 1/2 or "
            f"beyond lgwin 24: the Python pipeline ({_SECOND_SLICE})")
    if dictionary is None and mode in (0, 1, 2) and not base64_mode:
        return native.encode(raw, quality, lgwin, mode=mode)
    raise NotImplementedError(
        "base64 mode, a dictionary with mode 1 or 2, a raw dictionary "
        "beyond lgwin 24 or an empty one: the Python pipeline "
        f"({_SECOND_SLICE})")


def _encode_q11_streamed(arr, n, maxback, quality, lgblock, lgwin,
                         device=None, dp=None):
    """Producer/consumer q11 encode: the device DP streams finished
    metablock spans into a serialization worker.

    Every span serializes to a byte-aligned blob (non-last spans end
    with an empty metadata block, the BROTLI_OPERATION_FLUSH stitch) by
    the native matches-array serializer; the 4-slot distance ring
    carries across spans."""
    q = queue.Queue(maxsize=4)
    err = []
    state = {"ring": None}
    parts = []
    native.get_lib()
    data_bytes = arr.tobytes()

    def serialize_span(lo, hi, matches):
        blob, ring = native.serialize_region(
            data_bytes, lo, hi, matches, quality, lgwin,
            ring=state["ring"], write_header=(lo == 0), is_last=hi >= n,
            align_end=True)
        state["ring"] = ring
        parts.append(blob)

    def worker():
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                with trace.stage("serialize"):
                    serialize_span(*item)
        except BaseException as e:  # surfaced on the producer thread
            err.append(e)
            # keep draining so a blocked producer can always make
            # progress (a dead consumer + full queue would deadlock)
            while True:
                if q.get() is None:
                    return

    t = threading.Thread(target=worker)
    t.start()

    def on_block(lo, hi, matches):
        if err:
            raise err[0]
        q.put((lo, hi, matches))

    try:
        find_matches_optimal(arr, maxback, on_block=on_block,
                             mb_size=1 << lgblock, device=device, dp=dp)
    finally:
        q.put(None)
        t.join()
    if err:
        raise err[0]
    return b"".join(parts)


def _store_uncompressed(arr, lgwin) -> bytes:
    """Whole-input uncompressed fallback (parity: encode.c
    MakeUncompressedStream)."""
    bw = BitWriter()
    bitstream.write_stream_header(bw, lgwin)
    n = len(arr)
    pos = 0
    while pos < n:
        chunk = min(n - pos, bitstream.MAX_MLEN)
        bitstream.write_uncompressed_metablock(
            bw, arr[pos:pos + chunk].tobytes())
        pos += chunk
    bitstream.write_last_empty(bw)
    bw.align_to_byte()
    return bw.getvalue()


class StreamingEncoder:
    """Streaming encoder over the native stream encoder (the native half
    of brotli_tpu.enc.encoder.StreamingEncoder): hash-chain state
    persists across chunks; each flush ends with an empty metadata
    block, so every flushed prefix decodes on its own. Modes 1 and 2
    take the JAX package's Python pipeline and raise
    NotImplementedError."""

    def __init__(self, quality=11, lgwin=22, lgblock=0, mode=0):
        if mode != 0:
            raise NotImplementedError(
                f"streaming in mode {mode}: the Python pipeline "
                f"({_SECOND_SLICE})")
        self.params = _sanitize_params(quality, lgwin, lgblock)
        self._finished = False
        self._native = native.StreamEncoder(self.params[0],
                                            self.params[1])

    def process(self, chunk: bytes) -> bytes:
        if self._finished:
            raise ValueError("encoder already finished")
        return self._native.process(bytes(chunk))

    def emit_metadata(self, payload: bytes) -> bytes:
        """Flush buffered input, then write one metadata block
        (byte-aligned, opaque to decompression)."""
        if self._finished:
            raise ValueError("encoder already finished")
        return self._native.emit_metadata(bytes(payload))

    def flush(self) -> bytes:
        if self._finished:
            return b""
        return self._native.flush()

    def finish(self) -> bytes:
        if self._finished:
            return b""
        self._finished = True
        return self._native.finish()
