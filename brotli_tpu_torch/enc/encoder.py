"""Encoder routing (counterpart of brotli_tpu.enc.encoder.encode and
StreamingEncoder): the q10/q11 device encode, where the optimal-parse DP
streams finished metablock spans into a native serialization worker;
encoder="device" off that route, the device matcher (q<=9) or the
device DP (q10/q11 in modes 1 and 2) with the Python serializer
(`_write_blocks` -> bitstream.store_metablock); and the native one-shot
and streaming encoders for everything else the port serves.
"""

import queue
import threading

import numpy as np

from .. import native
from ..format import constants as C
from ..format.bitio import BitWriter
from ..ops.matcher import find_matches_device
from ..ops.optimal import find_matches_optimal
from ..utils import trace
from ..utils.device import resolve
from . import bitstream, matcher
from .quality import policy

_DEFAULT_MB_BITS = 22  # metablock size (lgblock); <= 24
MIN_DEVICE_INPUT = 1 << 18  # the JAX package's device-encode threshold
_VECTOR_THRESHOLD = 1 << 16  # the JAX package's device-matcher threshold
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
    - encoder="device" on any other input with no dictionary and no
      base64, lgwin <= 24: q<=9 on 64 KiB or more runs the device
      matcher (K2) and q10/q11 on 256 KiB or more (modes 1 and 2) the
      device DP, both on `device`, then the Python serializer;
    - any other input in mode 0, 1 or 2 with no dictionary and no
      base64: the native one-shot encoder ("auto", "native").

    `dp`: the device DP's ops.optimal.DPConfig (None = the default v3
    parse), in place of the JAX package's BROTLI_TPU_DP and the other
    variables of its DP; the native routes ignore it.

    A route never gives way to another after a failure. What only the
    JAX package's Python pipeline serves raises NotImplementedError:
    serialized dictionaries, base64 mode, a dictionary with mode 1 or
    2, a raw dictionary beyond lgwin 24, `dictionary=b""`,
    encoder="python", and encoder="device" under 64 KiB (q<=9) or
    256 KiB (q10/q11), beyond lgwin 24 or with a dictionary."""
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
    if (dictionary is not None and len(dictionary) > 0 and plain
            and encoder != "device"):
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
        return _encode_device(raw, quality, lgwin, lgblock, mode,
                              dictionary, base64_mode, resolve(device), dp)
    if dictionary is None and mode in (0, 1, 2) and not base64_mode:
        return native.encode(raw, quality, lgwin, mode=mode)
    raise NotImplementedError(
        "base64 mode, a dictionary with mode 1 or 2, a raw dictionary "
        "beyond lgwin 24 or an empty one: the Python pipeline "
        f"({_SECOND_SLICE})")


def find_matches(arr, max_distance, quality, device=None, dp=None):
    """The device match finders of brotli_tpu.enc.encoder.find_matches
    (its quality dispatch on a device backend): the device DP at
    q10/q11 on 256 KiB or more, the device matcher at q<=9 on 64 KiB or
    more, both on `device`. The host matchers and the host DP it takes
    elsewhere raise NotImplementedError."""
    if policy(quality).optimal_parse:
        if len(arr) >= MIN_DEVICE_INPUT:
            return find_matches_optimal(arr, max_distance, device=device,
                                        dp=dp)
        raise NotImplementedError(
            f"q10/q11 under 256 KiB: the host DP ({_SECOND_SLICE})")
    if len(arr) >= _VECTOR_THRESHOLD:
        return find_matches_device(arr, max_distance, quality,
                                   device=device)
    raise NotImplementedError(
        f"under 64 KiB: the greedy host matcher ({_SECOND_SLICE})")


def _encode_device(raw, quality, lgwin, lgblock, mode, dictionary,
                   base64_mode, device, dp):
    """The JAX package's pipeline under BROTLI_TPU_ENCODER=device on a
    device backend, past its q10/q11 mode-0 streamed route: the device
    match finder over the whole input, then `_write_blocks` with the
    mode's context model, and the uncompressed fallback."""
    if base64_mode:
        raise NotImplementedError(f"base64 mode ({_SECOND_SLICE})")
    if dictionary is not None:
        raise NotImplementedError(
            f"encoder='device' with a dictionary ({_SECOND_SLICE})")
    if lgwin > C.MAX_WINDOW_BITS:
        raise NotImplementedError(
            f"encoder='device' beyond lgwin 24 ({_SECOND_SLICE})")
    n = len(raw)
    arr = np.frombuffer(raw, dtype=np.uint8)
    with trace.stage("match-find"):
        matches = find_matches(arr, C.max_backward_distance(lgwin),
                               quality, device, dp)
    bw = BitWriter()
    bitstream.write_stream_header(bw, lgwin)
    # mode hint (parity: BrotliEncoderMode + ChooseContextMode): TEXT
    # forces the UTF8 context model, FONT the signed-byte model
    _write_blocks(bw, arr, 0, n, matches, lgblock, is_last=True,
                  quality=quality, context_mode={1: 2, 2: 3}.get(mode))
    bw.align_to_byte()
    out = bw.getvalue()
    if len(out) >= n + 4:
        return _store_uncompressed(arr, lgwin)
    return out


def _write_blocks(bw, arr, lo, hi, matches, lgblock, is_last,
                  ring=None, quality=1, context_mode=None):
    """Serialize region [lo, hi) as metablocks; returns the distance
    ring state after the last block."""
    mb_size = 1 << lgblock
    boundaries = list(range(lo + mb_size, hi, mb_size)) + [hi]
    m, lens, dists, flags = matcher.split_matches_at(*matches, boundaries)
    pos = lo
    for bi, b in enumerate(boundaries):
        block_last = is_last and bi == len(boundaries) - 1
        cmds = matcher.matches_to_commands(m, lens, dists, flags, pos, b)
        with trace.stage("serialize"):
            ring = bitstream.store_metablock(
                bw, arr, pos, b - pos, cmds, block_last, ring,
                quality=quality, context_mode=context_mode)
        pos = b
    return ring


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
