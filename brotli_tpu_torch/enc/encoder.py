"""Encoder routing and the Python pipeline (counterpart of
brotli_tpu.enc.encoder): quality dispatch, metablock partitioning,
uncompressed fallback, streaming.

Routes, chosen by the JAX package's conditions before any work:
- the native one-shot and streaming encoders, for what they take;
- the q10/q11 device encode, where the optimal-parse DP on the card
  streams finished metablock spans into a native serialization worker;
- the Python pipeline for everything else: a match finder over the
  whole input (`find_matches`: the device DP or matcher on the card,
  or the host matchers and the host DP), then per-metablock command
  streams through the Python serializer (`_write_blocks` ->
  bitstream.store_metablock).

`backend` takes the place of the JAX package's BROTLI_TPU_BACKEND:
"auto" takes the card (or `device`) wherever the JAX package takes its
device backend, "numpy" only the host matchers and the host DP. No
route gives way to another after a failure.
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
from . import optimal as host_dp
from .quality import policy

_DEFAULT_MB_BITS = 22  # metablock size (lgblock); <= 24
MIN_DEVICE_INPUT = 1 << 18  # the JAX package's device-DP threshold
_VECTOR_THRESHOLD = 1 << 16  # below this the serial matcher is faster
# the input sizes the host DP takes at q10/q11 (larger ones take the
# iterated cost-model parse)
HOST_DP_MIN, HOST_DP_MAX = 1 << 10, 8 << 20
ENCODERS = ("auto", "native", "device", "python")
BACKENDS = ("auto", "numpy")


def _check_routes(encoder, backend):
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {encoder!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def _sanitize_params(quality, lgwin, lgblock, large_window=False):
    quality = max(0, min(11, int(quality)))
    cap = C.LARGE_MAX_WINDOW_BITS if large_window else C.MAX_WINDOW_BITS
    lgwin = max(C.MIN_WINDOW_BITS, min(cap, int(lgwin)))
    if lgblock == 0:
        lgblock = min(_DEFAULT_MB_BITS, max(16, lgwin))
    lgblock = max(C.MIN_INPUT_BLOCK_BITS,
                  min(C.MAX_INPUT_BLOCK_BITS, int(lgblock)))
    return quality, lgwin, lgblock


def find_matches(arr, max_distance, quality, large=False, *,
                 backend="auto", device=None, dp=None):
    """Quality-dispatched match finder over the full buffer (policy
    table: enc/quality.py), the JAX package's dispatch with its device
    backend on `device` (None = "cuda", raising without it) unless
    backend="numpy":

    - beyond lgwin 24 (`large`): the host vectorized matcher (the
      device paths pack distances in 24/25 bits);
    - q10/q11 on 256 KiB or more: the device DP ("auto");
    - q10/q11 from 1 KiB to 8 MiB: the host DP (enc/optimal.py), and
      beyond 8 MiB the iterated cost-model parse;
    - 64 KiB or more: the device matcher ("auto"), else the host
      vectorized matcher;
    - below: the greedy host matcher and the static-dictionary pass.

    `dp`: the device DP's ops.optimal.DPConfig."""
    pol = policy(quality)
    if large:
        return matcher.find_matches_vectorized(
            arr, max_distance, num_candidates=pol.num_candidates,
            use_dict=pol.use_dict)
    on_card = backend == "auto"
    n = len(arr)
    if pol.optimal_parse and n >= MIN_DEVICE_INPUT and on_card:
        return find_matches_optimal(arr, max_distance, device=device, dp=dp)
    if pol.optimal_parse and HOST_DP_MIN <= n <= HOST_DP_MAX:
        return host_dp.find_matches_optimal(arr, max_distance,
                                            nc=pol.dp_candidates)
    if pol.optimal_parse and n > HOST_DP_MAX:
        return matcher.find_matches_costmodel(
            arr, max_distance, num_candidates=6, use_dict=True)
    if n >= _VECTOR_THRESHOLD and on_card:
        return find_matches_device(arr, max_distance, quality,
                                   device=device)
    if n >= _VECTOR_THRESHOLD:
        return matcher.find_matches_vectorized(
            arr, max_distance, num_candidates=pol.num_candidates,
            use_dict=pol.use_dict)
    m, lens, dists = matcher.find_matches_greedy(arr, max_distance)
    flags = np.zeros(len(m), np.int64)
    if pol.use_dict and n >= 8:
        return matcher.add_dictionary_matches(arr, m, lens, dists, flags,
                                              max_distance)
    return m, lens, dists, flags


def encode(data: bytes, quality: int = 11, lgwin: int = 22,
           lgblock: int = 0, mode: int = 0, dictionary=None,
           large_window: bool = False, base64_mode: bool = False,
           shared=None, *, encoder: str = "auto", backend: str = "auto",
           device=None, dp=None) -> bytes:
    """One-shot encode, routed by the JAX package's own conditions
    (brotli_tpu.enc.encoder.encode), with `encoder` in place of its
    BROTLI_TPU_ENCODER and `backend` in place of its BROTLI_TPU_BACKEND:

    - a raw dictionary (mode 0, no base64, lgwin <= 24, not empty): the
      native encoder with the dictionary attached ("auto", "native");
    - q10/q11 on 256 KiB or more, mode 0, no dictionary or an empty
      one, no base64, lgwin <= 24, backend "auto": the device DP on
      `device` with the native serializer (None means the card and
      raises without one); "native" takes the native encoder there and
      "python" the Python pipeline (the JAX package's default takes its
      native q10/q11 tier);
    - no dictionary and no base64 in modes 0-2: the native one-shot
      encoder ("auto", "native");
    - everything else, and every input with encoder "device" or
      "python": the Python pipeline, `find_matches` over the
      dictionary and the input, then the Python serializer.

    `dictionary`: raw LZ77 bytes, matched as a compound dictionary.
    `shared`: a parsed serialized dictionary (format/shared_dictionary)
    whose custom word lists are matched (enc/custom_dict.py); its
    prefixes come in `dictionary`. `large_window`: allow lgwin up to 30
    (non-RFC extension). `base64_mode`: detect ';base64,' payload
    regions, skip LZ there and emit them under a forced flat 6-bit
    literal code. `dp`: the device DP's ops.optimal.DPConfig (None = the
    default v3 parse), in place of the JAX package's BROTLI_TPU_DP and
    the other variables of its DP."""
    _check_routes(encoder, backend)
    quality, lgwin, lgblock = _sanitize_params(quality, lgwin, lgblock,
                                               large_window)
    raw = bytes(data)
    n = len(raw)
    native_first = encoder in ("auto", "native")
    plain = mode == 0 and not base64_mode and shared is None
    if (native_first and plain and dictionary is not None
            and len(dictionary) > 0 and n > 0
            and lgwin <= C.MAX_WINDOW_BITS):
        return native.encode_with_dict(raw, quality, lgwin,
                                       bytes(dictionary))
    D = len(dictionary) if dictionary else 0
    large = lgwin > C.MAX_WINDOW_BITS
    maxback = C.max_backward_distance(lgwin)
    card_q11 = (backend == "auto" and plain and quality >= 10
                and n >= MIN_DEVICE_INPUT and D == 0 and not large)
    if card_q11 and encoder == "auto":
        # the port's default, where the JAX package's default takes its
        # native q10/q11 tier
        return _encode_on_card(raw, maxback, quality, lgblock, lgwin,
                               device, dp)
    if (native_first and dictionary is None and shared is None
            and mode in (0, 1, 2) and not base64_mode and n > 0):
        return native.encode(raw, quality, lgwin, mode=mode)
    if card_q11 and encoder != "python":
        return _encode_on_card(raw, maxback, quality, lgblock, lgwin,
                               device, dp)
    bw = BitWriter()
    bitstream.write_stream_header(bw, lgwin)
    if n == 0:
        bitstream.write_last_empty(bw)
        return bw.getvalue()
    arr = np.frombuffer((bytes(dictionary) if D else b"") + raw,
                        dtype=np.uint8)
    with trace.stage("match-find"):
        matches = find_matches(arr, maxback, quality, large=large,
                               backend=backend, device=device, dp=dp)
    if D:
        matches = _lift_dictionary_matches(matches, D, maxback)
    if shared is not None:
        matches = _custom_word_matches(arr, D, matches, shared, maxback)
    b64_mask = None
    if base64_mode:
        from . import base64_mode as b64
        starts, lengths = b64.detect_regions(arr[D:])
        if len(starts):
            b64_mask = np.zeros(len(arr), bool)
            b64_mask[D:] = b64.region_mask(arr[D:], starts, lengths)
            matches = b64.drop_matches_in_regions(matches, b64_mask)
    # mode hint (parity: BrotliEncoderMode + ChooseContextMode): TEXT
    # forces the UTF8 context model, FONT the signed-byte model
    _write_blocks(bw, arr, D, D + n, matches, lgblock, is_last=True,
                  quality=quality, ctx_floor=D, large=large,
                  context_mode={1: 2, 2: 3}.get(mode), b64_mask=b64_mask)
    bw.align_to_byte()
    out = bw.getvalue()
    if len(out) >= n + 4:
        return _store_uncompressed(arr[D:], lgwin)
    return out


def _encode_on_card(raw, maxback, quality, lgblock, lgwin, device, dp):
    """The q10/q11 device encode of `raw`, or the uncompressed stream
    where that is not smaller."""
    arr = np.frombuffer(raw, dtype=np.uint8)
    out = _encode_q11_streamed(arr, len(raw), maxback, quality, lgblock,
                               lgwin, resolve(device), dp)
    if len(out) >= len(raw) + 4:
        return _store_uncompressed(arr, lgwin)
    return out


def _custom_word_matches(arr, D, matches, shared, maxback):
    """The custom word lists of an attached serialized dictionary
    (encoder_dict.c BROTLI_EXPERIMENTAL role), matched in the parse's
    gaps. A custom word list REPLACES dictionary 0: builtin
    static-dictionary references (flags 2..999, the legacy cutoffs, and
    2000+, the general transforms) would address the wrong word space
    at decode, so they are dropped and their spans become gaps the
    custom pass can fill.

    One repair of the JAX package's pass: only matches that start in
    the input (at D or later) go into it. The JAX package passes the
    matches the parse found inside the dictionary's prefix too, at
    negative positions, which wrap around in the pass's gap map: with a
    prefix and custom words its encoder then places words over other
    matches, and raises OverflowError on a negative insert or writes a
    stream that decodes to other bytes. Those matches are never
    serialized (`_write_blocks` starts at D), so leaving them out
    changes nothing else."""
    from .custom_dict import add_custom_matches, build_index
    idx = build_index(shared)
    if idx is None:
        return matches
    m0, l0, d0, f0 = matches
    keep = (m0 >= D) & ((f0 < 2) | ((f0 >= 1000) & (f0 < 2000)))
    m0, l0, d0, f0 = m0[keep], l0[keep], d0[keep], f0[keep]
    # work in stream coordinates for gap/dist math
    m0, l0, d0, f0 = add_custom_matches(arr[D:], (m0 - D, l0, d0, f0),
                                        idx, maxback, D)
    return m0 + D, l0, d0, f0


def _lift_dictionary_matches(matches, D, maxback):
    """Convert concat-space matches whose source lies in the dictionary
    prefix into compound-dictionary references (RFC shared-brotli):
    stream distance = min(pos, window) + (D - source_offset)."""
    m, lens, dists, flags = matches
    src = m - dists
    in_dict = (src < D) & (flags == 0)
    # source must not cross the dict/data boundary (decoder copies from
    # the dictionary buffer only): trim, drop if too short
    lens = np.where(in_dict, np.minimum(lens, D - src), lens)
    p = m - D  # stream position
    dists = np.where(in_dict,
                     np.minimum(p, maxback) + (D - src), dists)
    flags = np.where(in_dict, 1, flags)
    keep = lens >= 2
    return m[keep], lens[keep], dists[keep], flags[keep]


def _write_blocks(bw, arr, lo, hi, matches, lgblock, is_last,
                  ring=None, quality=1, ctx_floor=0, large=False,
                  context_mode=None, b64_mask=None):
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
                quality=quality, ctx_floor=ctx_floor, large=large,
                context_mode=context_mode, b64_mask=b64_mask)
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

    carried = trace.carry()

    def worker():
        try:
            with trace.adopt(carried):
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
        with trace.stage("serialize.wait"):
            q.put((lo, hi, matches))

    try:
        find_matches_optimal(arr, maxback, on_block=on_block,
                             mb_size=1 << lgblock, device=device, dp=dp)
    finally:
        with trace.stage("serialize.wait"):
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
    """Streaming encoder (brotli_tpu.enc.encoder.StreamingEncoder).

    In mode 0 (but with encoder="python") it is the native stream
    encoder, whose hash-chain state persists across chunks. Otherwise
    input is buffered and emitted on flush()/finish() by the Python
    pipeline: `find_matches` over the window's history and the buffer
    (on the card with backend "auto", as in `encode`), then the Python
    serializer for the new region only. Each flush ends with an empty
    metadata block to byte-align the stream, so every flushed prefix
    decodes on its own (parity: BROTLI_OPERATION_FLUSH,
    c/include/brotli/encode.h:100-116). As in the JAX package, modes 1
    and 2 stream with the generic context model."""

    def __init__(self, quality=11, lgwin=22, lgblock=0, mode=0,
                 large_window=False, *, encoder="auto", backend="auto",
                 device=None, dp=None):
        _check_routes(encoder, backend)
        self.params = _sanitize_params(quality, lgwin, lgblock,
                                       large_window)
        self._large = large_window
        self.mode = mode
        self._route = dict(backend=backend, device=device, dp=dp)
        self._buf = bytearray()
        self._started = False
        self._finished = False
        self._bw = BitWriter()
        self._history = bytearray()
        self._ring = None
        self._native = None
        if encoder != "python" and mode == 0:
            self._native = native.StreamEncoder(self.params[0],
                                                self.params[1])

    def _ensure_header(self):
        if not self._started:
            bitstream.write_stream_header(self._bw, self.params[1])
            self._started = True

    def process(self, chunk: bytes) -> bytes:
        if self._finished:
            raise ValueError("encoder already finished")
        if self._native is not None:
            return self._native.process(bytes(chunk))
        self._buf += chunk
        return b""

    def _emit_buffered(self, is_last: bool):
        quality, lgwin, lgblock = self.params
        self._ensure_header()
        if not self._buf:
            if is_last:
                bitstream.write_last_empty(self._bw)
            return
        data = bytes(self._history) + bytes(self._buf)
        arr = np.frombuffer(data, dtype=np.uint8)
        start = len(self._history)
        large = self._large and lgwin > C.MAX_WINDOW_BITS
        with trace.stage("match-find"):
            matches = find_matches(arr, C.max_backward_distance(lgwin),
                                   quality, large=large, **self._route)
        # clip matches to the new region (window lookback still works);
        # the split comes first, so a match straddling `start` is cut
        # there as in the JAX package
        m, lens, dists, flags = matcher.split_matches_at(
            *matches, [start, len(arr)])
        keep = m >= start
        self._ring = _write_blocks(
            self._bw, arr, start, len(arr),
            (m[keep], lens[keep], dists[keep], flags[keep]),
            lgblock, is_last, self._ring, quality=quality, large=large)
        self._history = bytearray(data[-(1 << lgwin):])
        self._buf.clear()

    def _take(self) -> bytes:
        out = self._bw.getvalue()
        self._bw = BitWriter()
        return out

    def emit_metadata(self, payload: bytes) -> bytes:
        """Flush buffered input, then write one metadata block
        (byte-aligned, opaque to decompression)."""
        if self._finished:
            raise ValueError("encoder already finished")
        if self._native is not None:
            return self._native.emit_metadata(bytes(payload))
        self._ensure_header()
        self._emit_buffered(is_last=False)
        bitstream.write_metadata_block(self._bw, payload)
        return self._take()

    def flush(self) -> bytes:
        if self._finished:
            return b""
        if self._native is not None:
            return self._native.flush()
        self._emit_buffered(is_last=False)
        # empty metadata block byte-aligns the stream (decodable prefix)
        self._bw.write(0, 1)   # ISLAST
        self._bw.write(3, 2)   # MNIBBLES code -> metadata block
        self._bw.write(0, 1)   # reserved
        self._bw.write(0, 2)   # MSKIPBYTES = 0
        self._bw.align_to_byte()
        return self._take()

    def finish(self) -> bytes:
        if self._finished:
            return b""
        if self._native is not None:
            self._finished = True
            return self._native.finish()
        self._ensure_header()
        self._emit_buffered(is_last=True)
        self._finished = True
        self._bw.align_to_byte()
        return self._take()
