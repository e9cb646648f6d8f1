"""The q10/q11 device encode: the optimal-parse DP streams finished
metablock spans into a native serialization worker (copy of
brotli_tpu.enc.encoder._encode_q11_streamed and _store_uncompressed).
"""

import queue
import threading

from .. import native
from ..format import constants as C
from ..format.bitio import BitWriter
from ..ops.optimal import find_matches_optimal
from ..utils import trace
from . import bitstream

_DEFAULT_MB_BITS = 22  # metablock size (lgblock); <= 24


def _sanitize_params(quality, lgwin, lgblock):
    quality = max(0, min(11, int(quality)))
    lgwin = max(C.MIN_WINDOW_BITS, min(C.MAX_WINDOW_BITS, int(lgwin)))
    if lgblock == 0:
        lgblock = min(_DEFAULT_MB_BITS, max(16, lgwin))
    lgblock = max(C.MIN_INPUT_BLOCK_BITS,
                  min(C.MAX_INPUT_BLOCK_BITS, int(lgblock)))
    return quality, lgwin, lgblock


def _encode_q11_streamed(arr, n, maxback, quality, lgblock, lgwin,
                         device=None):
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
                             mb_size=1 << lgblock, device=device)
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
