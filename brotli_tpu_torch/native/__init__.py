"""Native host runtime (C): the one-shot and streaming encoders and
decoders behind the public API, and what the port's device pipelines
call (the seed parse, the static-dictionary probe and post-pass, the
region serializer, package-merge code lengths, the device decoder's
symbol parse). Copy of the ctypes bindings of brotli_tpu.native over
verbatim copies of its C sources, plus the port's own cap-hit extension
(btpu_extend.c).

The library is compiled with the system compiler into `_build/` at
first use; it is never committed.
"""

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

from ..dec.errors import NAMES
from ..format.dictionary import dictionary_data
from ..utils import filelock

_DIR = pathlib.Path(__file__).resolve().parent
_LIB = _DIR / "_build" / "libbtpu.so"
_SRCS = (_DIR / "btpu_dec.c", _DIR / "btpu_enc.c",
         _DIR / "btpu_extend.c")

_lib = None
_lock = threading.Lock()


def build() -> bool:
    """Compile the library unless it is newer than its sources; returns
    whether it compiled. The check and the compile hold a lock on a file
    in `_build/` that other processes take too, and the compiler writes
    a temporary file that replaces the library in one step, so a process
    never loads a library that another is still writing."""
    (_DIR / "_build").mkdir(exist_ok=True)
    with filelock.locked(_DIR / "_build" / "build.lock"):
        newest = max(s.stat().st_mtime
                     for s in _SRCS + (_DIR / "btpu_tables.h",))
        if _LIB.exists() and _LIB.stat().st_mtime >= newest:
            return False
        tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["cc", "-O2", "-march=native", "-shared", "-fPIC", "-o",
             str(tmp)] + [str(s) for s in _SRCS] + ["-lm"],
            check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return True


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_LIB))
            lib.btpu_decode_ex.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_decode_ex.restype = ctypes.c_int
            lib.btpu_free.argtypes = [ctypes.c_void_p]
            lib.btpu_find_matches.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_find_matches.restype = ctypes.c_int
            lib.btpu_serialize.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
            lib.btpu_serialize.restype = ctypes.c_int
            lib.btpu_dict_post.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_size_t, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_dict_post.restype = ctypes.c_int
            lib.btpu_extend_capped.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_extend_capped.restype = ctypes.c_int64
            lib.btpu_dict_probe_all.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_dict_probe_all.restype = ctypes.c_int
            lib.btpu_pm_lengths.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.btpu_pm_lengths.restype = ctypes.c_int
            lib.btpu_parse_stream.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(ctypes.c_uint32)]
            lib.btpu_parse_stream.restype = ctypes.c_int
            lib.btpu_encode2.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_encode2.restype = ctypes.c_int
            lib.btpu_peak_memory.argtypes = [
                ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
            lib.btpu_peak_memory.restype = ctypes.c_size_t
            lib.btpu_enc_new.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_char_p]
            lib.btpu_enc_new.restype = ctypes.c_void_p
            lib.btpu_enc_chunk.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_enc_chunk.restype = ctypes.c_int
            lib.btpu_enc_attach.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
            lib.btpu_enc_attach.restype = ctypes.c_int
            lib.btpu_enc_metadata.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_enc_metadata.restype = ctypes.c_int
            lib.btpu_enc_free_stream.argtypes = [ctypes.c_void_p]
            lib.btpu_enc_free_stream.restype = None
            lib.btpu_dec_new.argtypes = []
            lib.btpu_dec_new.restype = ctypes.c_void_p
            lib.btpu_dec_chunk.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.btpu_dec_chunk.restype = ctypes.c_int
            lib.btpu_dec_allow_trailing.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
            lib.btpu_dec_allow_trailing.restype = None
            lib.btpu_dec_set_output_limit.argtypes = [ctypes.c_void_p,
                                                      ctypes.c_size_t]
            lib.btpu_dec_set_output_limit.restype = None
            for fn, res in (("btpu_dec_consumed", ctypes.c_size_t),
                            ("btpu_dec_finished", ctypes.c_int),
                            ("btpu_dec_retained", ctypes.c_size_t),
                            ("btpu_dec_free", None)):
                getattr(lib, fn).argtypes = [ctypes.c_void_p]
                getattr(lib, fn).restype = res
            _lib = lib
    return _lib


class DecodeError(ValueError):
    """Native decode failure; `code` is the reference's
    BrotliDecoderErrorCode value (see dec/errors.py)."""

    def __init__(self, code: int):
        self.code = code
        super().__init__(
            f"decode error {NAMES.get(code, code)} ({code})")


_ENC_ERRORS = {
    -3: "out of memory",
    -6: "unsupported parameters for the native encoder",
}


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _take(lib, out_ptr, out_len) -> bytes:
    """The bytes of a buffer the library allocated, which it frees."""
    if not out_ptr.value:
        return b""
    try:
        return ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.btpu_free(out_ptr)


def decode(data: bytes, compound: bytes = b"",
           large_window: bool = False) -> bytes:
    """Native whole-buffer decode; raises DecodeError on invalid
    streams. `compound`: attached raw (compound) dictionary bytes.
    `large_window`: accept the non-RFC large-window extension."""
    lib = get_lib()
    out_ptr = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.btpu_decode_ex(data, len(data), dictionary_data(),
                            compound or None, len(compound),
                            1 if large_window else 0,
                            ctypes.byref(out_ptr), ctypes.byref(out_len))
    if rc != 0:
        raise DecodeError(rc)
    return _take(lib, out_ptr, out_len)


def encode(data: bytes, quality: int, lgwin: int,
           mode: int = 0) -> bytes:
    """Native one-shot encode (quality 0-11, lgwin 10-30 with the
    large-window extension; q10/11 run the native optimal-parse tier).
    `mode`: BrotliEncoderMode hint (1 TEXT forces the UTF8 context
    model, 2 FONT the signed-byte model)."""
    lib = get_lib()
    out_ptr = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.btpu_encode2(data, len(data), quality, lgwin, mode,
                          dictionary_data(), ctypes.byref(out_ptr),
                          ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(_ENC_ERRORS.get(rc, f"encode error {rc}"))
    return _take(lib, out_ptr, out_len)


def encode_with_dict(data: bytes, quality: int, lgwin: int,
                     dictionary: bytes) -> bytes:
    """One-shot native encode with an attached raw compound dictionary
    (BrotliEncoderAttachPreparedDictionary role)."""
    enc = StreamEncoder(quality, lgwin, dictionary=dictionary)
    return enc._chunk(bytes(data), 2)


def peak_memory(input_size: int, quality: int, lgwin: int) -> int:
    """Bound on the native encoder's transient heap for a one-shot
    encode of `input_size` bytes (btpu_peak_memory)."""
    return int(get_lib().btpu_peak_memory(int(input_size), int(quality),
                                          int(lgwin)))


class StreamEncoder:
    """Native streaming encoder: hash-chain state persists across
    chunks (BrotliEncoderCompressStream PROCESS/FLUSH/FINISH role)."""

    def __init__(self, quality: int, lgwin: int,
                 dictionary: bytes = None):
        self._lib = get_lib()
        self._st = self._lib.btpu_enc_new(quality, lgwin,
                                          dictionary_data())
        if not self._st:
            raise ValueError("unsupported native stream parameters")
        if dictionary:
            # a raw (compound) dictionary preloaded as history: emitted
            # distances land in the compound address space
            d = bytes(dictionary)
            rc = self._lib.btpu_enc_attach(self._st, d, len(d))
            if rc != 0:
                raise ValueError(
                    _ENC_ERRORS.get(rc, f"attach error {rc}"))

    def _chunk(self, data: bytes, op: int) -> bytes:
        out_ptr = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._lib.btpu_enc_chunk(self._st, data, len(data), op,
                                      ctypes.byref(out_ptr),
                                      ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(_ENC_ERRORS.get(rc, f"encode error {rc}"))
        return _take(self._lib, out_ptr, out_len)

    def process(self, data: bytes) -> bytes:
        return self._chunk(bytes(data), 0)

    def flush(self) -> bytes:
        return self._chunk(b"", 1)

    def emit_metadata(self, payload: bytes) -> bytes:
        out_ptr = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._lib.btpu_enc_metadata(self._st, payload, len(payload),
                                         ctypes.byref(out_ptr),
                                         ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(_ENC_ERRORS.get(rc, f"encode error {rc}"))
        return _take(self._lib, out_ptr, out_len)

    def finish(self) -> bytes:
        return self._chunk(b"", 2)

    def __del__(self):
        st = getattr(self, "_st", None)
        if st:
            self._lib.btpu_enc_free_stream(st)
            self._st = None


class StreamDecoder:
    """Native chunked decoder: resumes inside a metablock at command /
    literal-run granularity (BrotliDecoderDecompressStream role), so the
    consumed prefix of the input is dropped and memory stays bounded by
    the window and the chunk. Accumulates input; each feed() returns
    the newly decoded bytes."""

    def __init__(self, compound: bytes = b"", large_window: bool = False,
                 allow_trailing: bool = False):
        self._lib = get_lib()
        self._st = self._lib.btpu_dec_new()
        if not self._st:
            raise MemoryError("decoder state")
        if allow_trailing:
            # bytes after the stream's end belong to the next
            # concatenated stream (`consumed` marks the boundary)
            self._lib.btpu_dec_allow_trailing(self._st, 1)
        self._dict = dictionary_data()
        self._compound = bytes(compound or b"")
        self._large = 1 if large_window else 0
        self._buf = bytearray()
        self._base = 0  # absolute offset of _buf[0]
        self.finished = False
        # suspended at the output limit: feed(b"") resumes
        self.pending_output = False

    def set_output_limit(self, limit: int) -> None:
        """Cap the new output bytes of each feed() (0 = unlimited); at
        the cap decoding suspends, so a small chunk that expands
        enormously is never expanded eagerly."""
        if self._st is None:
            raise ValueError("decoder closed")
        self._lib.btpu_dec_set_output_limit(self._st, int(limit))

    def feed(self, data: bytes, final: bool = False) -> bytes:
        if self._st is None:
            raise ValueError("decoder closed")
        self._buf += data
        inp = bytes(self._buf)
        out_ptr = ctypes.c_void_p()
        out_len = ctypes.c_size_t()
        rc = self._lib.btpu_dec_chunk(
            self._st, inp, len(inp), self._base, self._dict,
            self._compound or None, len(self._compound), self._large,
            1 if final else 0, ctypes.byref(out_ptr),
            ctypes.byref(out_len))
        if rc < 0:
            raise DecodeError(rc)
        self.pending_output = (rc == 2)
        out = (ctypes.string_at(out_ptr, out_len.value)
               if out_ptr.value and out_len.value else b"")
        consumed = self._lib.btpu_dec_consumed(self._st)
        if consumed > self._base:
            del self._buf[: consumed - self._base]
            self._base = consumed
        if rc == 0 and self._lib.btpu_dec_finished(self._st):
            self.finished = True
        return out

    @property
    def retained_output(self) -> int:
        """Bytes held in the native output buffer (the window, and
        slices not yet delivered under back-pressure)."""
        if self._st is None:
            raise ValueError("decoder closed")
        return int(self._lib.btpu_dec_retained(self._st))

    @property
    def consumed(self) -> int:
        """Absolute input bytes consumed so far; once `finished`, the
        exact end of the stream (the concatenation point)."""
        if self._st is None:
            raise ValueError("decoder closed")
        return int(self._lib.btpu_dec_consumed(self._st))

    def __del__(self):
        st = getattr(self, "_st", None)
        if st:
            self._lib.btpu_dec_free(st)
            self._st = None


def parse_stream(data: bytes, large_window: bool = False):
    """Native deferred symbol parse (the device decoder's front end;
    btpu_dec.c btpu_parse_stream): decodes the bit-serial symbol stream
    and returns the copy graph for the device LZ resolve
    (ops/lz_resolve.py).

    Returns (lits, nlit_runs, copy_lens, dists, max_depth): the literal
    byte stream, per-command uint32 arrays, and the copy-chain depth
    bound. Raises DecodeError on a stream it does not take (invalid, or
    with a compound dictionary)."""
    lib = get_lib()
    lits_p = ctypes.c_void_p()
    nlit = ctypes.c_size_t()
    cn_p = ctypes.c_void_p()
    cc_p = ctypes.c_void_p()
    cd_p = ctypes.c_void_p()
    ncmd = ctypes.c_size_t()
    max_depth = ctypes.c_uint32()
    rc = lib.btpu_parse_stream(data, len(data), dictionary_data(),
                               1 if large_window else 0,
                               ctypes.byref(lits_p), ctypes.byref(nlit),
                               ctypes.byref(cn_p), ctypes.byref(cc_p),
                               ctypes.byref(cd_p), ctypes.byref(ncmd),
                               ctypes.byref(max_depth))
    if rc != 0:
        raise DecodeError(rc)
    try:
        lits = ctypes.string_at(lits_p, nlit.value)
        k = ncmd.value
        cmds = [np.ctypeslib.as_array(
            ctypes.cast(p, ctypes.POINTER(ctypes.c_uint32)), (k,)).copy()
            if k else np.zeros(0, np.uint32) for p in (cn_p, cc_p, cd_p)]
    finally:
        for p in (lits_p, cn_p, cc_p, cd_p):
            if p.value:
                lib.btpu_free(p)
    return (lits, *cmds, max_depth.value)


def find_matches(data: bytes, quality: int, lgwin: int):
    """Native greedy/lazy match finder (no emission, no dictionary):
    (pos, len, dist) uint32 arrays in position order -- the DP's seed
    parse."""
    lib = get_lib()
    n = len(data)
    cap = n // 4 + 16
    pos = np.empty(cap, np.uint32)
    lens = np.empty(cap, np.uint32)
    dist = np.empty(cap, np.uint32)
    cnt = ctypes.c_size_t()
    rc = lib.btpu_find_matches(data, n, quality, lgwin, _ptr(pos),
                               _ptr(lens), _ptr(dist), cap,
                               ctypes.byref(cnt))
    if rc != 0:
        raise ValueError(_ENC_ERRORS.get(rc, f"match-find error {rc}"))
    k = cnt.value
    return pos[:k], lens[:k], dist[:k]


def dict_post(data: bytes, mpos, mlen, max_distance: int,
              base: int = 0, active_from: int = 0):
    """Static-dictionary post-pass over parse gaps: the NEW word
    references as (pos, out_advance, dist, flag) int64 arrays
    (flag = 2000 + word length)."""
    lib = get_lib()
    mp = np.ascontiguousarray(mpos, np.uint32)
    ml = np.ascontiguousarray(mlen, np.uint32)
    cap = max(len(data) // 8 + 64, 1024)
    op = np.empty(cap, np.uint32)
    ol = np.empty(cap, np.uint32)
    od = np.empty(cap, np.uint32)
    of = np.empty(cap, np.uint32)
    cnt = ctypes.c_size_t()
    rc = lib.btpu_dict_post(
        data, len(data), base, active_from, max_distance,
        dictionary_data(), _ptr(mp), _ptr(ml), len(mp), _ptr(op),
        _ptr(ol), _ptr(od), _ptr(of), cap, ctypes.byref(cnt))
    if rc != 0:
        raise ValueError(_ENC_ERRORS.get(rc, f"dict_post error {rc}"))
    k = cnt.value
    return (op[:k].astype(np.int64), ol[:k].astype(np.int64),
            od[:k].astype(np.int64), of[:k].astype(np.int64))


def extend_capped(data, m, lens, dists, flags, cap: int, max_match: int):
    """Cap-hit extension in one native pass (btpu_extend.c): matches
    with lens >= cap and flags == 0 extended as far as the input
    repeats, up to max_match, and the later matches they swallow
    dropped. `data`: uint8 bytes, passed without a copy when contiguous.
    Returns the (pos, len, dist, flag) int64 arrays and how many cap
    hits were extended. Raises ValueError for arrays of unequal length
    or a cap hit whose source lies outside `data`."""
    buf = np.ascontiguousarray(data, np.uint8)
    ins = [np.ascontiguousarray(a, np.int64) for a in (m, lens, dists, flags)]
    nm = len(ins[0])
    if any(len(a) != nm for a in ins):
        raise ValueError("extend_capped: match arrays of unequal length")
    outs = [np.empty(nm, np.int64) for _ in range(4)]
    cnt = ctypes.c_size_t()
    extended = get_lib().btpu_extend_capped(
        _ptr(buf), len(buf), *map(_ptr, ins), nm, cap, max_match,
        *map(_ptr, outs), ctypes.byref(cnt))
    if extended < 0:
        raise ValueError("extend_capped: a cap hit's source lies outside "
                         "the data")
    k = cnt.value
    return (*(o[:k] for o in outs), extended)


def dict_probe_all(data: bytes, mpos, mlen, base: int = 0,
                   maxback: int = (1 << 22) - 16):
    """Static-dictionary probe wherever the seed parse is weak (dict
    edges for the DP). Returns (pos u32, payload u32) sparse arrays;
    payload = out_advance << 22 | word_len << 17 | dictoff."""
    lib = get_lib()
    mp = np.ascontiguousarray(mpos, np.uint32)
    ml = np.ascontiguousarray(mlen, np.uint32)
    cap = max(len(data) // 8 + 64, 1024)
    op = np.empty(cap, np.uint32)
    pl = np.empty(cap, np.uint32)
    cnt = ctypes.c_size_t()
    rc = lib.btpu_dict_probe_all(
        data, len(data), base, maxback, dictionary_data(), _ptr(mp),
        _ptr(ml), len(mp), _ptr(op), _ptr(pl), cap, ctypes.byref(cnt))
    if rc != 0:
        raise ValueError(_ENC_ERRORS.get(rc, f"probe error {rc}"))
    k = cnt.value
    return op[:k].copy(), pl[:k].copy()


def serialize_region(data: bytes, lo: int, hi: int, matches,
                     quality: int, lgwin: int, ring=None,
                     write_header: bool = False, is_last: bool = False,
                     align_end: bool = True):
    """Native serialization of a parsed region from (pos, len, dist,
    flag) match arrays (BrotliStoreMetaBlock role). Returns (bytes,
    exit_ring). Raises ValueError for unsupported flags."""
    lib = get_lib()
    m, lens, dists, flags = (np.ascontiguousarray(a, np.uint32)
                             for a in matches)
    ring_in = None
    if ring is not None:
        ring_in = np.ascontiguousarray(ring, np.uint32)
    ring_out = np.zeros(4, np.uint32)
    out_ptr = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.btpu_serialize(
        data, len(data), lo, hi, quality, lgwin, _ptr(m), _ptr(lens),
        _ptr(dists), _ptr(flags), len(m),
        _ptr(ring_in) if ring_in is not None else None,
        1 if write_header else 0, 1 if is_last else 0,
        1 if align_end else 0,
        ctypes.byref(out_ptr), ctypes.byref(out_len), _ptr(ring_out))
    if rc != 0:
        raise ValueError(_ENC_ERRORS.get(rc, f"serialize error {rc}"))
    try:
        return (ctypes.string_at(out_ptr, out_len.value),
                ring_out.astype(np.int64))
    finally:
        lib.btpu_free(out_ptr)
