"""Suspend-anywhere streaming decode with bounded memory.

Role parity: BrotliDecoderDecompressStream (c/dec/decode.c:2447) +
the save/restore bit reader (c/dec/bit_reader.h:73). The reference
suspends its 27-state machine at any bit; here the SAME effect comes
from running the whole-stream decoder on a worker thread against a
blocking bit reader: when input runs dry mid-symbol the decoder thread
parks inside `take()/peek()` -- the suspension point is any bit --
and `feed()` wakes it with more bytes. Consumed input and emitted
output both trim to the LZ window, so a 16 MB metablock no longer
requires 16 MB of buffered input (the round-1 limitation). A copy of
brotli_tpu.dec.stream, with one repair: symbols are read through
`_BlockingBitReader.read_symbol`, which waits only for the bits a
symbol takes, so a stream ends without its feed being closed (the JAX
package's copy waits for the longest code's bits after the last
symbol, and a Decompressor over it never reports finished for about a
third of streams).
"""

import threading

import numpy as np

from ..format.bitio import NeedMoreInput
from .decoder import Decoder, FormatError


class _BlockingBitReader:
    """LSB-first bit reader over a growing buffer; short reads BLOCK
    until more input arrives or the feed is closed (then they raise
    NeedMoreInput, the truncation error)."""

    def __init__(self):
        self._buf = bytearray()
        self._base_bits = 0      # absolute bit position of _buf[0]
        self.bitpos = 0          # absolute
        self._closed = False
        self._cond = threading.Condition()
        self.waiting = False     # decoder parked, needs input
        self.push_seq = 0        # bumped per push
        self.seen_seq = 0        # last push the decoder examined

    # -- producer side ----------------------------------------------------
    def push(self, data: bytes, closed: bool) -> int:
        with self._cond:
            self._buf += data
            self._closed |= closed
            self.push_seq += 1
            self._cond.notify_all()
            return self.push_seq

    # -- consumer (decoder thread) side -----------------------------------
    def _ensure(self, nbits: int) -> bool:
        """Block until nbits are readable; False if the feed closed
        short."""
        with self._cond:
            while True:
                if self.bitpos + nbits <= self._base_bits + \
                        8 * len(self._buf):
                    return True
                if self._closed:
                    return False
                # the decoder has examined everything pushed so far
                # and still cannot proceed: park (any-bit suspension)
                self.seen_seq = self.push_seq
                self.waiting = True
                self._cond.notify_all()
                self._cond.wait()
                self.waiting = False

    def available(self) -> int:
        with self._cond:
            return self._base_bits + 8 * len(self._buf) - self.bitpos

    def peek(self, n: int) -> int:
        self._ensure(n)  # zero-pad only at true EOF (closed feed)
        return self.peek_held(n)

    def read_symbol(self, table) -> int:
        """One symbol of a prefix code, waiting only for the bits it
        takes (the role of c/dec/decode.c's SafeReadSymbol): the bits
        held so far, zero-padded, decide it when its code is no longer
        than they are, as a prefix code's first bits do; else park for
        more input. So the stream's last symbol decodes before the feed
        is closed, however much shorter than the table's longest code
        it is."""
        n = table.max_len
        while True:
            with self._cond:
                held = min(self._base_bits + 8 * len(self._buf)
                           - self.bitpos, n)
            sym, used = table.decode(self.peek_held(n))
            if used <= held or not self._ensure(held + 1):
                break
        self.skip(used)
        return sym

    def peek_held(self, n: int) -> int:
        """Up to n bits from what is held, zero-padded; never waits."""
        rel = self.bitpos - self._base_bits
        byte0 = rel >> 3
        shift = rel & 7
        end = min(byte0 + ((n + shift + 7) >> 3), len(self._buf))
        window = int.from_bytes(bytes(self._buf[byte0:end]), "little")
        return (window >> shift) & ((1 << n) - 1)

    def take(self, n: int) -> int:
        if not self._ensure(n):
            raise NeedMoreInput()
        v = self.peek(n)
        self.bitpos += n
        return v

    def skip(self, n: int) -> None:
        if not self._ensure(n):
            raise NeedMoreInput()
        self.bitpos += n

    def align_to_byte(self) -> int:
        pad = (-self.bitpos) & 7
        return self.take(pad) if pad else 0

    def read_bytes(self, n: int) -> bytes:
        assert self.bitpos & 7 == 0
        if not self._ensure(8 * n):
            raise NeedMoreInput()
        rel = (self.bitpos - self._base_bits) >> 3
        self.bitpos += 8 * n
        return bytes(self._buf[rel:rel + n])

    def trim(self) -> None:
        """Drop consumed input bytes (keeps the reader O(chunk))."""
        with self._cond:
            rel = (self.bitpos - self._base_bits) >> 3
            if rel > (1 << 16):
                del self._buf[:rel]
                self._base_bits += 8 * rel

    @property
    def data(self):  # decompress() peeks len(br.data) in a few spots
        return np.frombuffer(bytes(self._buf), dtype=np.uint8)


class _WindowBuffer:
    """bytearray lookalike with absolute indexing and window trimming:
    supports len / bool / negative index / absolute slice / append /
    += -- everything the decode loop touches.

    Output back-pressure (the reference python binding's
    ``output_buffer_limit``, python/_brotli.c:712-860): when `limit`
    is set, the DECODER THREAD parks inside append/+= once undrained
    output reaches the limit, and resumes when the consumer drains
    (take_new) or the limit lifts. Granularity is one emitted chunk
    (<= 64 KB slices for big copies), so retained memory stays
    O(limit + window + chunk) even on a decompression bomb."""

    __slots__ = ("_buf", "_base", "window", "drained", "cond", "limit",
                 "out_waiting", "closing")

    def __init__(self, window: int, cond=None):
        self._buf = bytearray()
        self._base = 0
        self.window = window
        self.drained = 0  # bytes handed to the consumer
        self.cond = cond or threading.Condition()
        self.limit = None        # undrained-output budget (None = off)
        self.out_waiting = False  # decoder parked on a full budget
        self.closing = False     # finish/close: never park again

    def __len__(self):
        return self._base + len(self._buf)

    def __bool__(self):
        return len(self) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            start = i.start - self._base if i.start is not None else 0
            stop = i.stop - self._base if i.stop is not None else None
            return self._buf[start:stop]
        if i < 0:
            return self._buf[i]
        return self._buf[i - self._base]

    def _gate(self, extra: int) -> None:
        """Decoder-thread side: park until `extra` more bytes fit the
        undrained budget. A chunk LARGER than the budget must still
        pass once the buffer is fully drained (otherwise the wait
        condition can never clear and the consumer's drain loop spins
        forever) -- the documented overshoot is one chunk. This also
        guarantees out_waiting implies undrained > 0, which feed()
        relies on to return progress."""
        lim = self.limit
        if lim is None or self.closing:
            return
        if extra > lim:
            lim = extra
        if self._base + len(self._buf) + extra - self.drained <= lim:
            return
        with self.cond:
            while True:
                lim = self.limit
                if lim is None or self.closing:
                    break
                if extra > lim:
                    lim = extra
                if (self._base + len(self._buf) + extra - self.drained
                        <= lim):
                    break
                self.out_waiting = True
                self.cond.notify_all()
                self.cond.wait()
            self.out_waiting = False

    def append(self, b):
        self._gate(1)
        self._buf.append(b)

    def __iadd__(self, other):
        n = len(other)
        if self.limit is not None and n > (1 << 16):
            mv = memoryview(bytes(other))
            for off in range(0, n, 1 << 16):
                ch = mv[off:off + (1 << 16)]
                self._gate(len(ch))
                self._buf += ch
        else:
            self._gate(n)
            self._buf += other
        return self

    def take_new(self, cap=None) -> bytes:
        """Consumer side: runs only while the decoder thread is parked
        (feed/finish wait for a park first)."""
        avail = self._buf[self.drained - self._base:]
        out = bytes(avail[:cap]) if cap is not None else bytes(avail)
        self.drained += len(out)
        self._trim()
        with self.cond:
            self.cond.notify_all()  # budget freed: wake the decoder
        return out

    def _trim(self):
        keep_from = min(len(self) - self.window, self.drained)
        drop = keep_from - self._base
        if drop > (1 << 16):
            del self._buf[:drop]
            self._base += drop


class StreamDecoder:
    """Push-style decoder that suspends at ANY bit with window-bounded
    memory. feed(chunk) returns the newly decoded bytes; finish()
    validates stream termination and returns the tail."""

    def __init__(self, large_window: bool = False, dictionary=None,
                 shared=None):
        self._dec = Decoder(large_window=large_window,
                            dictionary=dictionary, shared=shared)
        self._br = _BlockingBitReader()
        self._out = None
        self._output_limit = None
        self._error = None
        self.finished = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False

    def set_output_limit(self, limit) -> None:
        """Undrained-output budget (true back-pressure; see
        _WindowBuffer). None or 0 disables."""
        self._output_limit = limit or None
        if self._out is not None:
            with self._out.cond:
                self._out.limit = self._output_limit
                self._out.cond.notify_all()

    @property
    def pending_output(self) -> bool:
        """Undelivered decoded bytes exist (drain with feed(b""))."""
        out = self._out
        return out is not None and (len(out) > out.drained or
                                    out.out_waiting)

    @property
    def metadata_callback(self):
        return self._dec.metadata_callback

    @metadata_callback.setter
    def metadata_callback(self, cb):
        self._dec.metadata_callback = cb

    def _run(self):
        br = self._br
        try:
            state = self._dec._read_stream_header(br)
            self._out = _WindowBuffer(state["max_backward"] + 16,
                                      cond=br._cond)
            self._out.limit = self._output_limit
            done = False
            while not done:
                done = self._dec._one_metablock(br, self._out, state)
                br.trim()
            pad = br.align_to_byte()
            if pad != 0:
                raise FormatError("non-zero stream padding", -14)
        except BaseException as e:  # surfaced on the feeding thread
            self._error = e
        finally:
            with br._cond:
                self.finished = True
                br.waiting = False
                if self._out is not None:
                    self._out.out_waiting = False
                br._cond.notify_all()

    def _wait_parked(self, seq):
        """Block until the decoder parked AFTER examining push `seq`
        (a stale park from before the push does not count), parked on
        a full output budget WITH undrained bytes, or terminated.

        The undrained check matters: out_waiting stays set from the
        moment the worker decides to park until it is rescheduled
        after a drain, so trusting the flag alone made every
        process(b"") in a drain loop return empty immediately --
        measured 151k hot empty rounds draining a 2 MB stream."""
        with self._br._cond:
            while not (self.finished or
                       (self._br.waiting and
                        self._br.seen_seq >= seq) or
                       (self._out is not None and
                        self._out.out_waiting and
                        len(self._out) > self._out.drained)):
                self._br._cond.wait()

    def feed(self, chunk: bytes) -> bytes:
        if self.finished:
            if self._error is not None:
                raise self._error
            if chunk:
                raise FormatError("data after stream end", -15)
            # the worker can finish with undrained output still in the
            # buffer (it completed _run in the same wake as its last
            # production); this early path must keep draining or the
            # consumer's is_finished()/process(b"") loop livelocks on
            # pending_output forever (seen as a 100%-CPU hang in the
            # bomb back-pressure test)
            return self._out.take_new() if self._out is not None \
                else b""
        if not self._started:
            # lazily create the output before the thread can race it
            self._started = True
            self._thread.start()
        seq = self._br.push(bytes(chunk), closed=False)
        self._wait_parked(seq)
        if self._error is not None:
            self.finished = True
            raise self._error
        return self._out.take_new() if self._out is not None else b""

    def _release_gate(self) -> None:
        """Lift the output budget so the worker can run to completion
        (finish/close deliver everything; the budget protects only the
        incremental process() path)."""
        self._output_limit = None  # a not-yet-created buffer: no gate
        out = self._out
        if out is not None:
            with out.cond:
                out.closing = True
                out.cond.notify_all()

    def finish(self) -> bytes:
        if not self._started:
            self._started = True
            self._thread.start()
        self._release_gate()
        self._br.push(b"", closed=True)
        self._thread.join()
        self.finished = True
        if self._error is not None:
            raise self._error
        return self._out.take_new() if self._out is not None else b""

    def close(self) -> None:
        """Release the worker thread without validating termination
        (abandoned streams; idempotent)."""
        if self._started and not self.finished:
            self._release_gate()
            self._br.push(b"", closed=True)
            self._thread.join()
            self.finished = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
