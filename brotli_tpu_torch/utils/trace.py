"""The port's tracing: spans and counters of the host's stages, off by
default; `enable()` turns it on.

With tracing on, every `with stage(name)` records one span: its name,
its start and end in `time.time_ns()`, the thread's native id, the id
of the request it works for and the index (in `spans()`) of its parent,
the innermost span open on its thread or, for a thread's outermost
spans, the span that `adopt` gave it. Spans go into a buffer of
CAPACITY; `dropped()` counts those that did not fit. `report()` sums
every span as {name: (calls, seconds)}, dropped ones too.
`count(name, n)` adds to a counter (`counters()`). `request(route,
nbytes)` opens the span "request" of one call into the port, with an id
and the route, bytes in and (`done`) bytes out; a call nested in an open
request reuses its span. A thread started for a request takes it up
with `adopt(carry())`. `reset()` clears spans, counters and sums.

`time.time_ns()` is the clock torch.profiler stamps its host events
with and converts the card's times to, so spans from every thread line
up with a device trace without the profiler seeing them. With tracing
off, `stage`, `count` and `request` test one flag and allocate nothing.

`device_profile(path)` runs a block under torch.profiler (the card's
kernels too where CUDA is present) with tracing on, and writes the
profiler's events and the block's spans of every thread to `path` as
one Chrome trace.
"""

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

CAPACITY = 1 << 16  # spans kept between resets


class Span(NamedTuple):
    """One recorded span; `end_ns` is None while it is open, `request`
    None outside a request, `parent` None at the top, `args` a request's
    {"route", "bytes_in", "bytes_out"} and None for a stage."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    thread: int
    request: Optional[int]
    parent: Optional[int]
    args: Optional[dict]


_enabled = False
_lock = threading.Lock()
_acc = {}
_counters = {}
_buf = []       # _Rec of every span kept, in the order they opened
_dropped = 0
_gen = 0        # reset() bumps it: older open spans are parents of none
_ids = itertools.count(1)
_tls = threading.local()  # open: [_Rec]; request, request_span, adopted


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    global _dropped, _gen
    with _lock:
        _acc.clear()
        _counters.clear()
        _buf.clear()
        _dropped = 0
        _gen += 1


class _Off:
    """What `stage`, `request` and `adopt` return with tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def done(self, nbytes):
        pass


_OFF = _Off()


def _open_spans() -> list:
    try:
        return _tls.open
    except AttributeError:
        _tls.open = []
        return _tls.open


class _Rec:
    """A span as it is recorded: a context manager that stamps it."""
    __slots__ = ("name", "start", "end", "thread", "request", "parent",
                 "args", "index", "gen")

    def __init__(self, name, args=None):
        self.name, self.args, self.end, self.index = name, args, None, None

    def __enter__(self):
        global _dropped
        st = _open_spans()
        up = st[-1] if st else getattr(_tls, "adopted", None)
        self.thread = threading.get_native_id()
        self.request = getattr(_tls, "request", None)
        self.start = time.time_ns()
        with _lock:
            self.gen = _gen
            self.parent = (up.index if up is not None and up.gen == _gen
                           else None)
            if len(_buf) < CAPACITY:
                self.index = len(_buf)
                _buf.append(self)
            else:
                _dropped += 1
        st.append(self)
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _open_spans().pop()
        dt = (self.end - self.start) / 1e9
        with _lock:
            calls, total = _acc.get(self.name, (0, 0.0))
            _acc[self.name] = (calls + 1, total + dt)


def stage(name: str):
    """Context manager: the span `name` over its block."""
    if not _enabled:
        return _OFF
    return _Rec(name)


class _Request:
    __slots__ = ("route", "nbytes", "rec")

    def __init__(self, route, nbytes):
        self.route, self.nbytes, self.rec = route, nbytes, None

    def __enter__(self):
        if getattr(_tls, "request_span", None) is None:
            self.rec = _Rec("request", {"route": self.route,
                                        "bytes_in": self.nbytes,
                                        "bytes_out": None})
            _tls.request = next(_ids)
            _tls.request_span = self.rec
            self.rec.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.__exit__(*exc)
            _tls.request = _tls.request_span = None

    def done(self, nbytes: int) -> None:
        """The request's bytes out (a nested call's are not recorded)."""
        if self.rec is not None:
            self.rec.args["bytes_out"] = nbytes


def request(route: str, nbytes: int):
    """Context manager for one call into the port on `route` with
    `nbytes` in; what it yields takes the bytes out with `done(n)`."""
    if not _enabled:
        return _OFF
    return _Request(route, nbytes)


def carry():
    """The calling thread's request and its span (or, outside a
    request, its innermost open span), for a thread it starts to take
    up with `adopt`; None with tracing off."""
    if not _enabled:
        return None
    st = _open_spans()
    span = getattr(_tls, "request_span", None)
    parent = span or (st[-1] if st else getattr(_tls, "adopted", None))
    return getattr(_tls, "request", None), span, parent


class _Adopt:
    __slots__ = ("carried", "saved")

    def __init__(self, carried):
        self.carried = carried

    def __enter__(self):
        self.saved = tuple(getattr(_tls, k, None) for k in
                           ("request", "request_span", "adopted"))
        _tls.request, _tls.request_span, _tls.adopted = self.carried
        return self

    def __exit__(self, *exc):
        _tls.request, _tls.request_span, _tls.adopted = self.saved


def adopt(carried):
    """Context manager: the calling thread works for the request that
    `carried` (from `carry`) names; its outermost spans take that
    request's span as parent."""
    if carried is None:
        return _OFF
    return _Adopt(carried)


def count(name: str, n: int = 1) -> None:
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def report() -> dict:
    with _lock:
        return dict(_acc)


def spans() -> list:
    """Every span kept since the last reset, as Span, in the order they
    opened (a span's `parent` indexes this list)."""
    with _lock:
        return [Span(r.name, r.start, r.end, r.thread, r.request, r.parent,
                     dict(r.args) if r.args else None) for r in _buf]


def counters() -> dict:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Spans that did not fit the buffer since the last reset."""
    return _dropped


def _write_spans(path, since_ns) -> None:
    """Add the spans that opened at or after `since_ns` and have closed
    to the Chrome trace at `path`, on its time base
    (baseTimeNanoseconds, where the file gives one), each on its
    thread's track."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for i, s in enumerate(spans()):
        if s.start_ns < since_ns or s.end_ns is None:
            continue
        doc["traceEvents"].append({
            "ph": "X", "cat": "trace", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": dict(s.args or {}, index=i, parent=s.parent,
                         request=s.request)})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def device_profile(path=None):
    """torch.profiler trace around a block, CPU activity and, where a
    card is present, CUDA activity, with tracing on; written to `path`
    as a Chrome trace (chrome://tracing, Perfetto) with the block's
    spans of every thread when the block ends, unless `path` is None.
    Yields the profiler, whose events() and key_averages() summarize
    the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    was = _enabled
    enable(True)
    since = time.time_ns()
    try:
        with profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable(was)
    if path is not None:
        prof.export_chrome_trace(str(path))
        _write_spans(str(path), since)
