"""The program's own spans and counters (brotli_tpu_torch.utils.trace)
in a traced run's window, and the arithmetic of the readers that use
them.

The harness resets the program's trace when the window opens and turns
it off when the window ends, so after the window `spans()` and
`counters()` hold the window's data and nothing else. `window()` gives
None for a program whose trace records no spans, and for a window whose
spans overflowed the trace's buffer: a reader then has nothing sound to
read.
"""

from benchmark.core import device_intervals_union

REQUEST = "request"  # the span of one call into the program


def window():
    """(spans, counters) of the window, or None."""
    from brotli_tpu_torch.utils import trace
    if not hasattr(trace, "spans") or trace.dropped() > 0:
        return None
    return trace.spans(), trace.counters()


def closed(spans):
    """(name, start s, end s) of every closed span."""
    return [(s.name, s.start_ns / 1e9, s.end_ns / 1e9) for s in spans
            if s.end_ns is not None]


def stages(spans):
    """(name, start s, end s) of every closed stage span: any span but a
    request's, on any thread."""
    return [c for c in closed(spans) if c[0] != REQUEST]


def seconds(spans, name) -> float:
    """The summed seconds of every span `name`, on any thread."""
    return sum(b - a for n, a, b in closed(spans) if n == name)


def mib(window) -> float:
    """The window's input, MiB."""
    return sum(window.request_bytes) / (1 << 20)


def idle_unspanned_share(spans, device_ops):
    """Share (%) of the card's idle time, from the first request span's
    start to the last one's end, in which no stage span (any span but a
    request's) is open on any thread; None without a request span or
    idle time. `device_ops` are (name, start s, end s)."""
    reqs = [(a, b) for n, a, b in closed(spans) if n == REQUEST]
    if not reqs:
        return None
    lo, hi = min(a for a, _ in reqs), max(b for _, b in reqs)

    def clip(intervals):
        return [(max(a, lo), min(b, hi)) for a, b in intervals
                if a < hi and b > lo]

    busy = clip((a, b) for _, a, b in device_ops)
    staged = clip((a, b) for _, a, b in stages(spans))
    idle = (hi - lo) - device_intervals_union(busy)
    if idle <= 0:
        return None
    unspanned = (hi - lo) - device_intervals_union(busy + staged)
    return 100.0 * unspanned / idle
