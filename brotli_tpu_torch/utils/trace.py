"""Per-stage timing seam (copy of brotli_tpu.utils.trace). Disabled by
default; `enable()` turns it on. Stages nest; every `with
stage("name")` accumulates wall time and call count. `report()`
returns {name: (calls, seconds)}. `device_profile(path)` wraps a block
in a torch.profiler trace (the card's kernels too where CUDA is
present) and writes it to `path` as a Chrome trace; the profiling tool
and the smoke's launch counts go through it.
"""

import contextlib
import threading
import time

_enabled = False
_lock = threading.Lock()
_acc = {}


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _acc.clear()


@contextlib.contextmanager
def stage(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            calls, total = _acc.get(name, (0, 0.0))
            _acc[name] = (calls + 1, total + dt)


def report() -> dict:
    with _lock:
        return dict(_acc)


def format_report() -> str:
    rows = sorted(report().items(), key=lambda kv: -kv[1][1])
    width = max((len(k) for k, _ in rows), default=4)
    lines = [f"{k.ljust(width)}  {c:6d} calls  {s * 1000:9.1f} ms"
             for k, (c, s) in rows]
    return "\n".join(lines)


@contextlib.contextmanager
def device_profile(path=None):
    """torch.profiler trace around a block, CPU activity and, where a
    card is present, CUDA activity; written to `path` as a Chrome trace
    (chrome://tracing, Perfetto) when the block ends, unless `path` is
    None. Yields the profiler, whose events() and key_averages()
    summarize the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if path is not None:
        prof.export_chrome_trace(str(path))
