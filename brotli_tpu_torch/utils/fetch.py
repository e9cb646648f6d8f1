"""Device-to-host reads that wait only on the work they read.

A segment's results are copied to the host after an event recorded
right after that segment was queued (`mark`), on a side stream that
waits on the event: the copy does not queue behind the segments
dispatched after it, so the host can work on early segments while the
card computes later ones (the per-buffer readiness the JAX package gets
from its runtime).

On the CPU there is nothing to wait for: `mark` returns None and
`fetch_after` is a plain stack.
"""

import threading

import torch

_side = {}
_lock = threading.Lock()


def mark(device):
    """An event recorded on `device`'s current stream after the work
    queued so far; None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _side_stream(device):
    key = torch.device(device).index
    if key is None:
        key = torch.cuda.current_device()
    with _lock:
        s = _side.get(key)
        if s is None:
            s = _side[key] = torch.cuda.Stream(device=key)
    return s


def fetch_after(events, tensors):
    """torch.stack(tensors) on the host, read once every event in
    `events` (as returned by `mark`; None entries are skipped) has
    completed.

    On the card the stack and the copy into pinned host memory run on a
    side stream that waits on those events alone; `record_stream` keeps
    the allocator from reusing the inputs before the copy has read
    them. Blocks until the copy is done."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return torch.stack(tensors)
    side = _side_stream(dev)
    with torch.cuda.stream(side):
        for ev in events:
            if ev is not None:
                side.wait_event(ev)
        for t in tensors:
            t.record_stream(side)
        stacked = torch.stack(tensors)
        host = torch.empty(stacked.shape, dtype=stacked.dtype,
                           pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    return host
