"""Where the device time of an encode goes, on the card.

Compresses the 16 MiB corpus of tools/corpus.py once to warm up, then once
under torch.profiler, through the q11 path (api.compress, the default) or
the q5 path (parallel.shard.compress_sharded, `--path q5`), and prints:
  * the wall seconds of the profiled run (host clock, ending in a
    synchronize) and the card's busy seconds: the union of the
    intervals of every kernel and copy it ran;
  * the card's idle share, 1 - busy / wall;
  * the device kernels and copies by total time;
  * the host's CUDA runtime calls by total time, where a call that waits
    for the card (a synchronize, a copy to pageable host memory) shows.

With `--trace PATH` the profiled run is also written to PATH as a
Chrome trace (utils/trace.device_profile).

Usage, from the repository root on a machine with a card:
    python3 -m brotli_tpu_torch.tools.profile_q11 [--path q11|q5]
        [--trace PATH]
"""

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType

from .. import compress
from ..parallel.shard import compress_sharded
from ..utils.trace import device_profile
from .corpus import build_corpus

PATHS = {"q11": lambda data: compress(data, quality=11),
         "q5": lambda data: compress_sharded(data, quality=5)}

TOP = 25  # rows of each table


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _table(rows, title):
    print(title)
    for name, (calls, us) in sorted(rows.items(),
                                    key=lambda kv: -kv[1][1])[:TOP]:
        print(f"  {us / 1e3:10.1f} ms  {calls:7d} calls  {name[:90]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(PATHS), default="q11")
    ap.add_argument("--trace", default=None,
                    help="write the profiled run here as a Chrome trace")
    args = ap.parse_args(argv)
    path = args.path
    run = PATHS[path]
    if not torch.cuda.is_available():
        raise SystemExit("profile_q11: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    data = build_corpus()
    out = run(data)
    torch.cuda.synchronize()
    with device_profile(args.trace) as prof:
        t0 = time.perf_counter()
        again = run(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if again != out:
        raise SystemExit("profile_q11: two runs on the same input differ")
    dev, runtime = {}, {}
    intervals = []
    for e in prof.events():
        span = e.time_range.end - e.time_range.start
        if e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            calls, us = dev.get(e.name, (0, 0.0))
            dev[e.name] = (calls + 1, us + span)
        elif e.name.startswith("cuda"):
            calls, us = runtime.get(e.name, (0, 0.0))
            runtime[e.name] = (calls + 1, us + span)
    busy = _busy_us(intervals) / 1e6
    print(f"{path} {len(data)} B -> {len(out)} B on {card}")
    print(f"wall {wall:.3f} s, device busy {busy:.3f} s, idle share "
          f"{1 - busy / wall:.4f} ({len(intervals)} device events)")
    _table(dev, "device kernels and copies:")
    _table(runtime, "host CUDA runtime calls:")


if __name__ == "__main__":
    main()
