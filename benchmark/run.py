"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for. The cell (BENCHMARK.json's `workloads`) names a
configuration (configs/<name>.json: the entry point of brotli_tpu_torch
and its arguments) and a traffic mix (traffic/<name>.json: a generator
in gen/, its parameters and the number of clients). The run:

  1. makes the pool of documents from --seed and loads the program;
  2. warms up with one request of the first document's first
     `warmup_bytes`, which ends the set-up (on a checkout's first run the
     program builds its kernels and native library there, into its fixed
     directories brotli_tpu_torch/_build and native/_build);
  3. runs a closed loop for --seconds: each client sends its next
     document when the last one has come back; the window ends when
     the last request started inside --seconds completes;
  4. with --trace 1, runs the window under torch.profiler with the
     program's trace stages on, and reads the per-layer metrics
     (metrics/<name>.py) from them; with --trace 0, the end-to-end
     metrics;
  5. judges every stream with the plain reference (check.py), fails if
     jax, jaxlib, flax or the JAX package brotli_tpu was loaded, and
     prints one JSON line: the metrics that found nothing to read and
     any roofline kernel whose launches were not the count expected are
     listed under `warnings`, and the last key holds each number
     compared with its limit (also the last lines on standard error).

Without enough CUDA devices it exits with code 2 and prints no result.
"""

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark import check, core, faults  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "brotli_tpu")
TOP = 10  # entries of each breakdown list


def process_age() -> float:
    """Seconds since this process started (/proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def entry_point(config: dict):
    mod, name = config["entry"].split(":")
    return getattr(importlib.import_module(mod), name)


def closed_loop(fn, kwargs, docs, seconds, clients, sync):
    """Each of `clients` threads sends documents in turn (the k-th
    request takes document k mod pool) until `seconds` have passed, one
    in flight at a time. Returns ([(document, stream or None, error,
    seconds)] in request order, the window's seconds)."""
    lock = threading.Lock()
    issued = []
    records = {}
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def client():
        while True:
            with lock:
                if time.perf_counter() >= deadline:
                    return
                k = len(issued)
                issued.append(k)
            di = k % len(docs)
            t = time.perf_counter()
            try:
                out, err = fn(docs[di], **kwargs), None
                sync()
            except Exception as e:  # a failed request is judged, not fatal
                out, err = None, f"{type(e).__name__}: {e}"
            with lock:
                records[k] = (di, out, err, time.perf_counter() - t)

    if clients == 1:
        client()
    else:
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return [records[k] for k in sorted(records)], time.perf_counter() - t0


@contextlib.contextmanager
def traced(cuda: bool):
    """The program's trace stages on, each also a torch.profiler span,
    and torch.profiler over the block; yields a namespace whose `prof`
    and `stages` are set when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from brotli_tpu_torch.utils import trace as T
    got = SimpleNamespace(prof=None, stages={}, spans={"bench.window"})
    plain = T.stage

    @contextlib.contextmanager
    def spanned(name):
        got.spans.add(name)
        with record_function(name), plain(name):
            yield

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    T.reset()
    T.enable(True)
    T.stage = spanned
    try:
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                yield got
            if cuda:
                torch.cuda.synchronize()
    finally:
        T.stage = plain
        T.enable(False)
    got.prof = prof
    got.stages = T.report()


def read_trace(prof, spans):
    """(device ops [(name, start s, end s)], the program's trace stages
    [(name, start s, end s)], the window's (start s, end s)) from a
    profile's raw events (building the profiler's event tree takes tens
    of seconds on a window of torch ops); `spans` are the names of the
    harness's own profiler spans, whose copies on the device's timeline
    are no device operations."""
    from torch.autograd import DeviceType
    dev, host, win = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns() / 1e9
        b = a + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            if name not in spans and not e.is_user_annotation():
                dev.append((core.kernel_name(name), a, b))
        elif name == "bench.window":
            win = (a, b)
        elif name in spans:
            host.append((name, a, b))
    return dev, host, win


def doing(host, a, b) -> str:
    """What the host did for most of (a, b): the innermost of the `host`
    spans [(name, start, end)] at each instant, summed by name; "host"
    where none runs."""
    spans = [(e - s, n, s, e) for n, s, e in host if s < b and e > a]
    cuts = sorted({a, b} | {x for _, _, s, e in spans for x in (s, e)
                            if a < x < b})
    share = {}
    for lo, hi in zip(cuts, cuts[1:]):
        inner = [(d, n) for d, n, s, e in spans if s <= lo and e >= hi]
        name = min(inner)[1] if inner else "host"
        share[name] = share.get(name, 0.0) + hi - lo
    return max(share.items(), key=lambda kv: kv[1])[0]


def breakdown(dev, host, win) -> dict:
    """The device operations by total time, and the longest idle gaps
    of the window, each named by what the host did for most of it
    (`doing` over `host`, the program's trace stages)."""
    tot = {}
    for n, a, b in dev:
        tot[n] = tot.get(n, 0.0) + (b - a)
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
    if win is None:
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": []}
    gaps, end = [], win[0]
    for a, b in sorted((a, b) for _, a, b in dev):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if win[1] > end:
        gaps.append((end, win[1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[doing(host, a, b), b - a] for a, b in gaps]}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(cell: dict, seed: int, seconds: float, trace: bool,
        fault: str = None, device: str = None) -> dict:
    """One run of `cell`; returns the result line's object. `device`
    None runs the program on its default, the card; the tests pass
    "cpu"."""
    import torch
    cuda = device is None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config, traffic = cell["config_file"], cell["traffic_file"]
    gen = core.load_module("gen", traffic["gen"])
    docs = gen.documents(seed, **traffic["params"])
    fn = entry_point(config)
    if fault:
        fn = faults.FAULTS[fault](fn)
    kwargs = dict(config["kwargs"])
    if not cuda:
        kwargs["device"] = device
    fn(docs[0][:config["warmup_bytes"]], **kwargs)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()
    loop = (fn, kwargs, docs, seconds, traffic["clients"], sync)
    if trace:
        with traced(cuda) as tr:
            records, window_s = closed_loop(*loop)
        dev, host, win = read_trace(tr.prof, tr.spans)
        stages = tr.stages
        print("benchmark: stages " + "; ".join(
            f"{k} {c} calls {t * 1e3:.1f} ms" for k, (c, t) in
            sorted(stages.items(), key=lambda kv: -kv[1][1])),
            file=sys.stderr)
        del tr
    else:
        records, window_s = closed_loop(*loop)
        dev, host, win, stages = [], [], None, {}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print("benchmark: request seconds " +
          " ".join(f"{r[3]:.3f}" for r in records), file=sys.stderr)
    print("benchmark: request stream bytes " +
          " ".join(str(len(r[1] or b"")) for r in records), file=sys.stderr)
    errors = [r[2] for r in records if r[2]]
    if errors:
        print(f"benchmark: {len(errors)} requests raised; the first: "
              f"{errors[0]}", file=sys.stderr)

    warnings = []
    w = SimpleNamespace(
        config=config, window_s=window_s, setup_s=setup_s,
        memory_peak_bytes=peak,
        request_bytes=[len(docs[r[0]]) for r in records],
        output_bytes=[len(r[1] or b"") for r in records],
        stages=stages, device_ops=dev,
        busy_s=core.device_intervals_union((a, b) for _, a, b in dev),
        device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        warn=warnings.append)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = core.load_module("metrics", m["name"]).read(w)
        if value is None:
            warnings.append(f"{m['name']}: nothing to read in this run")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for msg in warnings:
        print(f"benchmark: {msg}", file=sys.stderr)

    numbers = check.compare(docs, [r[:2] for r in records],
                            config["guarantee"]["window_bits"])
    result = {
        "correct": all(numbers[k] <= check.LIMITS[k] for k in numbers),
        "attempted": len(records),
        "failed": numbers["wrong_streams"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": w.device_kind, "count": cell["chips"],
                   "memory_peak_bytes": peak},
    }
    if trace:
        result["device"].update(busy_s=w.busy_s, window_s=window_s)
        result["breakdown"] = breakdown(dev, host, win)
    result["card"] = card_line() if cuda else "cpu"
    result["warnings"] = warnings
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None,
                    help="plant a fault under the timed path (the control "
                         "runs; the benchmark's own runs plant none)")
    args = ap.parse_args(argv)
    cell = core.cell(core.spec(), args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 fault=args.fault)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
