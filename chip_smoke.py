"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases (any failure ends the run with a non-zero exit and no result):
  1. report the card (nvidia-smi name and power limit);
  2. build the port's native library and its CUDA kernels from the
     sources in this checkout;
  3. hold each kernel bit for bit against its plain PyTorch version on
     the card, on the real inputs of the corpus's first 4 MiB segment,
     and time both (median of CUDA-event timed runs);
  4. the main path: compress the 16 MiB corpus at q11 on the card
     three times: a first run, a timed run (stage trace off; kernel
     launches and peak device memory counted; decoded back exactly)
     and a traced run for the stage breakdown, all with the same bytes;
  5. the same bytes from the kernels and from the plain versions on
     the CPU, for a 512 KiB prefix;
  6. print the kernels line (launches of the main path, errors, times
     and bounds), the card again, and the final JSON line.

Run from the repository root: python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the non-tensor
# 32-bit rate, which int32 compare/select work cannot exceed
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12
# latency of one shared-memory load on Hopper, in SM cycles (published
# microbenchmarks put it near 30): the backtrack's B dependent steps
# each wait on one, so B of them at the top SM clock are its floor
SMEM_LOAD_CYCLES = 30


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card_line() -> str:
    return smi("name,power.limit")


def cuda_ms(fn, reps):
    """Median ms of `reps` runs of fn, each between CUDA events, after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(nbytes, nops):
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    import brotli_tpu_torch as bt
    from brotli_tpu_torch import native
    from brotli_tpu_torch.format import constants as C
    from brotli_tpu_torch.ops import kernels, optimal as OPT
    from brotli_tpu_torch.tools.corpus import build_corpus
    from brotli_tpu_torch.utils import trace

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    native_err = []

    def build_native():
        try:
            native.build()
        except BaseException as e:  # re-raised below
            native_err.append(e)
    th = threading.Thread(target=build_native)
    th.start()
    logs = kernels.build(extra_flags=["-Xptxas", "-v"])
    th.join()
    if native_err:
        raise native_err[0]
    print(f"[2] build: kernels + native library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    # -- 3. kernels against their plain versions, first 4 MiB segment ---
    corpus = build_corpus()
    arr = np.frombuffer(corpus, np.uint8)
    maxd = C.max_backward_distance(22)
    seg = arr[:OPT.SEG_V3]
    b = OPT._bucket_v3(len(seg))
    seed = OPT._seed_parse(seg, maxd, 0)
    tables = OPT._cost_tables(seg, seed)
    dict_g = OPT._dict_probe_global(seg, [seed], 0, maxd)
    bits_tab, ctx_tab, copyq, distq = OPT.device_tables(tables, dev)
    npos, spos, slen, sdist, dloc, dval = OPT.segment_inputs(
        arr, [seed], dict_g, 0, len(seg), b, dev)
    data = OPT.upload_input(arr, len(arr), dev)[:b]
    pd, cs, litq = OPT.segment_tables(data, npos, maxd, bits_tab, ctx_tab,
                                      distq, spos, slen, sdist, dloc,
                                      dval, 0)
    n = pd.shape[1]
    nb = n // OPT.B
    nslots = pd.shape[0]
    rows = {}

    mp = kernels.suffix_min(pd, cs, copyq)
    mp_plain = OPT.suffix_min_plain(pd, cs, copyq)
    torch.cuda.synchronize()
    err = max_abs_err(mp, mp_plain)
    del mp_plain
    rows["K1"] = dict(
        name="suffix_min", route="cuda",
        source="brotli_tpu_torch/csrc/suffix_min.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:625",
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.suffix_min(pd, cs, copyq), 10),
        plain_ms=cuda_ms(lambda: OPT.suffix_min_plain(pd, cs, copyq), 3),
        nbytes=(pd.numel() + cs.numel() + copyq.numel() + mp.numel()) * 4,
        nops=n * OPT.W * nslots * 6)
    print(f"[3] K1 suffix_min: max_abs_err {err}", flush=True)

    pay = kernels.dp_scan(mp, litq)
    pay_plain = OPT.dp_scan_plain(mp, litq)
    torch.cuda.synchronize()
    err = max_abs_err(pay, pay_plain)
    rows["K3"] = dict(
        name="dp_scan", route="cuda",
        source="brotli_tpu_torch/csrc/dp_scan.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:365",
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.dp_scan(mp, litq), 10),
        plain_ms=cuda_ms(lambda: OPT.dp_scan_plain(mp, litq), 2),
        nbytes=(mp.numel() + litq.numel() + pay.numel()) * 4,
        nops=n * OPT.W * 4)
    print(f"[3] K3 dp_scan: max_abs_err {err}", flush=True)
    del mp

    g, v = kernels.dp_backtrack(pay)
    g_plain, v_plain = OPT.dp_backtrack_plain(pay)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, g_plain), max_abs_err(v, v_plain))
    rows["K4"] = dict(
        name="dp_backtrack", route="cuda",
        source="brotli_tpu_torch/csrc/dp_scan.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:494",
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.dp_backtrack(pay), 10),
        plain_ms=cuda_ms(lambda: OPT.dp_backtrack_plain(pay), 2),
        nbytes=(pay.numel() + g.numel() + v.numel()) * 4,
        nops=nb * OPT.B * 8)
    print(f"[3] K4 dp_backtrack: max_abs_err {err}", flush=True)
    for k, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("nops"))
        print(f"    {k} {r['name']}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) at n={n} [{card}]")
    mhz = float(smi("clocks.max.sm").split()[0])
    print(f"    K4 dp_backtrack: dependent-chain floor "
          f"{OPT.B * SMEM_LOAD_CYCLES / mhz * 1e-3:.3f} ms ({OPT.B} "
          f"steps of {SMEM_LOAD_CYCLES} cycles at {mhz:.0f} MHz)")
    bad = [k for k, r in rows.items() if r["max_abs_err"] != 0]
    if bad:
        sys.exit(f"chip_smoke: kernels disagree with their plain "
                 f"versions: {bad}")
    del pd, cs, litq, pay, g, v, g_plain, v_plain, pay_plain
    torch.cuda.empty_cache()

    # -- 4. the main path -------------------------------------------------
    def run_main():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = bt.compress(corpus, quality=11)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    # the first run pays first-use costs (allocator, host page faults);
    # the timed run after it has the stage trace off; a third, traced
    # run gives the stage breakdown. All three must give the same bytes.
    first, cold = run_main()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out, wall = run_main()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if bt.decompress(out) != corpus:
        sys.exit("chip_smoke: the 16 MiB stream does not decode back")
    print(f"[4] q11 {len(corpus)} B -> {len(out)} B (ratio "
          f"{len(corpus) / len(out):.4f}) in {wall:.3f} s = "
          f"{len(corpus) / wall / 1e6:.3f} MB/s on {name} [{card}]; "
          f"peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        sys.exit(f"chip_smoke: the main path launched no {missing}")
    trace.enable()
    trace.reset()
    again, traced = run_main()
    trace.enable(False)
    print(f"    first run {cold:.3f} s, traced run {traced:.3f} s; "
          f"stages of the traced run:")
    print(trace.format_report(), flush=True)
    if not first == out == again:
        sys.exit("chip_smoke: runs on the same input differ")

    # -- 5. kernels and plain versions give the same stream ---------------
    prefix = corpus[:512 << 10]
    on_card = bt.compress(prefix, quality=11)
    t0 = time.perf_counter()
    on_cpu = bt.compress(prefix, quality=11, device="cpu")
    print(f"[5] 512 KiB prefix: cuda {len(on_card)} B, cpu {len(on_cpu)} "
          f"B (cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: cuda and cpu streams differ")

    # -- 6. report ----------------------------------------------------------
    kern = []
    for key in ("K1", "K3", "K4"):
        r = rows[key]
        kern.append(dict(name=r["name"], route=r["route"],
                         source=r["source"], replaces=r["replaces"],
                         launches=launches[r["name"]],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kern}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
