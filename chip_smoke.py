"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases (any failure ends the run with a non-zero exit and no result):
  1. report the card (nvidia-smi name and power limit);
  2. build the port's native library and its CUDA kernels from the
     sources in this checkout;
  3. hold each kernel bit for bit against its plain PyTorch version on
     the card and time both (median of CUDA-event timed runs): K1, K3
     and K4 on the real inputs of the corpus's first 4 MiB DP segment,
     K1 and K4 also on seeded inputs at the same shapes (K4 also with
     a part-full last CTA and with rows off the 16-byte grid), K2 on the
     real skip vector of the q5 matcher's second 8 MiB segment (once,
     then 100 times in a row, every result the same) and on seeded
     vectors (all 1, all 16, uniform, alternating 16/1; from 0, a chunk
     boundary, a sub-chunk's last offset, n - 1 and n; two at 1 Mi, one
     off the 16-byte grid);
  4. the q11 path: compress the 16 MiB corpus at q11 on the card three
     times: a first run, a timed run (stage trace off; kernel launches
     and peak device memory counted; decoded back exactly) and a traced
     run for the stage breakdown, all with the same bytes;
  5. the same q11 bytes from the kernels and from the plain versions on
     the CPU, for a 512 KiB prefix;
  6. the q5 path: parallel.shard.compress_sharded(corpus, quality=5),
     the device matcher with K2, run three times as in phase 4;
  7. the same q5 bytes on the card and on the CPU, for a 1 MiB prefix;
  8. q11 with two shards on the card (8 MiB): the second shard's seed
     parse runs the device matcher, so all four kernels launch;
  9. print the kernels line (launches on each kernel's path, errors,
     times and bounds), the card again, and the final JSON line.

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
# microbenchmarks put it near 30): each dependent step of K2's walks
# waits on one
SMEM_LOAD_CYCLES = 30
# ~1 ms at the H100's SM clock: longer than any wrapper's launch gap
SPIN_CYCLES = 2_000_000


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card_line() -> str:
    return smi("name,power.limit")


def cuda_ms(fn, reps, queued=False):
    """Median ms of `reps` runs of fn, each between CUDA events, after
    one warm-up run. One call at a time (the kernels line's `ms`), the
    time holds the host's launch gap (the wrapper's Python) after the
    first event. Queued (its `device_ms`), each run waits behind a ~1 ms
    spin kernel, so the host has enqueued its launches before the first
    event fires and the events time the card's work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def k1_case(nslots, n, seed):
    """Seeded K1 slots at the main path's width, as in
    tests/test_torch_kernels.py: costs from a handful of values (ties
    across slots, values at and above 1 << 28, a negative one), lengths
    over -64..63 (pd with bit 31 set), dictionary lengths 0..127 (64 and
    above wrap), live distances on dead slots."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(-64, 64, (nslots, n), dtype=np.int32)
    ls[nslots - 2] = rng.integers(0, 128, n, dtype=np.int32)
    ds = rng.integers(0, 1 << 25, (nslots, n), dtype=np.int32)
    vals = np.array([-7, 0, 5, 5, 9, (1 << 28) - 1, 1 << 28, (1 << 28) + 1,
                     (1 << 31) - 1], np.int32)
    cs = vals[rng.integers(0, len(vals), (nslots, n), dtype=np.int32)]
    pd = (ls.astype(np.uint32) << 25) | ds.astype(np.uint32)
    copyq = rng.integers(0, 300, 64, dtype=np.int32)
    copyq[:2] = 1 << 28
    return pd.view(np.int32), cs, copyq


def k4_case(fill, nb, B, seed):
    """Seeded K4 payload rows: "ones" (lengths 0 or 1: the walk of B
    positions), "random" (lengths over -64..63: steps that overrun the
    block start into negative positions) or "63" (every length 63)."""
    rng = np.random.default_rng(seed)
    shape = (nb, B + 1)
    if fill == "ones":
        ln = rng.integers(0, 2, shape, dtype=np.int32)
    elif fill == "random":
        ln = rng.integers(-64, 64, shape, dtype=np.int32)
    else:
        ln = np.full(shape, 63, np.int32)
    pay = (ln.astype(np.uint32) << 25) | rng.integers(
        0, 1 << 25, shape, dtype=np.int32).astype(np.uint32)
    return pay.view(np.int32)


def bound(nbytes, nops):
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def timed(fn):
    """(result, seconds) of fn() on the host clock, between two
    synchronizes."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def three_runs(fn, trace, kernels, label, corpus, decompress, card):
    """A first run, a timed run with the trace off (kernel launches and
    peak device memory counted, the stream decoded back exactly) and a
    traced run; all three must give the same bytes. Returns the timed
    run's launches."""
    first, cold = timed(fn)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out, wall = timed(fn)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if decompress(out) != corpus:
        sys.exit(f"chip_smoke: the {label} stream does not decode back")
    print(f"    {label}: {len(corpus)} B -> {len(out)} B (ratio "
          f"{len(corpus) / len(out):.4f}) in {wall:.3f} s = "
          f"{len(corpus) / wall / 1e6:.3f} MB/s [{card}]; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    trace.enable()
    trace.reset()
    again, traced = timed(fn)
    trace.enable(False)
    print(f"    first run {cold:.3f} s, traced run {traced:.3f} s; "
          f"stages of the traced run:")
    print(trace.format_report(), flush=True)
    if not first == out == again:
        sys.exit(f"chip_smoke: {label} runs on the same input differ")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    import brotli_tpu_torch as bt
    from brotli_tpu_torch import native
    from brotli_tpu_torch.format import constants as C
    from brotli_tpu_torch.ops import chain, kernels, optimal as OPT
    from brotli_tpu_torch.ops import matcher as PM
    from brotli_tpu_torch.parallel.shard import compress_sharded
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

    # K1 on seeded slots at the segment's width first (each case's rows
    # are freed before the next), then on the real segment; every
    # comparison is bitwise
    errs = {}
    for label, ns, sd in (("ties29", 29, 1), ("slots2", 2, 2),
                          ("slots32", 32, 3)):
        spd, scs, scq = (torch.from_numpy(a).to(dev)
                         for a in k1_case(ns, n, sd))
        got = kernels.suffix_min(spd, scs, scq)
        errs[label] = max_abs_err(got, OPT.suffix_min_plain(spd, scs, scq))
        del spd, scs, scq, got
        torch.cuda.empty_cache()
    mp = kernels.suffix_min(pd, cs, copyq)
    mp_plain = OPT.suffix_min_plain(pd, cs, copyq)
    torch.cuda.synchronize()
    errs["real"] = max_abs_err(mp, mp_plain)
    del mp_plain
    rows["K1"] = dict(
        name="suffix_min", route="cuda",
        source="brotli_tpu_torch/csrc/suffix_min.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:625",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.suffix_min(pd, cs, copyq), 10),
        device_ms=cuda_ms(lambda: kernels.suffix_min(pd, cs, copyq), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.suffix_min_plain(pd, cs, copyq), 3),
        nbytes=(pd.numel() + cs.numel() + copyq.numel() + mp.numel()) * 4,
        # the scatter's nslots and the suffix-min's W steps a position,
        # about 8 operations each
        nops=n * (nslots + OPT.W) * 8)
    print(f"[3] K1 suffix_min: max_abs_err {errs}", flush=True)

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
        device_ms=cuda_ms(lambda: kernels.dp_scan(mp, litq), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.dp_scan_plain(mp, litq), 2),
        nbytes=(mp.numel() + litq.numel() + pay.numel()) * 4,
        nops=n * OPT.W * 4)
    print(f"[3] K3 dp_scan: max_abs_err {err}", flush=True)
    del mp

    # K4 on seeded rows at the segment's width; then on a count of
    # blocks that leaves the last CTA part-full, and on rows that start
    # off the 16-byte grid (a slice from row 1: the scalar staging)
    errs = {}
    k4_cases = [(label, k4_case(label, nb, OPT.B, sd))
                for label, sd in (("ones", 1), ("random", 2), ("63", 3))]
    k4_cases += [("partial", k4_case("random", nb - 3, OPT.B, 4)),
                 ("unaligned", k4_case("random", nb + 1, OPT.B, 5))]
    for label, rows_np in k4_cases:
        spay = torch.from_numpy(rows_np).to(dev)
        if label == "unaligned":
            spay = spay[1:]
        got = kernels.dp_backtrack(spay)
        want = OPT.dp_backtrack_plain(spay)
        errs[label] = max(max_abs_err(got[0], want[0]),
                          max_abs_err(got[1], want[1]))
    g, v = kernels.dp_backtrack(pay)
    g_plain, v_plain = OPT.dp_backtrack_plain(pay)
    torch.cuda.synchronize()
    errs["real"] = max(max_abs_err(g, g_plain), max_abs_err(v, v_plain))
    rows["K4"] = dict(
        name="dp_backtrack", route="cuda",
        source="brotli_tpu_torch/csrc/dp_backtrack.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:494",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.dp_backtrack(pay), 10),
        device_ms=cuda_ms(lambda: kernels.dp_backtrack(pay), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.dp_backtrack_plain(pay), 2),
        nbytes=(pay.numel() + g.numel() + v.numel()) * 4,
        nops=nb * OPT.B * 8)
    print(f"[3] K4 dp_backtrack: max_abs_err {errs}", flush=True)
    del pd, cs, litq, pay, g, v, g_plain, v_plain, pay_plain, spay, got
    del want, k4_cases
    torch.cuda.empty_cache()

    # K2 on the real skip vector of the q5 matcher's second segment of
    # the 16 MiB corpus (buffer [0, 8 MiB), start 4 Mi), then on seeded
    # vectors from the start offsets that the numpy model of its design
    # in tests/test_torch_matcher.py covers (a chunk boundary, a
    # sub-chunk's last offset, n - 1, n), and on one at 1 Mi; every
    # comparison is bitwise
    nk = PM._bucket(PM.SEG_BYTES)
    buf = torch.from_numpy(arr[:nk].copy()).to(dev)
    _, _, skip = PM.match_skip(buf, nk - 3, maxd, 4)
    skip = skip.to(torch.int32)
    del buf
    start_real = PM.SEG_BYTES // 2
    cl, cs_ = kernels.CHAIN_L, kernels.CHAIN_S
    edges = (0, 12345, 100 * cl, 100 * cl + 5 * cs_ + cs_ - 1, nk - 1, nk)
    rng = np.random.default_rng(0)
    cases = [("real", skip, start_real)]
    for fill in ("1", "16", "uniform", "alternating"):
        if fill == "uniform":
            vec = rng.integers(1, 17, nk)
        elif fill == "alternating":
            vec = np.where(np.arange(nk) % 2 == 0, 16, 1)
        else:
            vec = np.full(nk, int(fill))
        vec = torch.from_numpy(vec.astype(np.int32)).to(dev)
        # the all-1 walk visits every position: its plain walk is slow
        starts = (0, 12345, nk - 1, nk) if fill == "1" else edges
        cases += [(f"{fill}@{st}", vec, st) for st in starts]
    # 1 Mi, and the same length off the 16-byte grid (the scalar staging)
    vec = torch.from_numpy(rng.integers(1, 17, (1 << 20) + 1)
                           .astype(np.int32)).to(dev)
    cases += [(f"uniform1Mi@{st}", vec[:1 << 20], st)
              for st in (0, 7 * cl + 3 * cs_ + cs_ - 1)]
    cases += [("unaligned1Mi@12345", vec[1:], 12345)]
    errs, taken = {}, {}
    for label, vec, st in cases:
        got, flag = kernels.chain_select_launch(vec, vec.shape[0], st)
        want = chain.chain_select_plain(vec, vec.shape[0], st)
        errs[label] = max_abs_err(got, want) + int(flag.item())
        taken[label] = int(want.sum())
    # the real case 100 times in a row: a race in the look-back would
    # show as a result that differs
    want = chain.chain_select_plain(skip, nk, start_real)
    errs["real x100"] = 0
    for _ in range(100):
        got, flag = kernels.chain_select_launch(skip, nk, start_real)
        errs["real x100"] = max(errs["real x100"], max_abs_err(got, want),
                                int(flag.item()))
    print(f"[3] K2 chain_select: max_abs_err {errs}; matches taken "
          f"{taken}", flush=True)
    # a skip outside [1, 16] sets the kernel's error flag
    bad_skip = skip.clone()
    bad_skip[nk // 3] = 0
    _, flag = kernels.chain_select_launch(bad_skip, nk, 0)
    if int(flag.item()) == 0:
        sys.exit("chip_smoke: K2 took a skip outside [1, 16]")
    rows["K2"] = dict(
        name="chain_select", route="cuda",
        source="brotli_tpu_torch/csrc/chain_select.cu",
        replaces="brotli_tpu/ops/chain_pallas.py:59",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.chain_select_launch(skip, nk,
                                                       start_real), 10),
        device_ms=cuda_ms(lambda: kernels.chain_select_launch(
            skip, nk, start_real), 10, queued=True),
        plain_ms=cuda_ms(lambda: chain.chain_select_plain(skip, nk,
                                                          start_real), 1),
        nbytes=2 * nk * 4,  # skip read once, sel written once
        nops=nk)
    del cases, vec, got, want, bad_skip

    for k, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("nops"))
        print(f"    {k} {r['name']}: kernel {r['ms']:.3f} ms one call "
              f"(the card alone {r['device_ms']:.3f} ms), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) at n={nk if k == 'K2' else n} [{card}]")
    mhz = float(smi("clocks.max.sm").split()[0])
    print(f"    K4 dp_backtrack: bound by bytes "
          f"({rows['K4']['bound_ms']:.3f} ms); its dependent steps: 5 "
          f"doubling rounds, a chain of at most {OPT.B // 32} checkpoints "
          f"32 steps apart, then 32 steps from each checkpoint")
    steps = kernels.CHAIN_S + 2 * 16
    print(f"    K2 chain_select: bound by bytes "
          f"({rows['K2']['bound_ms']:.3f} ms); the dependent chain of one "
          f"chunk: {steps} shared-memory loads ({kernels.CHAIN_S} in the "
          f"sub-chunk walk, 16 for the chunk map, 16 for the entries), "
          f"{steps * SMEM_LOAD_CYCLES / mhz * 1e-3:.4f} ms at "
          f"{SMEM_LOAD_CYCLES} cycles each and {mhz:.0f} MHz, plus one L2 "
          f"round trip for each look-back round of 32 predecessors; "
          f"chunks overlap")
    bad = [k for k, r in rows.items() if r["max_abs_err"] != 0]
    if bad:
        sys.exit(f"chip_smoke: kernels disagree with their plain "
                 f"versions: {bad}")
    del skip
    torch.cuda.empty_cache()

    # -- 4. the q11 path ------------------------------------------------
    print("[4] q11, api.compress", flush=True)
    launches = three_runs(lambda: bt.compress(corpus, quality=11), trace,
                          kernels, "q11", corpus, bt.decompress, card)
    missing = [k for k in ("suffix_min", "dp_scan", "dp_backtrack")
               if launches[k] == 0]
    if missing:
        sys.exit(f"chip_smoke: the q11 path launched no {missing}")

    # -- 5. kernels and plain versions give the same stream ---------------
    prefix = corpus[:512 << 10]
    on_card = bt.compress(prefix, quality=11)
    t0 = time.perf_counter()
    on_cpu = bt.compress(prefix, quality=11, device="cpu")
    print(f"[5] 512 KiB prefix: cuda {len(on_card)} B, cpu {len(on_cpu)} "
          f"B (cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: cuda and cpu streams differ")

    # -- 6. the q5 path --------------------------------------------------
    print("[6] q5, parallel.shard.compress_sharded", flush=True)
    launches_q5 = three_runs(
        lambda: compress_sharded(corpus, quality=5), trace, kernels, "q5",
        corpus, bt.decompress, card)
    if launches_q5["chain_select"] != 4:
        sys.exit(f"chip_smoke: the q5 path launched chain_select "
                 f"{launches_q5['chain_select']} times, not 4")

    # -- 7. q5 on the card and on the CPU --------------------------------
    prefix = corpus[:1 << 20]
    on_card = compress_sharded(prefix, quality=5)
    t0 = time.perf_counter()
    on_cpu = compress_sharded(prefix, quality=5, device="cpu")
    print(f"[7] q5 1 MiB prefix: cuda {len(on_card)} B, cpu {len(on_cpu)} "
          f"B (cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: q5 cuda and cpu streams differ")

    # -- 8. q11 with two shards ------------------------------------------
    part = corpus[:8 << 20]
    kernels.reset_launches()
    out2, wall2 = timed(lambda: compress_sharded(part, quality=11,
                                                 n_shards=2))
    launches_sh = dict(kernels.LAUNCHES)
    print(f"[8] q11, two shards: {len(part)} B -> {len(out2)} B (ratio "
          f"{len(part) / len(out2):.4f}) in {wall2:.3f} s [{card}]; "
          f"launches {launches_sh}", flush=True)
    if bt.decompress(out2) != part:
        sys.exit("chip_smoke: the two-shard q11 stream does not decode")
    missing = [k for k, c in launches_sh.items() if c == 0]
    if missing:
        sys.exit(f"chip_smoke: the two-shard q11 path launched no {missing}")

    # -- 9. report -------------------------------------------------------
    path_launches = dict(launches, chain_select=launches_q5["chain_select"])
    kern = []
    for key in ("K1", "K2", "K3", "K4"):
        r = rows[key]
        kern.append(dict(name=r["name"], route=r["route"],
                         source=r["source"], replaces=r["replaces"],
                         launches=path_launches[r["name"]],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         device_ms=r["device_ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kern}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
