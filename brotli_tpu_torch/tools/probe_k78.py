"""K7 (csrc/dp_scan_v1.cu) and K8 (csrc/dp_scan_ring.cu) on the card,
each against other versions of its source.

Builds this tree's two sources and every source given with --against-k7
or --against-k8 (any .cu exporting btt_dp_scan_v1 or btt_dp_scan_ring,
with this tree's slow-step counter argument or without it, as before it
existed: `git show REV:brotli_tpu_torch/csrc/dp_scan_v1.cu > OLD.cu`)
into brotli_tpu_torch/_build/probe/, with -Xptxas -v, and prints each
build's registers, shared memory and spills. Then, on the real inputs
of the 16 MiB corpus of tools/corpus.py (K7: the first 2 MiB v1
segment at 28 and at 38 slots; K8: the first 4 MiB v3 segment, the
implicit-cell row off and on), it holds every build bit for bit against
the plain version, prints this tree's slow-step counts, and times each
build on the card alone (launches queued behind a ~1 ms spin kernel;
the median of 5 runs of 10 launches), in turns: each other build, this
tree's, this tree's again, each other build again.

Usage, from the repository root on a machine with a card:
    python3 -m brotli_tpu_torch.tools.probe_k78 [--against-k7 OLD.cu ...]
        [--against-k8 OLD.cu ...]
"""

import argparse
import ctypes
import pathlib
import statistics
import subprocess

import numpy as np
import torch

from ..format import constants as C
from ..ops import kernels, optimal as O
from .corpus import build_corpus

_OUT = kernels._BUILD / "probe"
_P = ctypes.c_void_p
_ARGS = {"btt_dp_scan_v1": [_P] * 5 + [ctypes.c_int, ctypes.c_int, _P],
         "btt_dp_scan_ring": [_P] * 8 + [ctypes.c_int, ctypes.c_longlong,
                                         _P]}


def _build(sources: dict) -> dict:
    """{name: (.cu path, symbol)} -> {name: (function, counts a slow
    step?)}, one nvcc each, all started together; prints ptxas's
    report of each kernel."""
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_OUT / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, _) in sources.items()}
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"{name}: " + "; ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill" in line), flush=True)
        src, symbol = sources[name]
        fn = getattr(ctypes.CDLL(str(_OUT / f"lib{name}.so")), symbol)
        counted = "slow_count" in pathlib.Path(src).read_text()
        args = list(_ARGS[symbol])
        if counted:
            args.insert(args.index(ctypes.c_int), _P)
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[name] = (fn, counted)
    return fns


def _device_ms(fn, runs=5, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(2_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def _call(fn, counted, args, tail, out, slow):
    """Launch one build: args are the data pointers before paymat, tail
    the ints after the slow counter."""
    ptrs = [*args, out.data_ptr()] + ([slow.data_ptr()] if counted else [])
    rc = fn(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"CUDA error {rc} at launch")


def _compare(label, fns, args, tail, want, nb):
    out = torch.empty((nb, O.B + 1), dtype=torch.int32, device="cuda")
    slow = torch.zeros(1, dtype=torch.int32, device="cuda")
    for name, (fn, counted) in fns.items():
        slow.zero_()
        _call(fn, counted, args, tail, out, slow)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"probe_k78: {name} disagrees with the plain "
                             f"version ({label})")
        if name == "this":
            print(f"{label}: every build bitwise equal to the plain "
                  f"version; slow steps {int(slow)} of {nb * O.B}")
    order = [k for k in fns if k != "this"]
    order = order + ["this", "this"] + order[::-1] if order else \
        ["this", "this"]
    times = []
    for name in order:
        fn, counted = fns[name]
        times.append((name, _device_ms(
            lambda: _call(fn, counted, args, tail, out, slow))))
    print(f"{label}: device ms " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in times), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against-k7", nargs="*", default=[],
                    type=pathlib.Path)
    ap.add_argument("--against-k8", nargs="*", default=[],
                    type=pathlib.Path)
    args = ap.parse_args()
    k7 = {"this": (kernels._CSRC / "dp_scan_v1.cu", "btt_dp_scan_v1")}
    k7.update({p.stem: (p, "btt_dp_scan_v1") for p in args.against_k7})
    k8 = {"this": (kernels._CSRC / "dp_scan_ring.cu", "btt_dp_scan_ring")}
    k8.update({p.stem: (p, "btt_dp_scan_ring") for p in args.against_k8})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    fns7 = _build({f"k7_{k}": v for k, v in k7.items()})
    fns8 = _build({f"k8_{k}": v for k, v in k8.items()})
    fns7 = {k[3:]: v for k, v in fns7.items()}
    fns8 = {k[3:]: v for k, v in fns8.items()}

    arr = np.frombuffer(build_corpus(), np.uint8)
    maxd = C.max_backward_distance(22)
    t = lambda a: torch.from_numpy(np.array(a)).cuda()
    seed = O._seed_parse(arr, maxd, 0)
    lit, copyq1, distq1 = (t(np.asarray(a, np.int32).reshape(-1))
                           for a in O._cost_tables(
                               arr, seed, lit_table=False,
                               cfg=O.DPConfig(mode="v1")))
    seeds = [t(a.astype(np.int64)) for a in O._seg_seed_edges(
        [seed], 0, O.SEG, O.SEG // 32)]
    data1 = t(arr[:O.SEG])
    for label, levels in (("K7, 28 slots", O.LEVELS),
                          ("K7, 38 slots", O.DPConfig(level3=True).levels)):
        pd, cs, litq = O.edges_v1(data1, O.SEG - 3, maxd, lit, distq1,
                                  *seeds, levels=levels)
        want = O.dp_scan_v1_plain(pd, cs, litq, copyq1)
        _compare(label, fns7, [pd.data_ptr(), cs.data_ptr(),
                               litq.data_ptr(), copyq1.data_ptr()],
                 [pd.shape[0], pd.shape[1] // O.B], want, pd.shape[1] // O.B)
    del pd, cs, litq, want, data1, seeds, lit
    torch.cuda.empty_cache()

    seg = arr[:O.SEG_V3]
    b = O._bucket_v3(len(seg))
    seed1 = O._seed_parse(seg, maxd, 0)
    tables = O._cost_tables(seg, seed1, lit_table=True, cfg=O.DPConfig())
    dict_g = O._dict_probe_global(seg, [seed1], 0, maxd)
    bits_tab, ctx_tab, copyq, distq = O.device_tables(tables, "cuda")
    npos, *rest = O.segment_inputs(arr, [seed1], dict_g, 0, len(seg), b,
                                   "cuda")
    data = O.upload_input(arr, len(arr), "cuda")[:b]
    pd, cs, litq, dist_fill = O.segment_tables(
        data, npos, maxd, bits_tab, ctx_tab, distq, *rest, 0)
    mp = kernels.suffix_min(pd, cs, copyq)
    del pd, cs
    ring_init = dist_fill.view(-1, O.B)[:, 0].contiguous()
    icell = t(tables[4].astype(np.int32))
    nb = b // O.B
    for label, ic in (("K8", None), ("K8, icell", icell)):
        want = O.dp_scan_ring_plain(mp, litq, data, ring_init, distq[:1],
                                    copyq, ic, npos)
        _compare(label, fns8,
                 [mp.data_ptr(), litq.data_ptr(), data.data_ptr(),
                  ring_init.data_ptr(), distq[:1].data_ptr(),
                  copyq.data_ptr(), None if ic is None else ic.data_ptr()],
                 [nb, int(npos)], want, nb)


if __name__ == "__main__":
    main()
