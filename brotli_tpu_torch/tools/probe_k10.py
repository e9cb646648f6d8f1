"""K10 (csrc/edge_ranks.cu) and K9 (csrc/edge_keys.cu) on the card,
each against other versions of its source, with two diagnostic builds
of the first version of K10 that split its time between its stores and
its gathers.

Builds into brotli_tpu_torch/_build/probe/, with -Xptxas -v (printing
each build's registers, shared memory and spills):
  - this tree's K10 (its level launch and its row pass) and K9;
  - every source given with --against (a K10) or --against-k9 (a K9),
    e.g. `git show REV:brotli_tpu_torch/csrc/edge_ranks.cu > OLD.cu`.
    Each build is fed its own contract: a K9 that writes `long long*`
    keys and a K10 that reads them (the first versions, one launch a
    level into the (n, ncand) table) get the JAX uint32 key in int64,
    the others the int32 key - 2**31; a K10 with a row pass writes each
    level's 16-word rows, then the table; every build but a first
    version has to take this tree's launch arguments, which it is
    called with at 0 (JAX keys, no halo; a source from before one of
    them was an argument ends the run);
  - from the first --against source (or this tree's K10 while it is
    still the first version), if it is the first version:
    "stores_only", each row's words made from its key and position with
    no window loads and stored as that kernel stores them, and
    "gathers_only", the full compares with the words written in sorted
    order (row i, not row p), which lands a warp's stores in 32
    consecutive rows.
Then, on the first 4 MiB DP segment of the 16 MiB corpus of
tools/corpus.py at each level (4 bytes, 13 ranks; 8 bytes, 14 ranks;
level 3's 16 bytes, 10 ranks), it holds every build bit for bit against
the plain version ("gathers_only" against it in sorted order;
"stores_only" is not checked), and times each build on the card alone,
in turns (each other build, this tree's, this tree's again, each other
again; the median of 5 runs of 10 launches queued behind a spin
kernel); then the row passes, at 27 and 37 columns. It also times the
level's torch.sort(stable=True) on the int64 keys and on the int32
keys, a library call timed here only as a measurement.

Usage, from the repository root on a machine with a card:
    python3 -m brotli_tpu_torch.tools.probe_k10 [--against OLD.cu ...]
        [--against-k9 OLD.cu ...]
"""

import argparse
import ctypes
import pathlib
import re
import subprocess

import numpy as np
import torch

from ..format import constants as C
from ..ops import kernels, optimal as O
from .corpus import build_corpus
from .probe_k78 import _device_ms

_OUT = kernels._BUILD / "probe"
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_ARGS = {
    # the first version: one launch a level into the (n, ld) table
    "btt_edge_ranks_v1": [_P, _P, _P, _P, _I64, _INT, _INT, _P, _INT, _I64,
                          _I64, _P],
    "btt_edge_ranks": kernels._SIGNATURES["btt_edge_ranks"],
    "btt_edge_rows": kernels._SIGNATURES["btt_edge_rows"],
    # the first version: the uint32 key zero-extended in int64
    "btt_edge_keys_v1": [_P, _P, _I64, _INT, _I64, _P],
    "btt_edge_keys": kernels._SIGNATURES["btt_edge_keys"],
}
# the arguments after which this tree's entry points end (the stream's
# base, the first row written, the wide keys), each passed as 0
_TAIL = {"btt_edge_ranks": ("long long base", "long long row0", "int wide"),
         "btt_edge_keys": ("int wide",)}
# the first version's row pointer, and what the two diagnostic builds
# make of it
_ROW = "  int* row = out + p * ld + col;\n"
_VARIANTS = {
    "stores_only": _ROW + "  for (int r = 0; r < nranks; ++r) "
                          "row[r] = (int)(ki ^ (p << r));\n  return;\n",
    "gathers_only": "  int* row = out + i * ld + col;\n",
}


def _wide_keys(src: str, symbol: str) -> bool:
    """Does the source's C entry point take the first version's int64
    keys?"""
    head = src[src.index(f'extern "C" int {symbol}('):]
    head = head[:head.index(")")]
    return "long long* key" in head


def _current(src: str, symbol: str) -> bool:
    """Does the source's entry point take this tree's arguments?"""
    head = src[src.index(f'extern "C" int {symbol}('):]
    head = head[:head.index(")")]
    return all(arg in head for arg in _TAIL[symbol])


def _build(sources: dict) -> dict:
    """{name: (.cu text, symbol)} -> {name: (function, int64 keys?,
    btt_edge_rows or None)}, one nvcc each, all started together; prints
    ptxas's report of each kernel. A build of this tree's arguments is
    called with the later ones (_TAIL) 0; a first version (int64 keys)
    with its own; one of other arguments ends the run."""
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, _) in sources.items():
        src = _OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(_OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"{name}: " + "; ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if re.search(r"registers|spill|Compiling entry", line)),
            flush=True)
        text, symbol = sources[name]
        lib = ctypes.CDLL(str(_OUT / f"lib{name}.so"))
        wide = _wide_keys(text, symbol)
        fn = getattr(lib, symbol)
        if not wide and not _current(text, symbol):
            raise SystemExit(f"probe_k10: {name}'s {symbol} takes other "
                             f"arguments than this tree's")
        fn.argtypes = _ARGS[symbol + ("_v1" if wide else "")]
        fn.restype = ctypes.c_int
        if not wide:
            fn = (lambda f, z: lambda *a: f(*a[:-1], *z, a[-1]))(
                fn, (0,) * len(_TAIL[symbol]))
        rows = getattr(lib, "btt_edge_rows", None)
        if rows is not None:
            rows.argtypes, rows.restype = _ARGS["btt_edge_rows"], ctypes.c_int
        fns[name] = (fn, wide, rows)
    return fns


def _run(fn, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"CUDA error {rc} at launch")


def _in_turns(label, calls):
    """Time {name: fn} alone in turns and print the medians."""
    order = [k for k in calls if k != "this"]
    order = order + ["this", "this"] + order[::-1]
    times = [(k, _device_ms(calls[k])) for k in order]
    print(f"{label}: device ms " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in times), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], type=pathlib.Path)
    ap.add_argument("--against-k9", nargs="*", default=[],
                    type=pathlib.Path)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)

    k10 = {"this": (kernels._CSRC / "edge_ranks.cu").read_text()}
    k10.update({p.stem: p.read_text() for p in args.against})
    first = k10[args.against[0].stem] if args.against else k10["this"]
    if _ROW in first and _wide_keys(first, "btt_edge_ranks"):
        for name, text in _VARIANTS.items():
            k10[name] = first.replace(_ROW, text)
    k9 = {"this": (kernels._CSRC / "edge_keys.cu").read_text()}
    k9.update({p.stem: p.read_text() for p in args.against_k9})
    fns = _build({**{f"k10_{k}": (v, "btt_edge_ranks")
                     for k, v in k10.items()},
                  **{f"k9_{k}": (v, "btt_edge_keys") for k, v in k9.items()}})
    f10 = {k[4:]: v for k, v in fns.items() if k.startswith("k10_")}
    f9 = {k[3:]: v for k, v in fns.items() if k.startswith("k9_")}

    arr = np.frombuffer(build_corpus(), np.uint8)
    data = torch.from_numpy(arr[:O.SEG_V3].copy()).cuda()
    n = data.shape[0]
    npos = n - 3  # a full segment's: _prep_segment_v3
    maxd = C.max_backward_distance(22)
    levels = O.LEVELS + (O.LEVEL3,)
    nranks = [len(r) for _, r in levels]
    # the two-launch builds' level rows, kept for their row pass
    words = {k: torch.zeros((len(levels), n, kernels.MAX_RANKS),
                            dtype=torch.int32, device="cuda")
             for k, (_, _, rows) in f10.items() if rows is not None}
    want_w = torch.zeros((len(levels), n, kernels.MAX_RANKS),
                         dtype=torch.int32, device="cuda")
    col = 0
    for lvl, (plen, ranks) in enumerate(levels):
        lnp = npos - (plen - 4)
        key32 = O.edge_keys_plain(data, lnp, plen)
        key64 = key32.to(torch.int64) + (1 << 31)
        label = f"{plen}-byte level, {len(ranks)} ranks"

        keys = {}
        for name, (fn, wide, _) in f9.items():
            got = torch.empty(n, dtype=torch.int64 if wide else torch.int32,
                              device="cuda")
            _run(fn, data.data_ptr(), got.data_ptr(), n, plen, lnp)
            torch.cuda.synchronize()
            if not torch.equal(got, key64 if wide else key32):
                raise SystemExit(f"probe_k10: K9 {name} disagrees with the "
                                 f"plain version ({label})")
            keys[name] = got
        print(f"{label}: every K9 build bitwise equal to the plain version",
              flush=True)
        _in_turns(f"{label}, K9", {
            k: (lambda fn=fn, o=keys[k]: _run(
                fn, data.data_ptr(), o.data_ptr(), n, plen, lnp))
            for k, (fn, _, _) in f9.items()})
        del keys

        sorted64 = torch.sort(key64, stable=True)
        sorted32 = torch.sort(key32, stable=True)
        if not torch.equal(sorted64[1], sorted32[1]):
            raise SystemExit(f"probe_k10: the int32 keys sort otherwise "
                             f"({label})")
        sort_ms = {
            "int64": lambda: torch.sort(key64, stable=True),
            "int32": lambda: torch.sort(key32, stable=True)}
        print(f"{label}: torch.sort(stable=True) alone, ms: " + ", ".join(
            f"{k} {_device_ms(f):.4f}" for k, f in
            (*sort_ms.items(), *list(sort_ms.items())[::-1])), flush=True)
        order = sorted32[1]
        want = O.edge_ranks_plain(sorted32[0], order, data, lnp, maxd,
                                  ranks)
        want_w[lvl, :, :len(ranks)] = want
        rk = (ctypes.c_int * len(ranks))(*ranks)
        # the first version's (n, ld) table, the levels at their columns
        ld = 37 if plen == 16 else 27
        c = 27 if plen == 16 else col
        out = torch.zeros((n, ld), dtype=torch.int32, device="cuda")
        calls = {}
        for name, (fn, wide, rows) in f10.items():
            if rows is None:
                ks = sorted64[0] if wide else sorted32[0]
                call = (lambda fn=fn, ks=ks: _run(
                    fn, ks.data_ptr(), order.data_ptr(), data.data_ptr(),
                    out.data_ptr(), n, ld, c, rk, len(ranks), lnp, maxd))
                out.zero_()
                call()
                torch.cuda.synchronize()
                got = out[:, c:c + len(ranks)]
                ok = (name == "stores_only" or torch.equal(
                    got, want[order] if name == "gathers_only" else want))
            else:
                w = words[name][lvl]
                call = (lambda fn=fn, w=w: _run(
                    fn, sorted32[0].data_ptr(), order.data_ptr(),
                    data.data_ptr(), w.data_ptr(), n, rk, len(ranks), lnp,
                    maxd))
                call()
                torch.cuda.synchronize()
                ok = torch.equal(w, want_w[lvl])
            if not ok:
                raise SystemExit(f"probe_k10: K10 {name} disagrees with the "
                                 f"plain version ({label})")
            calls[name] = call
        print(f"{label}: every K10 build bitwise equal to the plain version "
              f"(stores_only not checked)", flush=True)
        _in_turns(f"{label}, K10", calls)
        col += len(ranks)
        del out, want, sorted64, sorted32, key32, key64
        torch.cuda.empty_cache()

    # the row pass of the two-launch builds: the default levels (27
    # columns) and with level 3 (37)
    for nl in (2, 3):
        label = f"row pass, {sum(nranks[:nl])} columns"
        want = O.edge_rows_plain(want_w[:nl], nranks[:nl])
        out = torch.empty_like(want)
        nr = (ctypes.c_int * nl)(*nranks[:nl])
        calls = {}
        for name, w in words.items():
            calls[name] = (lambda rows=f10[name][2], w=w[:nl]: _run(
                rows, w.data_ptr(), out.data_ptr(), n, nr, nl))
            out.zero_()
            calls[name]()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"probe_k10: the row pass of {name} "
                                 f"disagrees with the plain version")
        if calls:
            print(f"{label}: every build bitwise equal to the plain version",
                  flush=True)
            _in_turns(label, calls)


if __name__ == "__main__":
    main()
