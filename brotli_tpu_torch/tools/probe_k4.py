"""K4 (csrc/dp_backtrack.cu) phase by phase, on the card.

Builds the kernel's source twice into brotli_tpu_torch/_build/probe/: as
it is, and with -DBTT_K4_STAMPS, which makes thread 0 of every CTA stamp
%globaltimer at the start of each of its six numbered phases and at its
end. Each source given with --against (any .cu that exports
btt_dp_backtrack with the same signature, such as an earlier dp_scan.cu)
is built beside them. Then, on seeded payload rows at the main path's
shape (nb = 1,024 DP blocks), it prints:
  * each build's device time: launches queued behind a ~1 ms spin
    kernel, so the host's launch gap is out; the median over 5 runs of
    20 launches;
  * for the stamped build, each phase's median and largest time over
    the CTAs, and the span from the first CTA's start to the last end.
The stamped build is held bit for bit against the plain version first.

Usage, from the repository root on a machine with a card:
    python3 -m brotli_tpu_torch.tools.probe_k4 [--against OLD.cu ...]
"""

import argparse
import ctypes
import pathlib
import statistics
import subprocess

import numpy as np
import torch

from ..ops import kernels, optimal

_SRC = kernels._CSRC / "dp_backtrack.cu"
_OUT = kernels._BUILD / "probe"
_NB = 1024
_NPHASES = 6
# lengths 0 or 1 (the walk of B positions), every length 63 (the
# shortest walk), and a spread of lengths like a real parse's
_FILLS = {"ones": [0, 1], "63": [63],
          "mix": [0, 1, 2, 3, 4, 6, 8, 12, 17, 30, 63]}


def _build(sources: dict) -> dict:
    """{name: (.cu path, extra nvcc flags)} -> {name: library}, one nvcc
    each, all started together."""
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in sources.items():
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
             str(_OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(_OUT / f"lib{name}.so"))
        lib.btt_dp_backtrack.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.btt_dp_backtrack.restype = ctypes.c_int
        if hasattr(lib, "btt_stamps_read"):
            lib.btt_stamps_read.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _payloads(fill: str, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (_NB, optimal.B + 1)
    ln = rng.choice(_FILLS[fill], shape).astype(np.uint32)
    dist = rng.integers(0, 1 << 25, shape).astype(np.uint32)
    return torch.from_numpy(((ln << 25) | dist).view(np.int32)).cuda()


def _device_ms(fn, runs=5, reps=20) -> float:
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], type=pathlib.Path)
    args = ap.parse_args()
    sources = {"kernel": (_SRC, []),
               "stamped": (_SRC, ["-DBTT_K4_STAMPS"])}
    sources.update({p.stem: (p, []) for p in args.against})
    libs = _build(sources)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    stream = torch.cuda.current_stream().cuda_stream
    gsrc = torch.empty((optimal.B, _NB), dtype=torch.int32, device="cuda")
    vals = torch.empty_like(gsrc)
    for fill in _FILLS:
        pay = _payloads(fill)

        def launch(lib):
            rc = lib.btt_dp_backtrack(pay.data_ptr(), gsrc.data_ptr(),
                                      vals.data_ptr(), _NB, stream)
            if rc:
                raise RuntimeError(f"btt_dp_backtrack: CUDA error {rc}")

        launch(libs["stamped"])
        want = optimal.dp_backtrack_plain(pay)
        if not (torch.equal(gsrc, want[0]) and torch.equal(vals, want[1])):
            raise SystemExit(f"probe_k4: the stamped kernel disagrees "
                             f"({fill})")
        times = {name: _device_ms(lambda: launch(lib)) * 1e3
                 for name, lib in libs.items() if name != "stamped"}
        print(f"{fill}: device us " +
              ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
        launch(libs["stamped"])
        torch.cuda.synchronize()
        buf = np.zeros(1 << 15, np.uint64)
        if libs["stamped"].btt_stamps_read(buf.ctypes.data):
            raise RuntimeError("btt_stamps_read failed")
        nctas = (_NB + 7) // 8
        st = buf.reshape(-1, 8)[:nctas, :_NPHASES + 1].astype(np.int64)
        for ph in range(_NPHASES):
            d = (st[:, ph + 1] - st[:, ph]) / 1e3
            print(f"    phase {ph + 1}: median {np.median(d):.2f} us, "
                  f"max {d.max():.2f} us")
        print(f"    span {(st[:, -1].max() - st[:, 0].min()) / 1e3:.2f} us "
              f"over {nctas} CTAs")


if __name__ == "__main__":
    main()
