"""Run parallel.multihost.compress_sharded_mp in several processes.

    python -m brotli_tpu_torch.tools.mp_compress --nproc 4 \\
        --devices cuda:0 [--quality 5] [--lgwin 22] IN OUT

starts four worker processes of this module, joined in one gloo group
through a file:// store in a temporary directory; each compresses IN on
its devices (comma-separated: "cuda:0" for one shard a process on one
card, "cuda:0,cuda:1" for two). The launcher checks that every rank
returned the same stream and writes it to OUT. A worker that fails makes
the launcher end the others at once (they would wait in a collective)
and exit non-zero.
"""

import argparse
import datetime
import pathlib
import subprocess
import sys
import tempfile
import time


def worker(rank, world, init_method, devices, quality, lgwin, src, dst,
           timeout):
    """One rank: join the group, compress, write the stream to dst."""
    import torch.distributed as dist

    from ..parallel.multihost import compress_sharded_mp
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = compress_sharded_mp(pathlib.Path(src).read_bytes(), quality,
                                  lgwin, devices=devices)
    finally:
        dist.destroy_process_group()
    pathlib.Path(dst).write_bytes(out)


def worker_args(rank, world, init_method, devices, quality, lgwin, src, dst,
                timeout):
    """The command-line arguments of one worker (after the program)."""
    return ["--rank", str(rank), "--world", str(world), "--init",
            init_method, "--devices", ",".join(map(str, devices)),
            "--quality", str(quality), "--lgwin", str(lgwin), "--timeout",
            str(timeout), str(src), str(dst)]


def launch(commands, timeout):
    """Start every command at once and wait for all. When one exits
    non-zero, end the others (terminate, then kill), which would
    otherwise wait in a collective until their own timeout; the same at
    `timeout` seconds. Returns [(exit code, output)] in order; a process
    that was ended has a negative code."""
    logs = [tempfile.TemporaryFile() for _ in commands]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT)
             for c, f in zip(commands, logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    out = []
    for p, f in zip(procs, logs):
        f.seek(0)
        out.append((p.returncode, f.read().decode(errors="replace")))
        f.close()
    return out


def run(nproc, devices, src, dst, quality=5, lgwin=22, timeout=600,
        prefix=(sys.executable, "-m", "brotli_tpu_torch.tools.mp_compress")
        ):
    """Launch `nproc` workers (each `prefix` + its arguments), check that
    every rank returned the same stream and write it to dst. Raises
    RuntimeError with the failed workers' output."""
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        outs = [pathlib.Path(tmp) / f"rank{r}.br" for r in range(nproc)]
        res = launch([list(prefix) + worker_args(
            r, nproc, init, devices, quality, lgwin, src, outs[r], timeout)
            for r in range(nproc)], timeout)
        bad = [(r, rc, log) for r, (rc, log) in enumerate(res) if rc != 0]
        if bad:
            raise RuntimeError("workers failed:\n" + "\n".join(
                f"rank {r}: exit {rc}\n{log[-2000:]}" for r, rc, log in bad))
        streams = [o.read_bytes() for o in outs]
    if any(s != streams[0] for s in streams):
        raise RuntimeError("the ranks returned different streams")
    pathlib.Path(dst).write_bytes(streams[0])
    return streams[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices", default="cuda:0",
                    help="this process's devices, comma-separated")
    ap.add_argument("--quality", type=int, default=5)
    ap.add_argument("--lgwin", type=int, default=22)
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds before a collective or the launch fails")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    devices = a.devices.split(",")
    if a.rank is None:
        run(a.nproc, devices, a.src, a.dst, a.quality, a.lgwin, a.timeout)
    else:
        worker(a.rank, a.world, a.init, devices, a.quality, a.lgwin, a.src,
               a.dst, a.timeout)


if __name__ == "__main__":
    main()
