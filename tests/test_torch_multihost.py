"""The port's multi-process encoder (parallel.multihost) and its build
locks, in processes on the CPU.

  (a) compress_sharded_mp in 2 and 4 processes of 8 // N CPU shards
      each, joined by gloo through a file:// store in a fresh temporary
      directory (no fixed port, so parallel test workers cannot clash):
      every rank returns one stream, bit-identical to the port's
      single-process mesh with 8 shards and to the JAX package's
      compress_sharded(n_shards=8) on its 8-device virtual mesh (as
      tests/test_multihost.py checks the JAX package's processes);
  (b) the failure drill: a rank that exits early makes the launcher end
      its peers, which would wait in a collective, with no hang;
  (c) the build locks: two processes that build the native library, or
      the kernels (through a stand-in nvcc), at once on a fresh copy of
      the package compile once and both load.

The workers' matcher buckets shrink to 64/128 KiB, as the parent's and
the JAX package's do.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from brotli_tpu.ops import matcher_jax as MJ
from brotli_tpu.parallel import shard as JS
from brotli_tpu_torch import native
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.parallel import shard as PS
from brotli_tpu_torch.tools import mp_compress
from brotli_tpu_torch.tools.corpus import build_corpus

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUCKETS = "[1 << 16, 1 << 17], 1 << 17"
WORKER = [sys.executable, "-c", (
    f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
    "import torch; torch.set_num_threads(1); "
    "from brotli_tpu_torch.ops import matcher as PM; "
    f"PM._BUCKETS, PM.SEG_BYTES = {BUCKETS}; "
    "from brotli_tpu_torch.tools import mp_compress; mp_compress.main()")]
TIMEOUT = 120


@pytest.fixture(scope="module")
def data():
    """Eight shards of 80,000 bytes, inside the 128 KiB bucket."""
    return build_corpus(1 << 20)[50_000:50_000 + 8 * 80_000]


@pytest.fixture(scope="module")
def single(data):
    """The port's single-process mesh and the JAX package's, 8 shards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (MJ, PM):
            mp.setattr(mod, "_BUCKETS", [1 << 16, 1 << 17])
            mp.setattr(mod, "SEG_BYTES", 1 << 17)
        cpu = torch.device("cpu")
        port = PS._compress_sharded(data, 5, 22, 8, cpu, [cpu] * 8)
        ref = JS.compress_sharded(data, quality=5, n_shards=8)
    torch.set_num_threads(n)
    return port, ref


@pytest.mark.parametrize("nproc", [2, 4])
def test_processes_match_the_mesh_and_jax(tmp_path, data, single, nproc):
    src = tmp_path / "in"
    src.write_bytes(data)
    out = mp_compress.run(nproc, ["cpu"] * (8 // nproc), src,
                          tmp_path / "out", timeout=TIMEOUT, prefix=WORKER)
    port, ref = single
    assert out == port == ref
    assert native.decode(out) == data


def test_failed_rank_is_reaped(tmp_path, data):
    """Rank 1 joins the group and exits with 3; the others, blocked in
    the first all-gather, are ended by the launcher long before their
    collective timeout."""
    src = tmp_path / "in"
    src.write_bytes(data)
    init = f"file://{tmp_path}/store"
    fail = [sys.executable, "-c", (
        "import datetime, sys; import torch.distributed as dist; "
        f"dist.init_process_group('gloo', init_method={init!r}, "
        "world_size=4, rank=1, "
        f"timeout=datetime.timedelta(seconds={TIMEOUT})); sys.exit(3)")]
    cmds = [fail if r == 1 else WORKER + mp_compress.worker_args(
        r, 4, init, ["cpu"] * 2, 5, 22, src, tmp_path / f"out{r}", TIMEOUT)
        for r in range(4)]
    t = time.monotonic()
    res = mp_compress.launch(cmds, TIMEOUT)
    assert time.monotonic() - t < TIMEOUT / 2
    assert res[1][0] == 3, res[1][1][-2000:]
    assert all(rc != 0 for rc, _ in res)
    assert not any((tmp_path / f"out{r}").exists() for r in range(4))


def _package_copy(tmp_path):
    dst = tmp_path / "brotli_tpu_torch"
    shutil.copytree(ROOT / "brotli_tpu_torch", dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst


def _twice(tmp_path, code, env=None):
    """Run `code` in two processes started together, with the package
    copy first on the path; returns their stdout."""
    prog = f"import sys; sys.path.insert(0, {str(tmp_path)!r}); " + code
    procs = [subprocess.Popen([sys.executable, "-c", prog],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(out.decode().strip())
    return outs


def test_native_build_lock(tmp_path):
    """Two processes build the native library at once: one compiles,
    the other waits on the lock and finds it built, and both load it."""
    _package_copy(tmp_path)
    outs = _twice(tmp_path, (
        "from brotli_tpu_torch import native; c = native.build(); "
        "native.get_lib(); print('compiled' if c else 'found')"))
    assert sorted(outs) == ["compiled", "found"]


def test_kernel_build_lock(tmp_path):
    """The same for the kernels, through a stand-in nvcc that writes its
    output slowly: every source compiles once, into its final name, and
    no temporary file is left."""
    pkg = _package_copy(tmp_path)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(log)!r}, 'a').write(out + '\\n')\n"
        "with open(out, 'wb') as f:\n"
        "    f.write(b'half')\n"
        "    f.flush()\n"
        "    time.sleep(0.5)\n"
        "    f.write(b' and the rest')\n")
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}")
    outs = _twice(tmp_path, (
        "from brotli_tpu_torch.ops import kernels; "
        "print(len(kernels.build()))"), env=env)
    from brotli_tpu_torch.ops import kernels
    n = len(kernels.SOURCES)
    assert sorted(outs) == ["0", str(n)]
    assert len(log.read_text().split()) == n
    built = sorted(p.name for p in (pkg / "_build").iterdir())
    assert built == sorted(["build.lock"] +
                           [f"lib{s}.so" for s in kernels.SOURCES])
    assert all((pkg / "_build" / f"lib{s}.so").read_bytes() ==
               b"half and the rest" for s in kernels.SOURCES)
