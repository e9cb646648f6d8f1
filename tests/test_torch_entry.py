"""The port's entry module (brotli_tpu_torch/entry.py) against the JAX
package's __graft_entry__.py, on the CPU, and the mesh DP's segments.

  (a) `entry(device="cpu")`: the JAX entry's (count, packed) exactly;
  (b) `dryrun_multichip(8, device="cpu")` over [cpu] * 8: the JAX dry
      run's matches total, histogram total and both sharded streams on
      the 8-device CPU mesh of tests/conftest.py (its streams recorded
      through a wrapper over brotli_tpu.parallel.shard.compress_sharded,
      nothing in the package edited), each decoding;
  (c) the mesh DP runs only the shards' real segments: a spy on
      ops.optimal.dp_v3_segment during (b)'s q11 encode counts exactly
      the segments the shards' buffers hold (23, where the JAX mesh's
      one program also runs a zero segment for the first shard: 24);
  (d) the modules of the last slice import neither jax nor brotli_tpu.

The JAX dry run takes ~25 s and the port's on one thread ~70 s here:
both run once, in module fixtures.
"""

import ast
import contextlib
import io
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as JE
from brotli_tpu.parallel import shard as JS
from brotli_tpu_torch import entry as PE
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.ops import optimal as O

REPO = pathlib.Path(__file__).resolve().parent.parent
NEW_MODULES = ("brotli_tpu_torch.entry", "brotli_tpu_torch.tools.stress",
               "brotli_tpu_torch.tools.dissect",
               "brotli_tpu_torch.tools.replay",
               "brotli_tpu_torch.enc.bitstream")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_serializer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax():
    fn, args = PE.entry("cpu")
    count, packed, err = fn(*args)
    jfn, jargs = JE.entry()
    jcount, jpacked = jax.jit(jfn)(*jargs)
    assert int(err) == 0
    assert int(count) == int(jcount) > 0
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpacked).astype(np.int64))


@pytest.fixture(scope="module")
def jax_dryrun():
    """The JAX dry run's printed numbers and its two sharded streams."""
    assert len(jax.devices()) == 8
    streams = []

    def recording(*a, **k):
        streams.append(real(*a, **k))
        return streams[-1]

    real = JS.compress_sharded
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "compress_sharded", recording)
        with contextlib.redirect_stdout(out):
            JE.dryrun_multichip(8)
    text = out.getvalue()
    m = re.search(r"(\d+) matches, hist total (\d+)", text)
    return {"matches": int(m.group(1)), "hist_total": int(m.group(2)),
            "q5": streams[0], "q11": streams[1]}


@pytest.fixture(scope="module")
def port_dryrun():
    """The port's dry run on [cpu] * 8, with a spy counting the mesh
    DP's segments."""
    calls = []

    def spy(*a, **k):
        calls.append(int(a[1]))  # npos
        return real(*a, **k)

    real = O.dp_v3_segment
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(O, "dp_v3_segment", spy)
        with contextlib.redirect_stdout(out):
            res = PE.dryrun_multichip(8, "cpu")
    return res, calls, out.getvalue()


def test_dryrun_multichip_matches_jax(port_dryrun, jax_dryrun):
    res, _, text = port_dryrun
    for k in ("matches", "hist_total"):
        assert res[k] == jax_dryrun[k] > 0
    assert res["q5"] == jax_dryrun["q5"]
    assert res["q11"] == jax_dryrun["q11"]
    assert f"{res['matches']} matches, hist total {res['hist_total']}" \
        in text


def test_dryrun_streams_decode(port_dryrun):
    res, _, _ = port_dryrun
    words = PN.decode(res["q5"])
    assert len(words) == 1_181_930
    assert PN.decode(res["q11"]) == (words * 8)[:8 * PE.BLOCK + (1 << 14)]


def test_mesh_dp_runs_only_real_segments(port_dryrun):
    _, calls, _ = port_dryrun
    n = 8 * PE.BLOCK + (1 << 14)
    bounds = np.linspace(0, n, 9).astype(np.int64)
    bufs = [int(bounds[i + 1] - bounds[i]) + min(int(bounds[i]), PE.BLOCK)
            for i in range(8)]
    real = sum(-(-b // PE.BLOCK) for b in bufs)
    rounds = max(-(-b // PE.BLOCK) for b in bufs)
    assert (real, 8 * rounds) == (23, 24)
    assert len(calls) == real and all(npos > 0 for npos in calls)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_no_jax(module):
    path = REPO / (module.replace(".", "/") + ".py")
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "brotli_tpu")
    code = (f"import sys, {module}; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'jaxlib', 'brotli_tpu')]; print(bad); "
            f"sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
