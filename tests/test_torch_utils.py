"""The port's utilities against the JAX package's, on the CPU: the table
generator (native/gen_tables.py), the validated parameter surface
(params.py), the platform report (utils/platform.py), the profiler seam
(utils/trace.device_profile) and the differential decoder fuzzer
(tools/fuzz.py)."""

import json
import pathlib
import time

import pytest
import torch

from brotli_tpu import params as JP
from brotli_tpu_torch import params as PP
from brotli_tpu_torch.native import gen_tables
from brotli_tpu_torch.tools import fuzz
from brotli_tpu_torch.tools.corpus import build_corpus
from brotli_tpu_torch.utils import platform, trace

REPO = pathlib.Path(__file__).resolve().parent.parent
TEXT = build_corpus(1 << 20)[400_000:460_000]


def test_gen_tables_gives_the_committed_header(tmp_path, capsys):
    """Into tmp_path, never over the committed header; byte for byte the
    port's header and the JAX package's."""
    header = REPO / "brotli_tpu_torch" / "native" / "btpu_tables.h"
    before = header.read_bytes()
    out = tmp_path / "btpu_tables.h"
    assert gen_tables.main([str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    assert out.read_bytes() == before == \
        (REPO / "brotli_tpu" / "native" / "btpu_tables.h").read_bytes()
    assert header.read_bytes() == before


_BAD = {
    "mode": dict(mode=3),
    "quality high": dict(quality=12),
    "quality low": dict(quality=-1),
    "quality float": dict(quality=5.0),
    "lgwin": dict(lgwin=25),
    "lgwin small": dict(lgwin=9),
    "lgwin large": dict(lgwin=31, large_window=True),
    "lgblock": dict(lgblock=25),
    "lgblock small": dict(lgblock=15),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_params_errors_match_jax(case):
    with pytest.raises(ValueError) as got:
        PP.EncoderParams(**_BAD[case]).validate()
    with pytest.raises(ValueError) as want:
        JP.EncoderParams(**_BAD[case]).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(quality=0, lgwin=0),
                                dict(quality=5, lgwin=26,
                                     large_window=True),
                                dict(mode=1, quality=9, lgblock=16)])
def test_params_sanitize_and_compress_with(kw):
    p, j = PP.EncoderParams(**kw), JP.EncoderParams(**kw)
    assert p.sanitize().__dict__ == j.sanitize().__dict__
    if p.quality < 10:  # the native route of both packages
        assert PP.compress_with(p, TEXT) == JP.compress_with(j, TEXT)
    assert [int(m) for m in PP.Mode] == [int(m) for m in JP.Mode]
    assert [m.name for m in PP.EncoderParameter] == \
        [m.name for m in JP.EncoderParameter]


def test_platform_info():
    rep = platform.info()
    assert {"python", "torch", "cuda", "cuda_available", "devices",
            "native_runtime", "kernels_built", "routes"} <= rep.keys()
    assert rep["native_runtime"] is True
    assert rep["torch"] == torch.__version__
    assert rep["cuda_available"] == torch.cuda.is_available()
    assert set(rep["kernels_built"]) <= set(
        __import__("brotli_tpu_torch.ops.kernels",
                   fromlist=["k"]).SOURCES)
    json.dumps(rep)


@pytest.mark.parametrize("kw,msg", [
    (dict(encoder="gpu"), "encoder must be auto|native|device|python"),
    (dict(decoder="c"), "decoder must be native|python|device"),
    (dict(serializer="host"), "serializer must be native|python|device"),
    (dict(dp="v1"), "dp must be a DPConfig"),
    (dict(backend="jax"), "backend must be auto|numpy")])
def test_configure_refuses_unknown_values(kw, msg):
    with pytest.raises(ValueError, match=msg):
        platform.configure(**kw)


def test_configure_returns_the_report(monkeypatch):
    import os
    from brotli_tpu_torch import DPConfig
    env = dict(os.environ)
    rep = platform.configure(encoder="device", decoder="python",
                             serializer="python", dp=DPConfig(mode="v1"),
                             backend="numpy")
    assert rep["config"]["encoder"] == "device"
    assert rep["config"]["backend"] == "numpy"
    assert "host DP" in rep["routes"]["q10-q11"]
    assert "v1" in rep["config"]["dp"]
    assert dict(os.environ) == env  # it sets no variable


def test_device_profile_writes_a_trace(tmp_path):
    path = tmp_path / "trace.json"
    with trace.device_profile(str(path)) as prof:
        torch.arange(1 << 16).cumsum(0)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_fuzz_corpus_mode():
    """tools/fuzz.py's corpus mode (--replay) over tests/fuzz_corpus/:
    the port's Python decoder against its native decoder, in one shot
    and in chunks, in under a minute, with no disagreement."""
    t = time.perf_counter()
    stats = fuzz.replay(REPO / "tests" / "fuzz_corpus")
    assert time.perf_counter() - t < 60
    assert stats["files"] == 102
    assert stats["accept"] + stats["reject"] == 102
    assert stats["accept"] and stats["reject"]


def test_fuzz_seeded_mutations(tmp_path):
    """A short seeded run of mutated and random streams, saving nothing
    into the committed corpus (its new inputs go to tmp_path)."""
    stats = fuzz.run(iters=120, seed=3, save=tmp_path)
    assert stats["accept"] + stats["reject"] == 120
    assert not (tmp_path / "crashes").exists()
    assert fuzz.main(["--iters", "8", "--save", ""]) == 0
