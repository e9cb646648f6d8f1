"""benchmark.run end to end on the CPU at a small size: no card means no
result; a sound run is correct; every fault the cell can have, and the
control that breaks the configured window, makes `correct` false."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import core, run


def test_run_fails_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "q11_w22.bulk16m", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=core.ROOT, env=env, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


@pytest.fixture
def small(monkeypatch):
    """A cell cut to 300 KB documents, with the program's segments and
    buckets shrunk so its plain versions run on the CPU."""
    from brotli_tpu_torch.ops import matcher as M
    from brotli_tpu_torch.ops import optimal as O
    monkeypatch.setattr(O, "SEG_V3", 1 << 16)
    monkeypatch.setattr(O, "BUCKETS_V3", [1 << 16])
    monkeypatch.setattr(M, "_BUCKETS", [1 << 16, 1 << 17])
    monkeypatch.setattr(M, "SEG_BYTES", 1 << 17)

    def cut(workload):
        cell = core.cell(core.spec(), workload)
        cell["traffic_file"]["params"]["doc_bytes"] = 300_000
        cell["config_file"]["warmup_bytes"] = 70_000
        return cell
    return cut


def _run(cell, fault=None, trace=False, seconds=0.2):
    r = run.run(cell, 2 ** 31 + 7, seconds, trace, fault=fault,
                device="cpu")
    json.dumps(r)  # the result line is JSON
    assert list(r)[-2:] == ["warnings", "checks"]
    return r


def test_sound_q5_run_is_correct_and_reports_its_metrics(small):
    r = _run(small("q5_w22.logs16m"))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"encode_MBps", "ratio", "peak_device_GiB",
                                 "setup_s"}
    assert r["checks"] == {"wrong_streams": {"value": 0, "limit": 0},
                           "wrong_window": {"value": 0, "limit": 0}}
    r = _run(small("q5_w22.logs16m"), trace=True)
    assert r["correct"]
    assert {"q5_match.extend_ms_per_MiB", "serialize_ms_per_MiB"} <= \
        set(r["metrics"])
    assert {"device_ops", "idle_gaps"} == set(r["breakdown"])


@pytest.mark.parametrize("fault,check", [
    ("identity", "wrong_streams"),  # a step returns its input unchanged
    ("half", "wrong_streams"),      # half of the request left out
    ("lossy", "wrong_streams"),     # a byte altered where it is produced
    ("window", "wrong_window"),     # the control: another window declared
])
def test_each_fault_makes_the_q5_run_incorrect(small, fault, check):
    r = _run(small("q5_w22.logs16m"), fault=fault, seconds=0.05)
    assert not r["correct"]
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


@pytest.mark.parametrize("fault", [None, "lossy", "window"])
def test_q11_run_and_its_control(small, fault):
    r = _run(small("q11_w22.bulk16m"), fault=fault, seconds=0.01)
    assert r["correct"] == (fault is None)
