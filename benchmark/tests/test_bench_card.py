"""One short run of each cell on the card, through the command the
benchmark's checks run; skips on a machine without a CUDA device."""

import json
import subprocess
import sys

import pytest

from benchmark import core


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      core.spec()["workloads"]])
def test_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=core.ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
