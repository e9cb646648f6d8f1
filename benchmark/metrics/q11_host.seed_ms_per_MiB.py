"""Host ms of the q11 DP's native seed parses (stages dp.seed and
dp.seed1 of ops/optimal) a MiB of input."""

from benchmark.core import stage_ms_per_mib


def read(w):
    return stage_ms_per_mib(w, "dp.seed", "dp.seed1")
