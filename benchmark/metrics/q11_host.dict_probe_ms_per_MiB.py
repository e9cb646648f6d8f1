"""Host ms of the q11 DP's static-dictionary probe (stage dp.dict-probe
of ops/optimal) a MiB of input."""

from benchmark.core import stage_ms_per_mib


def read(w):
    return stage_ms_per_mib(w, "dp.dict-probe")
