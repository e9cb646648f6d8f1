"""Host ms of the device matcher's static-dictionary post-pass (stage
match.dict-post of ops/matcher) a MiB of input."""

from benchmark.core import stage_ms_per_mib


def read(w):
    return stage_ms_per_mib(w, "match.dict-post")
