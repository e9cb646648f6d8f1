"""Host ms of the device matcher's extension of cap-hit matches (stage
match.extend of ops/matcher, _extend_capped) a MiB of input."""

from benchmark.core import stage_ms_per_mib


def read(w):
    return stage_ms_per_mib(w, "match.extend")
