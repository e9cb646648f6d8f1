"""Host ms of the native serializer (stage serialize; on the q11 route it
runs on a worker thread beside the DP) a MiB of input."""

from benchmark.core import stage_ms_per_mib


def read(w):
    return stage_ms_per_mib(w, "serialize")
