"""Host ms a MiB of document in the dcb route's DP passes: the union of
the program's stage spans named dp.* and dcb.* (the seed parse of the
document after its dictionary, dcb.seed; the probe, cost tables, segment
prep, dispatch, fetch, collect, span split and dictionary post-pass;
the lift to compound references, dcb.lift) on any thread."""

from benchmark import spans as S
from benchmark.core import device_intervals_union


def read(w):
    got = S.window()
    if got is None:
        return None
    dp = [(a, b) for n, a, b in S.stages(got[0])
          if n.startswith(("dp.", "dcb."))]
    if not any(n.startswith("dcb.") for n, _, _ in S.stages(got[0])):
        return None
    return 1e3 * device_intervals_union(dp) / S.mib(w)
