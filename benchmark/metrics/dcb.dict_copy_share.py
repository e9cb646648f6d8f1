"""Share (%) of the window's document bytes that compound references
copy from the request's raw dictionary (counter dcb.copy_bytes of
ops/optimal.lift_compound, counted once a span when its matches are
final)."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or "dcb.copy_bytes" not in got[1]:
        return None
    return 100.0 * got[1]["dcb.copy_bytes"] / sum(w.request_bytes)
