"""Share (%) of the window's document bytes that the final parse copies
from farther back than SEG_V3 - 16 (counter dp.far_bytes of
ops/optimal._finish, counted once a span when its matches are final): at
the default 4 MiB segment, the bytes only a window wider than lgwin 22's
reaches. Nothing to read from a program that does not count them."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or "dp.far_bytes" not in got[1]:
        return None
    return 100.0 * got[1]["dp.far_bytes"] / sum(w.request_bytes)
