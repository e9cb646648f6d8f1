"""Share (%) of the card's idle time, from the first request span's
start to the last one's end, in which no stage span of the program was
open on any thread (request spans are not stages): the idle time that
the host metrics do not account for."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None:
        return None
    return S.idle_unspanned_share(got[0], w.device_ops)
