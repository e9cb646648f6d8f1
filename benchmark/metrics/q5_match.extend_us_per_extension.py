"""Host microseconds a cap-hit match extended: the spans match.extend
of ops/matcher over the counter match.extend.extensions of
enc/matcher._extend_capped (the cap hits an earlier extension swallowed
cost their share too)."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or not got[1].get("match.extend.extensions"):
        return None
    sp, counts = got
    return 1e6 * S.seconds(sp, "match.extend") / \
        counts["match.extend.extensions"]
