"""Matches at the device matcher's 16-byte cap that the host's
_extend_capped took in, a MiB of input (counter match.extend.caphits of
enc/matcher._extend_capped)."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or "match.extend.caphits" not in got[1]:
        return None
    return got[1]["match.extend.caphits"] / S.mib(w)
