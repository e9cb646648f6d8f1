"""Static-dictionary hits the q11 DP's probe kept, a MiB of the input it
probed (counters dp.dict-probe.hits and dp.dict-probe.bytes of
ops/optimal._dict_probe_global, counted once a probe: a 16 MiB request
probes its first 4 MiB early and then all 16 MiB, 20 MiB in all). The
probe keeps no hits at all past its cap of one per 8 bytes, 131,072 a
MiB (a dropped probe counts in dp.dict-probe.overflows), so the reading
against 131,072 is how close the traffic comes to that rule; fewer hits
are also fewer dictionary edges for the DP's segments to carry."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or not got[1].get("dp.dict-probe.bytes"):
        return None
    return got[1].get("dp.dict-probe.hits", 0) / (
        got[1]["dp.dict-probe.bytes"] / (1 << 20))
