"""Share (%) of the final parse's far bytes (counter dp.far_bytes: copies
from farther back than SEG_V3 - 16) that the seed parse does not copy
from the same distance (counter dp.far_seed_bytes): the far bytes that
only the DP's candidates over each segment's halo gave. Nothing to read
from a program that does not count them, or without far bytes."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or not got[1].get("dp.far_bytes") or \
            "dp.far_seed_bytes" not in got[1]:
        return None
    far = got[1]["dp.far_bytes"]
    return 100.0 * (far - got[1]["dp.far_seed_bytes"]) / far
