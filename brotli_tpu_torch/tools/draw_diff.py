"""PGM image diff (research tool; copy of brotli_tpu.tools.draw_diff;
role parity: research/draw_diff.cc).

Pixels present only in image A render dark gray, only in B light gray,
agreement stays white/black -- the reference's convention for comparing
two backward-reference histograms.
"""

import sys

from .draw_histogram import read_pgm, write_pgm

import numpy as np


def diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    assert a.shape == b.shape, "image dimensions differ"
    ina = a < 128
    inb = b < 128
    out = np.full(a.shape, 255, np.uint8)
    out[ina & inb] = 0
    out[ina & ~inb] = 80    # only in A
    out[~ina & inb] = 170   # only in B
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="diff two PGM histograms")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    out = diff(read_pgm(args.a), read_pgm(args.b))
    write_pgm(args.output, out)
    print(args.output, file=sys.stderr)


if __name__ == "__main__":
    main()
