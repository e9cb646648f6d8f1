"""Backward-reference visualization (research tool; copy of
brotli_tpu.tools.draw_histogram).

Role parity: research/draw_histogram.cc -- reads `position distance
[length]` records and renders a PGM histogram image: x = stream
position, y = backward distance on a log^2 scale (the reference's
DistanceTransform), pixel intensity through the same arc-shaped
density transform. Vectorized: one histogram2d replaces the
per-record accumulation loop.
"""

import sys

import numpy as np


def read_records(path: str, with_copies: bool = True):
    rec = np.loadtxt(path, dtype=np.int64, ndmin=2)
    if rec.size == 0:
        return (np.zeros(0, np.int64),) * 3
    pos = rec[:, 0]
    dist = rec[:, 1]
    cols = rec.shape[1]
    ln = rec[:, 2] if (with_copies and cols > 2) else np.ones_like(pos)
    return pos, dist, ln


def render(pos, dist, ln, width=800, height=600, size=None,
           min_distance=1, max_distance=1 << 30, linear=False,
           simple=False):
    """uint8[height, width] histogram image."""
    if size is None:
        size = int(pos.max()) + 1 if len(pos) else 1
    keep = (dist >= min_distance) & (dist < max_distance) & (dist > 0)
    pos, dist, ln = pos[keep], dist[keep], ln[keep]
    img = np.zeros((height, width), np.float64)
    if len(pos) == 0:
        return np.full((height, width), 255, np.uint8)

    def dist_t(x):
        return x if linear else np.log(x) ** 2

    dmax = dist_t(float(max(dist.max(), 2)))
    x = np.minimum((pos * width) // max(size, 1), width - 1)
    y = np.minimum((dist_t(dist.astype(np.float64)) * height / dmax),
                   height - 1).astype(np.int64)
    np.add.at(img, (y, x), ln.astype(np.float64))
    if simple:
        out = np.where(img > 0, 0, 255).astype(np.uint8)
    else:
        mx = img.max()
        norm = np.where(img > 0, img / mx, 0.0)
        val = 255.0 * np.sqrt(norm)  # density emphasis
        z = 255.0 - val
        val = np.sqrt(np.maximum(255.0 * 255.0 - z * z, 0.0))
        out = (255 - val).astype(np.uint8)
    return out[::-1]  # distance axis grows upward


def write_pgm(path: str, img: np.ndarray) -> None:
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P5"
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        assert int(f.readline()) == 255
        return np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="backward-reference histogram (research tool)")
    ap.add_argument("input", help="records: position distance [length]")
    ap.add_argument("output", help="PGM image")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--min_distance", type=int, default=1)
    ap.add_argument("--max_distance", type=int, default=1 << 30)
    ap.add_argument("--linear", action="store_true")
    ap.add_argument("--simple", action="store_true")
    ap.add_argument("--no-copies", dest="copies", action="store_false")
    args = ap.parse_args(argv)
    pos, dist, ln = read_records(args.input, args.copies)
    img = render(pos, dist, ln, args.width, args.height, args.size,
                 args.min_distance, args.max_distance, args.linear,
                 args.simple)
    write_pgm(args.output, img)
    print(f"{args.output}: {img.shape[1]}x{img.shape[0]}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
