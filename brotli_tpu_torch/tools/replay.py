"""Parse-replay harness (copy of brotli_tpu.tools.replay over the
port's Python decoder and native serializer): re-emit an EXISTING
brotli stream's parse through this framework's serializer and compare
sizes.

Splits a size gap versus the reference encoder into its two causes:
  * emission gap  -- same parse, different entropy coding / splits /
    context maps (our serializer vs the reference's)
  * parse gap     -- whatever remains of the end-to-end difference

Usage:
  python -m brotli_tpu_torch.tools.replay FILE [-q N] [-w N]
prints: ref size, replay size (ref parse + our emitter), our size. It
needs the reference CLI at build/ref/brotli; without it, it exits
with a message.
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np

REF_CLI = pathlib.Path(__file__).resolve().parents[2] / \
    "build" / "ref" / "brotli"


def parse_stream(blob: bytes, max_distance: int):
    """Decode `blob`, returning (output, match arrays) where matches
    are (pos, len, dist, flag) in this framework's serializer
    convention: flag 0 = LZ copy (len = copy length), 2000 + symbol
    copy length = static-dict word (len = OUTPUT advance, dist
    verbatim). A distance beyond min(pos, max_distance), the stream's
    window, is a static-dictionary reference."""
    from ..dec.decoder import Decoder
    d = Decoder()
    d.trace = []
    out = d.decompress(blob)
    n = len(out)
    tr = d.trace
    m, lens, dists, flags = [], [], [], []
    for i, (ins, cpy, dist, dcode, pos) in enumerate(tr):
        if cpy == 0:
            continue
        if i + 1 < len(tr):
            nins, _, _, _, npos = tr[i + 1]
            adv = (npos - nins) - pos
        else:
            adv = n - pos
        m.append(pos)
        dists.append(dist)
        if dist > min(pos, max_distance):  # static-dictionary reference
            lens.append(adv)
            flags.append(2000 + cpy)
        else:
            assert adv == cpy, (adv, cpy, pos)
            lens.append(cpy)
            flags.append(0)
    return bytes(out), (np.asarray(m, np.int64), np.asarray(lens, np.int64),
                        np.asarray(dists, np.int64),
                        np.asarray(flags, np.int64))


def replay(data: bytes, ref_blob: bytes, quality: int = 11,
           lgwin: int = 22) -> bytes:
    """Re-emit ref_blob's parse through the native serializer."""
    from ..format import constants as C
    from .. import native
    out, matches = parse_stream(ref_blob, C.max_backward_distance(lgwin))
    if out != data:
        raise ValueError("the stream does not decode to the data")
    blob, _ring = native.serialize_region(
        data, 0, len(data), matches, quality, lgwin,
        write_header=True, is_last=True, align_end=True)
    return blob


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="brotli_tpu_torch.tools.replay")
    ap.add_argument("file", type=pathlib.Path)
    ap.add_argument("-q", type=int, default=11)
    ap.add_argument("-w", type=int, default=22)
    args = ap.parse_args(argv)
    if not REF_CLI.exists():
        sys.exit(f"replay: the reference CLI {REF_CLI} is missing (it "
                 f"encodes the stream whose parse is replayed)")
    import brotli_tpu_torch
    data = args.file.read_bytes()
    ref = subprocess.run(
        [str(REF_CLI), "-q", str(args.q), "-w", str(args.w), "-c"],
        input=data, capture_output=True).stdout
    rb = replay(data, ref, args.q, args.w)
    # validate through the reference CLI
    rt = subprocess.run([str(REF_CLI), "-d", "-c"], input=rb,
                        capture_output=True)
    if rt.returncode != 0 or rt.stdout != data:
        sys.exit("replay: the replayed stream does not decode")
    ours = brotli_tpu_torch.compress(data, quality=args.q, lgwin=args.w)
    print(f"{args.file.name}: ref {len(ref)} | replay(ref parse + our "
          f"emitter) {len(rb)} ({(len(rb)-len(ref))*8:+d} bits emission)"
          f" | ours {len(ours)} (parse gap "
          f"{(len(ours)-len(rb))*8:+d} bits)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
