"""One `dcb` parse under both serializers: the card route's matches for
an input compressed against a raw dictionary (`compress(...,
dictionary=old, encoder="device")`), written by the native serializer
(the route's own stream) and by the Python serializer with and without
its NPOSTFIX/NDIRECT search, beside the Python pipeline's stream
(`encoder="python"`: its own parse of dictionary and input, then the
Python serializer with the search). Each stream is decoded with the
dictionary by the native decoder and must give the input back.

The route's matches are taken from the spans it hands the native
serializer (native.serialize_region); the Python serializer writes them
in one pass over dictionary and input, as the Python pipeline writes
its own (literal context from the input's start on).

Usage, from the repository root on a machine with a card (pairs of
older and newer file, e.g. the benchmark's `versions` traffic):
    python3 -m brotli_tpu_torch.tools.dcb_serializers OLD NEW [OLD NEW ...]
        [--quality 11] [--lgwin 22] [--no-pipeline]
"""

import argparse
import pathlib
import time

import numpy as np

import brotli_tpu_torch as bt
from brotli_tpu_torch import native
from brotli_tpu_torch.enc import bitstream, encoder as PE
from brotli_tpu_torch.format.bitio import BitWriter
from brotli_tpu_torch.format import constants as C


def route_matches(doc, dic, quality, lgwin, device=None):
    """(stream, matches): the card route's stream, and its spans'
    (pos, len, dist, flag) arrays laid end to end, in the input's
    positions."""
    spans = []
    keep = native.serialize_region

    def spy(data, lo, hi, matches, *args, **kw):
        spans.append([np.asarray(a, np.int64) for a in matches])
        return keep(data, lo, hi, matches, *args, **kw)
    native.serialize_region = spy
    try:
        out = bt.compress(doc, quality=quality, lgwin=lgwin, dictionary=dic,
                          encoder="device", device=device)
    finally:
        native.serialize_region = keep
    return out, tuple(np.concatenate([s[i] for s in spans])
                      for i in range(4))


def python_serialized(doc, dic, matches, quality, lgwin, search=True):
    """The Python serializer's stream of `matches` (input positions,
    stream distances, flag 1 into the dictionary), with or without the
    NPOSTFIX/NDIRECT search (without: NPOSTFIX 0 and NDIRECT 0, as the
    native serializer writes)."""
    D, n = len(dic), len(doc)
    arr = np.frombuffer(dic + doc, np.uint8)
    m, lens, dists, flags = matches
    lgblock = PE._sanitize_params(quality, lgwin, 0, False)[2]
    keep = bitstream.choose_distance_params
    if not search:
        bitstream.choose_distance_params = lambda expl: (0, 0)
    try:
        bw = BitWriter()
        bitstream.write_stream_header(bw, lgwin)
        PE._write_blocks(bw, arr, D, D + n, (m + D, lens, dists, flags),
                         lgblock, is_last=True, quality=quality,
                         ctx_floor=D)
        bw.align_to_byte()
    finally:
        bitstream.choose_distance_params = keep
    return bw.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+", help="pairs: OLD NEW ...")
    ap.add_argument("--quality", type=int, default=11)
    ap.add_argument("--lgwin", type=int, default=22)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="leave out the Python pipeline's own stream")
    args = ap.parse_args(argv)
    if len(args.files) % 2:
        ap.error("files come in pairs: OLD NEW")
    q, w = args.quality, args.lgwin
    print(f"quality {q}, lgwin {w}, max distance "
          f"{C.max_backward_distance(w)}")
    for old, new in zip(args.files[::2], args.files[1::2]):
        dic = pathlib.Path(old).read_bytes()
        doc = pathlib.Path(new).read_bytes()
        t0 = time.perf_counter()
        stream, matches = route_matches(doc, dic, q, w)
        t1 = time.perf_counter()
        rows = {"card route, native serializer": stream,
                "card route's parse, Python serializer": python_serialized(
                    doc, dic, matches, q, w),
                "card route's parse, Python serializer, no search":
                    python_serialized(doc, dic, matches, q, w, search=False)}
        if not args.no_pipeline:
            rows["Python pipeline"] = bt.compress(
                doc, quality=q, lgwin=w, dictionary=dic, encoder="python")
        t2 = time.perf_counter()
        print(f"{pathlib.Path(new).name} ({len(doc)} B) against "
              f"{pathlib.Path(old).name} ({len(dic)} B): "
              f"{len(matches[0])} matches, "
              f"{int((matches[3] == 1).sum())} into the dictionary; "
              f"route {t1 - t0:.2f} s, the rest {t2 - t1:.2f} s")
        for label, out in rows.items():
            ok = native.decode(out, compound=dic) == doc
            print(f"    {label}: {len(out)} B, decodes: {ok}")
            if not ok:
                raise SystemExit(f"dcb_serializers: {label} does not "
                                 f"decode")


if __name__ == "__main__":
    main()
