"""Stream dissector: print the anatomy of a .br stream (copy of
brotli_tpu.tools.dissect over the port's Python decoder).

Role parity: research/brotlidump.py (the reference's independent
bit-level stream dissector used as a debugging oracle). This version
rides the spec-driven Python decoder's trace/structure hooks instead
of re-implementing the bit grammar, and reports per-metablock header
structure, per-category statistics, and an optional per-command dump.

Why hook-based rather than a second bit-grammar parser: a Brotli
dissector cannot stop at headers -- literal-context selection depends
on the last two OUTPUT bytes, so any full dissection must decode the
stream anyway. The reference carries brotlidump.py as an independent
oracle because its production decoder is C; here the spec-driven
Python decoder (dec/decoder.py) IS the independent oracle for the
production native decoder, and the dissector reuses it rather than
duplicating a third decoder. Independence chain: dissect -> Python
decoder -> differentially checked against native (tools/fuzz.py) and
the reference CLI (tests).

Usage: python -m brotli_tpu_torch.tools.dissect [-v] [--bits] FILE.br
"""

import argparse
import collections
import sys

import numpy as np


def dissect(blob: bytes, verbose: bool = False, bits: bool = False,
            out=None):
    """Print the anatomy of `blob` to `out` (None: sys.stdout at the
    call); returns the decoded bytes."""
    from ..dec.decoder import Decoder

    if out is None:
        out = sys.stdout

    d = Decoder()
    d.trace = []
    d.structure = []
    if bits:
        d.field_trace = []
    data = d.decompress(blob)
    if bits:
        # per-field bit dump (the research/brotlidump.py role): every
        # header field and command with its exact bit span
        for (b0, b1, label, value) in d.field_trace:
            v = "" if value is None else f" = {value}"
            print(f"  [{b0:>9}..{b1:<9}] {b1 - b0:>7}b {label}{v}",
                  file=out)
    for i, mb in enumerate(d.structure):
        print(f"metablock {i}: mlen {mb['mlen']}  "
              f"NBLTYPES L/I/D {mb['nbltypes']}  "
              f"NPOSTFIX {mb['npostfix']} NDIRECT {mb['ndirect']}  "
              f"trees lit/dist {mb['n_lit_trees']}/{mb['n_dist_trees']}  "
              f"header {mb['header_bits']} bits", file=out)
    tr = d.trace
    ins = np.array([t[0] for t in tr], np.int64)
    cpy = np.array([t[1] for t in tr], np.int64)
    dist = np.array([t[2] for t in tr], np.int64)
    dc = np.array([t[3] for t in tr], np.int64)

    n = len(data)
    ncmd = len(tr)
    nlit = int(ins.sum())
    cov = int(cpy.sum())
    print(f"stream: {len(blob)} compressed -> {n} bytes "
          f"(ratio {n / max(len(blob), 1):.3f})", file=out)
    print(f"commands: {ncmd}  literals: {nlit}  copy bytes: {cov}",
          file=out)
    if ncmd:
        c = cpy[cpy > 0]
        if len(c):
            print(f"copy lengths: min {c.min()} median "
                  f"{int(np.median(c))} max {c.max()} mean {c.mean():.1f}",
                  file=out)
        kinds = collections.OrderedDict([
            ("implicit dist0 (cell)", int(np.sum(dc == -1))),
            ("ring code 0 (reuse)", int(np.sum(dc == 0))),
            ("ring codes 1-3", int(np.sum((dc >= 1) & (dc < 4)))),
            ("near codes 4-15", int(np.sum((dc >= 4) & (dc < 16)))),
            ("explicit", int(np.sum(dc >= 16))),
            ("final insert-only", int(np.sum(dc == -2))),
        ])
        for k, v in kinds.items():
            print(f"  {k}: {v}", file=out)
        far = dist[dist > 0]
        if len(far):
            print(f"distances: median {int(np.median(far))} "
                  f"max {far.max()}", file=out)
        dict_refs = int(np.sum(dist > np.minimum(
            np.cumsum(np.concatenate([[0], (ins + cpy)[:-1]])),
            (1 << 24) - 16)))
        print(f"  beyond-window (dictionary) refs: ~{dict_refs}",
              file=out)
    if verbose:
        pos = 0
        for (i, c, dd, code, p) in tr:
            tag = {-1: "imp0", -2: "fin"}.get(code, f"d{code}")
            print(f"  @{p:>8} ins={i:<5} cpy={c:<5} dist={dd:<8} {tag}",
                  file=out)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="brotli_tpu_torch.tools.dissect",
        description="print the anatomy of a brotli stream")
    ap.add_argument("file")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="dump every command")
    ap.add_argument("--bits", action="store_true",
                    help="dump every header field and command with "
                         "its exact bit span (brotlidump.py role)")
    args = ap.parse_args(argv)
    with open(args.file, "rb") as f:
        blob = f.read()
    dissect(blob, verbose=args.verbose, bits=args.bits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
