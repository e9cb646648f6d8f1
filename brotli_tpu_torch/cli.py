"""Command-line interface of the port, flag-compatible subset of the
reference `brotli` tool (parity anchor: c/tools/brotli.c
ParseParams/main); a copy of brotli_tpu.cli over the port's API.
Compressing at -q 10/11 a file of 256 KiB or more runs on the card, and
so do the match finders of the Python pipeline (--base64, -D with a
serialized dictionary of custom words) on 64 KiB or more.

Usage: python -m brotli_tpu_torch.cli [OPTIONS] [FILES]
"""

import argparse
import os
import sys

from . import Compressor, compress, decompress


def _build_parser():
    p = argparse.ArgumentParser(
        prog="brotli_tpu_torch",
        description="brotli compressor/decompressor on PyTorch and CUDA")
    p.add_argument("files", nargs="*", help="files (default: stdin)")
    p.add_argument("-c", "--stdout", action="store_true",
                   help="write to standard output")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-t", "--test", action="store_true",
                   help="test compressed file integrity")
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite existing output files")
    p.add_argument("-k", "--keep", action="store_true", default=True,
                   help="keep source files (default)")
    p.add_argument("--rm", action="store_true", help="remove source files")
    p.add_argument("-K", "--concatenated", action="store_true",
                   help="decompress concatenated streams (brcat)")
    p.add_argument("-q", "--quality", type=int, default=11,
                   help="compression level (0-11)")
    p.add_argument("-w", "--lgwin", type=int, default=22,
                   help="log2 of window size (10-24), 0 for auto")
    p.add_argument("-o", "--output", help="output file (single input)")
    p.add_argument("-S", "--suffix", default=".br",
                   help="compressed file suffix")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("-Z", "--best", action="store_true",
                   help="use best compression level (q=11)")
    p.add_argument("-D", "--dictionary", metavar="FILE",
                   help="raw LZ77 dictionary file (both directions)")
    p.add_argument("--large_window", type=int, default=0, metavar="N",
                   help="enable large window (lgwin up to 30)")
    p.add_argument("-n", "--no-copy-stat", action="store_true",
                   help="do not copy source file times/permissions")
    p.add_argument("-j", dest="rm", action="store_true",
                   help="remove source files (alias of --rm)")
    p.add_argument("--comment", metavar="STR",
                   help="compress: embed STR as a metadata block; "
                        "decompress: verify the stream carries STR")
    p.add_argument("-s", "--squash", action="store_true",
                   help="discard output larger than input (keep source)")
    p.add_argument("--base64", action="store_true",
                   help="detect base64 payload regions (flat 6-bit code)")
    return p


_SIMPLE_FLAGS = set("cdtfkKvVZnjs")


def _expand_argv(argv):
    """Coalesced simple options + digit quality shorthand (parity:
    c/tools/brotli.c:334 'Simple / coalesced options', e.g. '-9kf' ==
    '-q 9 -k -f')."""
    out = []
    for a in argv:
        if (len(a) > 1 and a[0] == "-" and a[1] != "-" and
                all(ch.isdigit() or ch in _SIMPLE_FLAGS
                    for ch in a[1:]) and
                (any(ch.isdigit() for ch in a[1:]) or len(a) > 2)):
            digits = "".join(ch for ch in a[1:] if ch.isdigit())
            if digits:
                out += ["-q", digits]
            out += [f"-{ch}" for ch in a[1:] if not ch.isdigit()]
        else:
            out.append(a)
    return out


def _process(data: bytes, args) -> bytes:
    raw_dict = None
    if args.dictionary:
        with open(args.dictionary, "rb") as f:
            raw_dict = f.read()
    if args.decompress or args.test:
        if args.comment:
            _verify_comment(data, args.comment)
        if args.concatenated:
            from . import decompress_concatenated
            return decompress_concatenated(data)
        return decompress(data, dictionary=raw_dict,
                          large_window=bool(args.large_window))
    lgwin = args.lgwin if args.lgwin else 22
    if args.large_window:
        lgwin = max(lgwin, min(args.large_window, 30))
    if args.comment:
        from . import Compressor
        c = Compressor(quality=11 if args.best else args.quality,
                       lgwin=lgwin)
        out = c.emit_metadata(args.comment.encode())
        c.process(data)
        return out + c.finish()
    return compress(data, quality=11 if args.best else args.quality,
                    lgwin=lgwin, dictionary=raw_dict,
                    large_window=bool(args.large_window),
                    base64_mode=args.base64)


def _verify_comment(data: bytes, comment: str) -> None:
    from .dec.decoder import Decoder
    seen = []
    d = Decoder()
    d.metadata_callback = seen.append
    d.decompress_prefix(data)
    if comment.encode() not in seen:
        raise ValueError("comment mismatch")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = _build_parser().parse_args(_expand_argv(list(argv)))
    if args.squash and args.stdout:
        print("--squash cannot combine with --stdout", file=sys.stderr)
        return 1
    if args.version:
        from . import __version__
        print(f"brotli_tpu_torch {__version__}")
        return 0
    prog = os.path.basename(sys.argv[0] or "")
    if prog in ("unbrotli",):
        args.decompress = True
    if prog in ("brcat",):
        args.decompress = args.stdout = True
        args.concatenated = True

    if not args.files:
        data = sys.stdin.buffer.read()
        out = _process(data, args)
        if not args.test:
            sys.stdout.buffer.write(out)
        return 0

    rc = 0
    for path in args.files:
        try:
            with open(path, "rb") as f:
                data = f.read()
            out = _process(data, args)
            if args.test:
                if args.verbose:
                    print(f"{path}: OK", file=sys.stderr)
                continue
            if args.stdout:
                sys.stdout.buffer.write(out)
                continue
            if args.output:
                dst = args.output
            elif args.decompress:
                if not path.endswith(args.suffix):
                    print(f"skipping {path}: unknown suffix",
                          file=sys.stderr)
                    rc = 1
                    continue
                dst = path[:-len(args.suffix)]
            else:
                dst = path + args.suffix
            if os.path.exists(dst) and not args.force:
                print(f"{dst} already exists (use -f to overwrite)",
                      file=sys.stderr)
                rc = 1
                continue
            if args.squash and not args.decompress and \
                    len(out) >= len(data):
                # reject_uncompressible: keep the source, no output
                if args.verbose:
                    print(f"{path}: output larger than input, skipped",
                          file=sys.stderr)
                continue
            with open(dst, "wb") as f:
                f.write(out)
            if not args.no_copy_stat:
                # copy permissions & times like the reference CLI
                st = os.stat(path)
                os.utime(dst, (st.st_atime, st.st_mtime))
                os.chmod(dst, st.st_mode)
            if args.verbose:
                pct = 100.0 * len(out) / max(len(data), 1)
                print(f"{path} -> {dst} ({pct:.1f}%)", file=sys.stderr)
            if args.rm:
                os.unlink(path)
        except Exception as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
