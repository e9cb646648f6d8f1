"""Generate btpu_tables.h from the format layer (single source of truth:
the Python format modules; nothing is copied from the reference). Copy
of brotli_tpu.native.gen_tables over the port's format modules.

Usage: python -m brotli_tpu_torch.native.gen_tables [OUT]
(OUT defaults to btpu_tables.h beside this file).
"""

import pathlib
import sys

from ..format import constants as C
from ..format import context, dictionary, prefix, transforms


def fmt_bytes(b):
    return ", ".join(str(x) for x in b)


def tables() -> str:
    """The header's text."""
    out = ["/* GENERATED by gen_tables.py -- do not edit. */", ""]
    # context LUTs: 4 modes x 512
    rows = []
    for mode in range(4):
        l0, l1 = context.context_lut(mode)
        rows.append(fmt_bytes(l0))
        rows.append(fmt_bytes(l1))
    out.append("static const uint8_t kContextLut[4][512] = {")
    for m in range(4):
        out.append("  {" + rows[2 * m] + ",")
        out.append("   " + rows[2 * m + 1] + "},")
    out.append("};")

    # insert/copy/block-count code tables
    def arr(name, a, t="int32_t"):
        out.append(f"static const {t} {name}[{len(a)}] = "
                   "{" + ", ".join(str(int(x)) for x in a) + "};")

    arr("kInsertBase", prefix.INSERT_BASE)
    arr("kInsertExtra", prefix.INSERT_EXTRA)
    arr("kCopyBase", prefix.COPY_BASE)
    arr("kCopyExtra", prefix.COPY_EXTRA)
    arr("kBlockCountBase", prefix.BLOCK_COUNT_BASE)
    arr("kBlockCountExtra", prefix.BLOCK_COUNT_EXTRA)

    lut = prefix.cmd_lut()
    arr("kCmdInsertBase", lut["insert_base"])
    arr("kCmdInsertExtra", lut["insert_extra"], "uint8_t")
    arr("kCmdCopyBase", lut["copy_base"])
    arr("kCmdCopyExtra", lut["copy_extra"], "uint8_t")
    arr("kCmdImplicitDist0", lut["implicit_dist0"].astype(int), "uint8_t")
    arr("kCmdDistCtx", lut["dist_context"], "uint8_t")

    # dictionary geometry
    arr("kDictSizeBits", dictionary.SIZE_BITS_BY_LENGTH, "uint8_t")
    arr("kDictOffsets", dictionary.OFFSETS_BY_LENGTH, "uint32_t")

    # transforms: op codes 0=identity, 1=uc_first, 2=uc_all,
    # 10+k=omit_first_k, 20+k=omit_last_k
    ops = {"IDENTITY": 0, "UPPERCASE_FIRST": 1, "UPPERCASE_ALL": 2}
    tp, ts, tops = [], [], []
    pool = bytearray()
    for p, op, s in transforms.TRANSFORMS:
        tp.append((len(pool), len(p)))
        pool += p
        ts.append((len(pool), len(s)))
        pool += s
        if op in ops:
            tops.append(ops[op])
        elif op.startswith("OMIT_FIRST_"):
            tops.append(10 + int(op[11:]))
        else:
            tops.append(20 + int(op[10:]))
    out.append("static const uint8_t kTransformPool[] = {" +
               fmt_bytes(pool) + "};")
    arr("kTransformPrefixOff", [a for a, _ in tp], "uint16_t")
    arr("kTransformPrefixLen", [b for _, b in tp], "uint8_t")
    arr("kTransformSuffixOff", [a for a, _ in ts], "uint16_t")
    arr("kTransformSuffixLen", [b for _, b in ts], "uint8_t")
    arr("kTransformOp", tops, "uint8_t")

    # encoder-side: fixed (code, nbits) to WRITE a code-length-code
    # length 0..5 (inverse of the peek table below)
    enc_code = [0] * 6
    enc_bits = [0] * 6
    for sym, (code, ln) in C.CODE_LENGTH_CODE_FIXED.items():
        enc_code[sym] = code
        enc_bits[sym] = ln
    arr("kClcLenCode", enc_code, "uint8_t")
    arr("kClcLenBits", enc_bits, "uint8_t")
    arr("kInitialRing", C.INITIAL_DISTANCE_RB, "uint32_t")
    out.append(f"#define BTPU_NUM_DIST_SYMS "
               f"{C.distance_alphabet_size(0, 0, C.MAX_DISTANCE_BITS)}")
    out.append(f"#define BTPU_NUM_CMD_SYMS {C.NUM_COMMAND_SYMBOLS}")

    # code-length-code fixed code (index by 4 peeked bits)
    fixed_len = [0] * 16
    fixed_val = [0] * 16
    for sym, (code, ln) in C.CODE_LENGTH_CODE_FIXED.items():
        for pad in range(1 << (4 - ln)):
            fixed_len[code | (pad << ln)] = ln
            fixed_val[code | (pad << ln)] = sym
    arr("kClcFixedLen", fixed_len, "uint8_t")
    arr("kClcFixedVal", fixed_val, "uint8_t")
    arr("kClcOrder", C.CODE_LENGTH_CODE_ORDER, "uint8_t")

    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = pathlib.Path(argv[0]) if argv else \
        pathlib.Path(__file__).parent / "btpu_tables.h"
    path.write_text(tables())
    print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
