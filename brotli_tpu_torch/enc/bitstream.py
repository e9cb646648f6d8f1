"""RFC 7932 bitstream pieces the device pipelines need: the stream
header, metablock header, varlen and uncompressed-metablock writers (the
whole-input stored fallback and the device serializer's host header),
the command planner the host cost tables replay the seed parse through,
the distance ring after a command sequence (the entry ring of a shard)
and its push summary (the ring chain across processes), and the emitted
code lengths of a tree. Copied from
brotli_tpu.enc.bitstream.
"""

import numpy as np

from ..format import constants as C
from ..format import prefix
from ..format.bitio import BitWriter

MAX_MLEN = 1 << 24


def write_stream_header(bw: BitWriter, window_bits: int) -> None:
    """WBITS encoding (RFC 9.1; inverse of c/dec/decode.c
    DecodeWindowBits)."""
    if window_bits == 16:
        bw.write(0, 1)
    elif 18 <= window_bits <= 24:
        bw.write(1, 1)
        bw.write(window_bits - 17, 3)
    elif window_bits == 17:
        bw.write(1, 1)
        bw.write(0, 3)
        bw.write(0, 3)
    elif 10 <= window_bits <= 15:
        bw.write(1, 1)
        bw.write(0, 3)
        bw.write(window_bits - 8, 3)
    elif 25 <= window_bits <= 30:
        # large-window brotli (non-RFC extension; decoder opt-in:
        # c/include/brotli/decode.h BROTLI_DECODER_PARAM_LARGE_WINDOW)
        bw.write(1, 1)
        bw.write(0, 3)
        bw.write(1, 3)
        bw.write(0, 1)
        bw.write(window_bits, 6)
    else:
        raise ValueError(f"invalid window bits {window_bits}")


def write_varlen_uint8(bw: BitWriter, value: int) -> None:
    if value == 0:
        bw.write(0, 1)
        return
    bw.write(1, 1)
    nbits = value.bit_length() - 1
    bw.write(nbits, 3)
    if nbits:
        bw.write(value - (1 << nbits), nbits)


def write_metablock_header_mlen(bw: BitWriter, mlen: int, is_last: bool,
                                is_uncompressed: bool = False) -> None:
    bw.write(1 if is_last else 0, 1)
    if is_last:
        bw.write(0, 1)  # not empty
    nibbles = 4 if mlen <= (1 << 16) else 5 if mlen <= (1 << 20) else 6
    bw.write(nibbles - 4, 2)
    v = mlen - 1
    for i in range(nibbles):
        bw.write((v >> (4 * i)) & 0xF, 4)
    if not is_last:
        bw.write(1 if is_uncompressed else 0, 1)


def write_uncompressed_metablock(bw: BitWriter, data: bytes) -> None:
    write_metablock_header_mlen(bw, len(data), is_last=False,
                                is_uncompressed=True)
    bw.align_to_byte()
    arr = np.frombuffer(data, dtype=np.uint8)
    bw.write_arrays(arr.astype(np.int64), np.full(len(arr), 8, np.int64))


def write_last_empty(bw: BitWriter) -> None:
    bw.write(1, 1)  # ISLAST
    bw.write(1, 1)  # ISLASTEMPTY


def _encode_values(values, base, extra):
    """Vectorized (code, extra_value, extra_bits) for a value array."""
    values = np.asarray(values, dtype=np.int64)
    codes = np.searchsorted(base, values, side="right") - 1
    return codes, values - base[codes], extra[codes].astype(np.int64)


def initial_ring() -> np.ndarray:
    """Decoder ring at stream start, newest-first (RFC 7932 4)."""
    return np.array(C.INITIAL_DISTANCE_RB[::-1], dtype=np.int64)


def ring_after(dists, flags, ring=None) -> np.ndarray:
    """Distance ring state after a command sequence, without
    serializing it (used to seed parallel shard encoders: the decoder's
    ring crosses shard seams). Static-dict words (flag >= 2) never push;
    consecutive equal distances collapse to one push."""
    if ring is None:
        ring = initial_ring()
    ring = np.asarray(ring, dtype=np.int64)
    cd = np.asarray(dists, dtype=np.int64)[np.asarray(flags) < 2]
    cd = cd[cd > 0]
    if len(cd) == 0:
        return ring.copy()
    keep = np.concatenate([[cd[0] != ring[0]], cd[1:] != cd[:-1]])
    pv = np.concatenate([ring[::-1], cd[keep]])
    return pv[:-5:-1].copy()


def ring_push_summary(dists, flags, tail: int = 5) -> np.ndarray:
    """Entry-independent push summary of a command stream: the last
    `tail` deduped candidate-push distances under ring_after's rule
    (flags >= 2 never push; consecutive duplicates collapse; the
    entry-ring comparison is deferred to ring_apply_summary).
    Zero-padded; real distances are never 0."""
    cd = np.asarray(dists, dtype=np.int64)[np.asarray(flags) < 2]
    cd = cd[cd > 0]
    out = np.zeros(tail, np.int64)
    if len(cd) == 0:
        return out
    keep = np.concatenate([[True], cd[1:] != cd[:-1]])
    t = cd[keep][-tail:]
    out[: len(t)] = t
    return out


def ring_apply_summary(ring, tail) -> np.ndarray:
    """Advance a 4-slot ring across a shard given its push summary.
    Exact: only the first candidate can collapse against the entry
    ring, and when more pushes preceded the tail the >= 4 remaining
    tail pushes refill the whole ring either way (hence tail = 5)."""
    ring = list(initial_ring() if ring is None else ring)
    for d in (int(x) for x in tail if x > 0):
        if d != ring[0]:
            ring = [d, ring[0], ring[1], ring[2]]
    return np.asarray(ring[:4], np.int64)


def encode_distances_vec(d: np.ndarray, npostfix: int, ndirect: int):
    """Vectorized format.prefix.encode_distance over a distance array
    (explicit codes only; callers handle ring short codes). Returns
    (dcode, extra_value, extra_bits)."""
    d = np.asarray(d, dtype=np.int64)
    direct = d <= ndirect
    # general branch (clamp direct entries to keep the math in range)
    dd = np.where(direct, ndirect + 1, d) - ndirect - 1
    pmask = (1 << npostfix) - 1
    postfix = dd & pmask
    hcode = dd >> npostfix
    # nbits = max(bit_length(hcode + 4) - 2, 1); frexp exponent IS the
    # bit length (exact: values < 2^53)
    nbits = np.frexp((hcode + 4).astype(np.float64))[1].astype(
        np.int64) - 2
    nbits = np.maximum(nbits, 1)
    rest = hcode - ((np.int64(2) << nbits) - 4)
    half = rest >> nbits
    extra_val = rest - (half << nbits)
    dcode = (C.NUM_DISTANCE_SHORT_CODES + ndirect +
             ((((nbits - 1) << 1) | half) << npostfix) + postfix)
    dcode = np.where(direct, C.NUM_DISTANCE_SHORT_CODES + d - 1, dcode)
    extra_val = np.where(direct, 0, extra_val)
    nbits = np.where(direct, 0, nbits)
    return dcode, extra_val, nbits


def plan_commands(ins: np.ndarray, cpy: np.ndarray, dist: np.ndarray,
                  ring, dict_flag: np.ndarray = None,
                  npostfix: int = 0, ndirect: int = 0):
    """Resolve commands to symbols + extras, all vectorized.

    `ring`: the decoder's 4-slot distance ring entering this block,
    newest-first (None = stream start). Returns (plan dict, new ring).
    The final command of a metablock may be insert-only (cpy == 0,
    dist == 0); mid-stream commands always have cpy >= 2.

    The ring is simulated exactly (decoder parity: dec/decoder.py
    short-code branch; reference c/dec/decode.c dist ring): every copy
    command whose distance differs from the ring top pushes it, code 0
    does not push, dictionary words never touch the ring. Hence the
    push sequence is the copy-distance sequence with consecutive
    duplicates collapsed -- which makes all 16 short codes computable
    with vector ops, no serial state walk.
    """
    n = len(ins)
    icode, iextra, ibits = _encode_values(ins, prefix.INSERT_BASE,
                                          prefix.INSERT_EXTRA)
    final_insert = (cpy == 0) & (dist == 0)
    fl = np.asarray(dict_flag if dict_flag is not None
                    else np.zeros(n, np.int64))
    # dict-word flags carry the emitted copy length (the base word
    # length, i.e. the RFC length-bucket selector): 1000 + len for
    # custom shared-dict words, 2000 + len for builtin static-dict
    # words, since transforms may lengthen or shorten the output
    # relative to the input advance `cpy`. Legacy 2..999 encodes a
    # builtin omit-last cutoff as 2 + cut (copy len = advance + cut).
    builtin_gen = fl >= 2000
    custom = (fl >= 1000) & ~builtin_gen
    cut = np.where(custom | builtin_gen, 0, np.maximum(fl - 2, 0))
    eff_cpy = np.where(builtin_gen, fl - 2000,
                       np.where(custom, fl - 1000, cpy + cut))
    ccode, cextra, cbits = _encode_values(
        np.where(final_insert, 2, eff_cpy), prefix.COPY_BASE,
        prefix.COPY_EXTRA)
    if dict_flag is None:
        dict_flag = np.zeros(n, dtype=np.int64)
    # flag semantics: 0 = LZ, 1 = compound-dict ref (pushes the ring,
    # decode.c:1598), >= 2 = static-dict word (never touches the ring;
    # flag - 2 = omit-last cutoff, so the copy CODE spans the full base
    # word while the input advance is `cpy`)
    is_dict = dict_flag >= 2
    if ring is None:
        ring = initial_ring()
    ring = np.asarray(ring, dtype=np.int64)

    # exact ring simulation over the copy commands of this block
    slot = np.zeros((4, n), np.int64)  # ring value per command, per slot
    copy_sel = np.flatnonzero(~final_insert & ~is_dict)
    if len(copy_sel):
        cd = dist[copy_sel].astype(np.int64)
        top_before = np.concatenate([[ring[0]], cd[:-1]])
        newpush = cd != top_before
        pv = np.concatenate([ring[::-1], cd[newpush]])  # oldest..newest
        cnt_before = 4 + np.cumsum(newpush) - newpush   # pushes before
        for s in range(4):
            slot[s, copy_sel] = pv[cnt_before - 1 - s]
        new_ring = pv[:-5:-1].copy()  # last 4, newest-first
    else:
        new_ring = ring.copy()

    is_reuse = (~final_insert) & ~is_dict & (dist == slot[0])
    implicit = is_reuse & (icode < 8) & (ccode < 16)
    explicit_reuse = is_reuse & ~implicit

    dcode = np.zeros(n, dtype=np.int64)
    dextra = np.zeros(n, dtype=np.int64)
    dbits = np.zeros(n, dtype=np.int64)
    # short codes: 1..3 = older ring slots, 4..9 = ring-top +/-1..3,
    # 10..15 = second slot +/-1..3 (RFC 7932 4; no extra bits)
    short = np.full(n, -1, np.int64)
    eligible = (~final_insert) & ~is_reuse & ~is_dict
    d0, d1 = dist - slot[0], dist - slot[1]
    near0 = np.where(d0 < 0, 4 + 2 * (-d0 - 1), 5 + 2 * (d0 - 1))
    near1 = np.where(d1 < 0, 10 + 2 * (-d1 - 1), 11 + 2 * (d1 - 1))
    for cond, code in [
            (dist == slot[1], 1), (dist == slot[2], 2),
            (dist == slot[3], 3),
            ((np.abs(d0) <= 3) & (d0 != 0), near0),
            ((np.abs(d1) <= 3) & (d1 != 0), near1)]:
        pick = eligible & (short < 0) & cond
        short = np.where(pick, code if np.ndim(code) else
                         np.full(n, code, np.int64), short)
    near = short >= 0
    dcode[near] = short[near]
    explicit_new = (~final_insert) & ~is_reuse & ~near
    if np.any(explicit_new):
        dc, ev, nb = encode_distances_vec(
            dist[explicit_new].astype(np.int64), npostfix, ndirect)
        dcode[explicit_new] = dc
        dextra[explicit_new] = ev
        dbits[explicit_new] = nb
    # explicit reuse -> short code 0 (no extra bits)

    has_dist = ~final_insert & ~implicit
    # command symbol via cell mapping
    cmd_syms = _combine_codes(icode, ccode, implicit | final_insert & (
        icode < 8))
    # insert-only finals with icode >= 8 need a non-implicit cell
    fix = final_insert & (icode >= 8)
    if np.any(fix):
        cmd_syms[fix] = _combine_codes(icode[fix], ccode[fix],
                                       np.zeros(int(fix.sum()), bool))

    return {
        "cmd_syms": cmd_syms.astype(np.int64),
        "insert_extras": (iextra, ibits),
        "copy_extras": (np.where(final_insert, 0, cextra),
                        np.where(final_insert, 0, cbits)),
        "dist_syms": dcode,
        "dist_extras": (dextra, dbits),
        "has_dist": has_dist,
        "ins": np.asarray(ins, np.int64),
        "expl_dists": dist[explicit_new].astype(np.int64),
    }, new_ring


def _combine_codes(icode, ccode, implicit):
    """Vectorized combine_cmd_code (RFC 5)."""
    low = ((icode & 7) << 3) | (ccode & 7)
    cell_starts = np.array([[128, 192, 384], [256, 320, 512],
                            [448, 576, 640]], dtype=np.int64)
    start = cell_starts[icode >> 3, ccode >> 3]
    implicit_start = np.where((ccode >> 3) == 0, 0, 64)
    return np.where(implicit, implicit_start + low, start + low)


def _emission(lengths):  # single-symbol alphabets decode with 0 bits
    return np.zeros_like(lengths) if np.count_nonzero(lengths) <= 1 \
        else lengths
