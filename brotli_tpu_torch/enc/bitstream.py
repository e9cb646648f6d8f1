"""RFC 7932 bitstream assembly: stream header + metablock serialization
(copy of brotli_tpu.enc.bitstream).

Fully vectorized: command fields and literal runs are interleaved into a
single (value, nbits) stream with cumsum/scatter array surgery
(parity anchor: c/enc/brotli_bit_stream.c BrotliStoreMetaBlock and
write_bits.h).
"""

import numpy as np

from ..format import constants as C
from ..format import prefix
from ..format.bitio import BitWriter
from .entropy import lengths_to_codes, package_merge, write_huffman_code

MAX_MLEN = 1 << 24

# optional per-metablock bit accounting (diagnostics): set to a list
# and store_metablock appends realized per-category bit totals
ACCOUNT_SINK = None


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


def write_metadata_block(bw: BitWriter, payload: bytes) -> None:
    """Emit a metadata block (RFC 9.2 MNIBBLES=0 path; parity:
    BROTLI_OPERATION_EMIT_METADATA, c/enc/encode.c ProcessMetadata).
    Content is opaque to decompression and byte-aligned."""
    n = len(payload)
    if n > (1 << 24):
        raise ValueError("metadata too large")
    bw.write(0, 1)   # ISLAST
    bw.write(3, 2)   # MNIBBLES code -> metadata block
    bw.write(0, 1)   # reserved
    if n == 0:
        bw.write(0, 2)   # MSKIPBYTES = 0
    else:
        nbytes = ((n - 1).bit_length() + 7) // 8 or 1
        bw.write(nbytes, 2)
        v = n - 1
        for i in range(nbytes):
            bw.write((v >> (8 * i)) & 0xFF, 8)
    bw.align_to_byte()
    for b in payload:
        bw.write(b, 8)


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


def choose_distance_params(expl_dists: np.ndarray):
    """Search NPOSTFIX in 0..3 x NDIRECT in {0..15}<<npostfix for the
    cheapest explicit-distance encoding (parity anchor: the q>=10
    search in c/enc/metablock.c:301-334, full 64-config sweep instead
    of its early-break walk). Cost = histogram entropy of the distance
    codes + total extra bits. Returns (npostfix, ndirect)."""
    if len(expl_dists) == 0:
        return 0, 0
    # strided subsample: the argmin over configs is stable well below
    # full resolution, and the sweep cost is per-config linear
    scale = 1.0
    if len(expl_dists) > 32768:
        step = len(expl_dists) // 32768 + 1
        expl_dists = expl_dists[::step]
        scale = float(step)
    best = (0, 0)
    best_cost = None
    for npostfix in range(C.MAX_NPOSTFIX + 1):
        for msb in range(16):
            ndirect = msb << npostfix
            dcode, _, dbits = encode_distances_vec(expl_dists, npostfix,
                                                   ndirect)
            freq = np.bincount(dcode)
            nz = freq[freq > 0]
            n = nz.sum()
            entropy = float(n * np.log2(n) - (nz * np.log2(nz)).sum())
            cost = (entropy + float(dbits.sum())) * scale + 10.0 * len(nz)
            if best_cost is None or cost < best_cost - 1e-9:
                best_cost = cost
                best = (npostfix, ndirect)
    return best


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


def write_context_map(bw: BitWriter, cmap: np.ndarray,
                      ntrees: int) -> None:
    """Serialize a context map (RFC 7.3): forward-MTF + zero-RLE +
    prefix code, with the IMTF bit set."""
    from .context_model import mtf_transform
    write_varlen_uint8(bw, ntrees - 1)
    if ntrees <= 1:
        return
    mtf = mtf_transform(cmap.astype(np.int64))
    # zero-run lengths decide RLEMAX
    syms = []  # (symbol, extra, extra_bits) with placeholder rlemax
    i = 0
    n = len(mtf)
    max_v = 0
    while i < n:
        if mtf[i] != 0:
            syms.append(("v", int(mtf[i]), 0, 0))
            i += 1
            continue
        j = i
        while j < n and mtf[j] == 0:
            j += 1
        ln = j - i
        while ln > 0:
            if ln == 1:
                syms.append(("v", 0, 0, 0))
                ln = 0
            else:
                v = min(ln.bit_length() - 1, 16)
                extra = min(ln - (1 << v), (1 << v) - 1)
                syms.append(("r", v, extra, v))
                ln -= (1 << v) + extra
                max_v = max(max_v, v)
        i = j
    rlemax = max_v  # 0 => no RLE
    if rlemax:
        bw.write(1, 1)
        bw.write(rlemax - 1, 4)
    else:
        bw.write(0, 1)
    alphabet = ntrees + rlemax
    stream = []
    for kind, a, extra, ebits in syms:
        if kind == "v":
            stream.append((a + rlemax if a else 0, 0, 0))
        else:
            stream.append((a, extra, ebits))
    freq = np.bincount([s for s, _, _ in stream], minlength=alphabet)
    lens = package_merge(freq, C.HUFFMAN_MAX_CODE_LENGTH)
    write_huffman_code(bw, lens, alphabet)
    lens_e = _emission(lens)
    codes = lengths_to_codes(lens_e)
    for s, extra, ebits in stream:
        bw.write(int(codes[s]), int(lens_e[s]))
        if ebits:
            bw.write(extra, ebits)
    bw.write(1, 1)  # IMTF applied


def store_metablock(bw: BitWriter, data: np.ndarray, block_start: int,
                    mlen: int, cmds, is_last: bool, ring=None,
                    quality: int = 1, context_mode=None,
                    ctx_floor: int = 0, large: bool = False,
                    b64_mask=None):
    """Serialize one compressed metablock.

    q < 5: single tree per alphabet ("StoreMetaBlockTrivial").
    q >= 5: 2nd-order literal context modeling -- per-context histograms
    clustered into trees with a context map.
    q >= 9: literal block splitting; q >= 10 adds command/distance block
    splitting and a distance context map (parity: BrotliStoreMetaBlock,
    c/enc/brotli_bit_stream.c + metablock.c q>=10 path).
    `ring`: 4-slot decoder distance ring entering the block (newest
    first; None = stream start). Returns the updated ring.
    """
    from .quality import policy
    pol = policy(quality)
    ins, cpy, dist, dflag = _as_arrays(cmds)
    plan, new_ring = plan_commands(ins, cpy, dist, ring, dflag)
    # NPOSTFIX/NDIRECT search (q>=10, parity: metablock.c:301-334).
    npostfix = ndirect = 0
    if pol.dist_param_search and len(plan["expl_dists"]) >= 128:
        npostfix, ndirect = choose_distance_params(plan["expl_dists"])
        if (npostfix, ndirect) != (0, 0):
            plan, new_ring = plan_commands(ins, cpy, dist, ring, dflag,
                                           npostfix, ndirect)
    ncmd = len(ins)
    dist_alpha = C.distance_alphabet_size(
        npostfix, ndirect,
        C.LARGE_MAX_DISTANCE_BITS if large else C.MAX_DISTANCE_BITS)
    cmd_syms = plan["cmd_syms"]
    has = plan["has_dist"]
    dsyms_sub = plan["dist_syms"][has]

    # literals: gather runs [pos, pos+ins) for each command
    starts = block_start + np.concatenate(
        [[0], np.cumsum(ins + cpy)[:-1]]).astype(np.int64)
    literals = _gather_runs(data, starts, plan["ins"])
    lit_pos = _run_positions(starts, plan["ins"])
    nlit = len(literals)

    # --- block splitting per category (RFC 6)
    from . import block_split
    split = None
    if pol.literal_split and nlit >= pol.min_split_literals:
        split = block_split.split_symbols(literals,
                                          C.NUM_LITERAL_SYMBOLS,
                                          chunk=pol.split_chunk)
    if split is not None:
        run_types, block_lengths, type_of_lit = split
        ntypes = int(run_types.max()) + 1
    else:
        ntypes = 1
        type_of_lit = np.zeros(nlit, np.int64)

    # --- base64 literal-split forcing (parity: metablock.c
    # ForceBase64LiteralSplits + the fixed flat code in
    # block_encoder_inc.h): payload literals get a dedicated block
    # type whose tree is the 6-bit base64 code
    b64_type = None
    if b64_mask is not None and nlit:
        lit_b64 = b64_mask[np.minimum(lit_pos, len(b64_mask) - 1)]
        if lit_b64.any():
            b64_type = ntypes
            ntypes += 1
            type_of_lit = np.where(lit_b64, b64_type, type_of_lit)
            if type_of_lit[0] != 0:  # first block type must be 0 (RFC 6)
                a, b = int(type_of_lit[0]), 0
                perm = np.arange(ntypes)
                perm[a], perm[b] = b, a
                type_of_lit = perm[type_of_lit]
                b64_type = int(perm[b64_type])
            edges = np.flatnonzero(np.diff(type_of_lit)) + 1
            bounds = np.concatenate([[0], edges, [nlit]])
            block_lengths = np.diff(bounds)
            run_types = type_of_lit[bounds[:-1]]

    cmd_split = dist_split = None
    if pol.cmd_dist_split and ncmd >= pol.min_split_cmds:
        cmd_split = block_split.split_symbols(
            cmd_syms, C.NUM_COMMAND_SYMBOLS, chunk=256, max_types=6)
    if pol.cmd_dist_split and len(dsyms_sub) >= pol.min_split_cmds:
        dist_split = block_split.split_symbols(
            dsyms_sub, dist_alpha, chunk=256, max_types=4)
    if cmd_split is not None:
        crun_types, cblock_lengths, type_of_cmd = cmd_split
        ntypes_i = int(crun_types.max()) + 1
    else:
        ntypes_i = 1
        type_of_cmd = np.zeros(ncmd, np.int64)
    if dist_split is not None:
        drun_types, dblock_lengths, type_of_dsym = dist_split
        ntypes_d = int(drun_types.max()) + 1
    else:
        ntypes_d = 1
        type_of_dsym = np.zeros(len(dsyms_sub), np.int64)

    # --- literal context modeling + clustering
    use_context = pol.context_modeling and nlit >= pol.min_ctx_literals
    from . import context_model as cm
    if use_context:
        mode = cm.choose_context_mode(data) if context_mode is None \
            else context_mode
        ctx_ids = cm.literal_context_ids(data, lit_pos, mode, ctx_floor)
    else:
        mode = 0
        ctx_ids = np.zeros(nlit, np.int64)
    group = (type_of_lit << C.LITERAL_CONTEXT_BITS) | ctx_ids
    b64_tree = None
    if use_context or ntypes > 1:
        hists = cm.context_histograms(
            literals, group, ntypes * C.NUM_LITERAL_CONTEXTS,
            C.NUM_LITERAL_SYMBOLS)
        if b64_type is not None:
            # base64 contexts use the forced flat code; their rows must
            # not shape the clustering
            hists[b64_type * 64:(b64_type + 1) * 64] = 0
        if use_context:
            assign, merged = cm.cluster_histograms(
                hists, max_trees=pol.max_lit_trees,
                table_cost_bits=180.0 if pol.optimal_parse else 60.0)
        else:  # per-type trees, constant over contexts
            assign = np.repeat(np.arange(ntypes, dtype=np.int64),
                               C.NUM_LITERAL_CONTEXTS)
            merged = np.stack([
                hists[t * 64:(t + 1) * 64].sum(axis=0)
                for t in range(ntypes)])
        ntrees = len(merged)
        if b64_type is not None:
            b64_tree = ntrees
            ntrees += 1
            merged = np.concatenate(
                [merged, np.zeros((1, C.NUM_LITERAL_SYMBOLS),
                                  merged.dtype)])
            assign = assign.copy()
            assign[(b64_type << C.LITERAL_CONTEXT_BITS) +
                   np.arange(C.NUM_LITERAL_CONTEXTS)] = b64_tree
            # drop trees no context references anymore (the zeroed
            # b64 rows may have left an orphan in the per-type path)
            used = np.unique(assign)
            remap = np.zeros(ntrees, np.int64)
            remap[used] = np.arange(len(used))
            assign = remap[assign]
            merged = merged[used]
            b64_tree = int(remap[b64_tree])
            ntrees = len(used)
        if ntrees == 1 and ntypes == 1:
            use_context = False
    multi = use_context or ntypes > 1

    # --- distance context map (4 copy-length contexts per block type)
    dctx_tab = prefix.cmd_lut()["dist_context"].astype(np.int64)
    dctx = dctx_tab[cmd_syms[has]]
    dgroup = (type_of_dsym << C.DISTANCE_CONTEXT_BITS) | dctx
    use_dist_map = pol.dist_context_map and \
        len(dsyms_sub) >= pol.min_dist_syms
    if use_dist_map or ntypes_d > 1:
        dhists = cm.context_histograms(
            dsyms_sub, dgroup, ntypes_d * 4, dist_alpha)
        dassign, dmerged = cm.cluster_histograms(
            dhists, max_trees=8, table_cost_bits=30.0)
        n_dist_trees = len(dmerged)
        if n_dist_trees == 1 and ntypes_d == 1:
            use_dist_map = False
    if not (use_dist_map or ntypes_d > 1):
        dassign = np.zeros(4, np.int64)
        dmerged = np.bincount(dsyms_sub, minlength=dist_alpha)[None, :] \
            if len(dsyms_sub) else np.zeros((1, dist_alpha), np.int64)
        n_dist_trees = 1

    # --- header
    write_metablock_header_mlen(bw, mlen, is_last)
    write_varlen_uint8(bw, ntypes - 1)  # NBLTYPESL
    if ntypes > 1:
        sw_info = _plan_block_switches(run_types, block_lengths, ntypes)
        _write_block_header(bw, sw_info, ntypes)
    write_varlen_uint8(bw, ntypes_i - 1)  # NBLTYPESI
    if ntypes_i > 1:
        csw_info = _plan_block_switches(crun_types, cblock_lengths,
                                        ntypes_i)
        _write_block_header(bw, csw_info, ntypes_i)
    write_varlen_uint8(bw, ntypes_d - 1)  # NBLTYPESD
    if ntypes_d > 1:
        dsw_info = _plan_block_switches(drun_types, dblock_lengths,
                                        ntypes_d)
        _write_block_header(bw, dsw_info, ntypes_d)
    bw.write(npostfix, 2)  # NPOSTFIX
    bw.write(ndirect >> npostfix, 4)  # NDIRECT (stored >> npostfix)

    # --- command trees: one per command block type (no context map)
    cmd_lens2d = np.zeros((ntypes_i, C.NUM_COMMAND_SYMBOLS), np.int64)
    for t in range(ntypes_i):
        freq = np.bincount(cmd_syms[type_of_cmd == t],
                           minlength=C.NUM_COMMAND_SYMBOLS)
        cmd_lens2d[t] = package_merge(freq, C.HUFFMAN_MAX_CODE_LENGTH)
    dist_lens2d = np.zeros((n_dist_trees, dist_alpha), np.int64)
    for t in range(n_dist_trees):
        dist_lens2d[t] = package_merge(dmerged[t],
                                       C.HUFFMAN_MAX_CODE_LENGTH)

    if not multi:
        bw.write(0, 2)  # literal context mode (irrelevant: 1 tree)
        write_varlen_uint8(bw, 0)  # literal context map: 1 tree
    else:
        for _ in range(ntypes):
            bw.write(mode, 2)  # context mode per literal block type
        write_context_map(bw, assign, ntrees)  # literal context map
    if n_dist_trees > 1:
        write_context_map(bw, dassign, n_dist_trees)
    else:
        write_varlen_uint8(bw, 0)  # distance context map: 1 tree

    if not multi:
        lit_freq = np.bincount(literals, minlength=C.NUM_LITERAL_SYMBOLS)
        lit_len = package_merge(lit_freq, C.HUFFMAN_MAX_CODE_LENGTH)
        write_huffman_code(bw, lit_len, C.NUM_LITERAL_SYMBOLS)
        lit_len = _emission(lit_len)
        lit_codes = lengths_to_codes(lit_len).astype(np.int64)
        lit_vals = lit_codes[literals]
        lit_bits = lit_len[literals]
    else:
        lit_lens2d = np.zeros((ntrees, C.NUM_LITERAL_SYMBOLS), np.int32)
        lit_codes2d = np.zeros_like(lit_lens2d, dtype=np.int64)
        for t in range(ntrees):
            if t == b64_tree:
                from .base64_mode import base64_code_lengths
                true_len = base64_code_lengths()
            else:
                true_len = package_merge(merged[t],
                                         C.HUFFMAN_MAX_CODE_LENGTH)
            write_huffman_code(bw, true_len, C.NUM_LITERAL_SYMBOLS)
            e = _emission(true_len)
            lit_lens2d[t] = e
            lit_codes2d[t] = lengths_to_codes(e).astype(np.int64)
        tree_of_lit = assign[group]
        lit_vals = lit_codes2d[tree_of_lit, literals]
        lit_bits = lit_lens2d[tree_of_lit, literals].astype(np.int64)
    for t in range(ntypes_i):
        write_huffman_code(bw, cmd_lens2d[t], C.NUM_COMMAND_SYMBOLS)
    for t in range(n_dist_trees):
        write_huffman_code(bw, dist_lens2d[t], dist_alpha)

    if ntypes > 1:  # embed switch slots before the switching literal
        lit_vals, lit_bits = _with_switch_slots(
            lit_vals, lit_bits, sw_info)
        lanes = 4
    else:
        lanes = 1

    # per-command symbol values under the selected trees
    cmd_lens_e = np.stack([_emission(cmd_lens2d[t])
                           for t in range(ntypes_i)])
    cmd_codes_e = np.stack([lengths_to_codes(cmd_lens_e[t])
                            for t in range(ntypes_i)]).astype(np.int64)
    cmd_vals = cmd_codes_e[type_of_cmd, cmd_syms]
    cmd_bits = cmd_lens_e[type_of_cmd, cmd_syms]
    dist_lens_e = np.stack([_emission(dist_lens2d[t])
                            for t in range(n_dist_trees)])
    dist_codes_e = np.stack([lengths_to_codes(dist_lens_e[t])
                             for t in range(n_dist_trees)]).astype(
        np.int64)
    tree_of_dsym = dassign[dgroup]
    dist_vals = np.zeros(ncmd, np.int64)
    dist_bits = np.zeros(ncmd, np.int64)
    hidx = np.flatnonzero(has)
    dist_vals[hidx] = dist_codes_e[tree_of_dsym, dsyms_sub]
    dist_bits[hidx] = dist_lens_e[tree_of_dsym, dsyms_sub]

    # block-switch slots for command / distance streams
    cmd_sw = dist_sw = None
    if ntypes_i > 1:
        at = np.cumsum(csw_info["block_lengths"])[:-1]
        cmd_sw = (at, csw_info)
    if ntypes_d > 1:
        at = hidx[np.cumsum(dsw_info["block_lengths"])[:-1]]
        dist_sw = (at, dsw_info)

    if ACCOUNT_SINK is not None:
        _, ibits_ = plan["insert_extras"]
        _, cbits_ = plan["copy_extras"]
        _, dbits_ = plan["dist_extras"]
        ACCOUNT_SINK.append({
            "lit_bits": int(lit_bits.sum()),
            "cmd_bits": int(cmd_bits.sum()),
            "cmd_extra_bits": int(ibits_.sum() + cbits_.sum()),
            "dist_bits": int(dist_bits.sum()),
            "dist_extra_bits": int(dbits_.sum()),
            "ncmd": ncmd, "nlit": nlit,
            "ntypes": (ntypes, ntypes_i, ntypes_d),
            "ntrees": (int(len(merged)) if multi else 1, n_dist_trees),
        })
    values, nbits = _interleave_symbols(
        plan, (lit_vals, lit_bits), lanes, (cmd_vals, cmd_bits),
        (dist_vals, dist_bits), cmd_sw, dist_sw)
    bw.write_arrays(values, nbits)
    return new_ring


def _plan_block_switches(run_types, block_lengths, ntypes):
    """Resolve block-switch symbols: type codes ride a 2-entry ring
    (0 = previous, 1 = current + 1, else type + 2; RFC 6)."""
    tsyms = []
    rb = [1, 0]
    for t in run_types[1:]:
        t = int(t)
        if t == rb[0]:
            tsyms.append(0)
        elif t == (rb[1] + 1) % ntypes:
            tsyms.append(1)
        else:
            tsyms.append(t + 2)
        rb = [rb[1], t]
    tsyms = np.array(tsyms, np.int64)
    ccode, cextra, cbits = (np.array(v) for v in zip(
        *[prefix.encode_value(int(L), prefix.BLOCK_COUNT_BASE,
                              prefix.BLOCK_COUNT_EXTRA)
          for L in block_lengths]))
    # trees over type symbols (switches only) and count codes (all)
    type_freq = np.bincount(tsyms, minlength=ntypes + 2) if len(tsyms) \
        else np.zeros(ntypes + 2, np.int64)
    cnt_freq = np.bincount(ccode, minlength=C.NUM_BLOCK_LEN_SYMBOLS)
    type_len = package_merge(type_freq, C.HUFFMAN_MAX_CODE_LENGTH)
    cnt_len = package_merge(cnt_freq, C.HUFFMAN_MAX_CODE_LENGTH)
    return {
        "tsyms": tsyms, "ccode": ccode, "cextra": cextra, "cbits": cbits,
        "block_lengths": np.asarray(block_lengths, np.int64),
        "type_len": type_len, "cnt_len": cnt_len,
        "type_codes": lengths_to_codes(_emission(type_len)),
        "type_bits": _emission(type_len),
        "cnt_codes": lengths_to_codes(_emission(cnt_len)),
        "cnt_bits": _emission(cnt_len),
    }


def _write_block_header(bw, sw, ntypes):
    """Block-type tree, block-count tree, first block length (RFC 9.2)."""
    write_huffman_code(bw, sw["type_len"], ntypes + 2)
    write_huffman_code(bw, sw["cnt_len"], C.NUM_BLOCK_LEN_SYMBOLS)
    c0 = int(sw["ccode"][0])
    bw.write(int(sw["cnt_codes"][c0]), int(sw["cnt_bits"][c0]))
    if sw["cbits"][0]:
        bw.write(int(sw["cextra"][0]), int(sw["cbits"][0]))


def _with_switch_slots(lit_vals, lit_bits, sw):
    """Expand per-literal streams to 4 lanes: [switch type, switch count,
    switch count extra, literal]. Switches fire before the first literal
    of each block after the first."""
    nlit = len(lit_vals)
    v = np.zeros((nlit, 4), np.int64)
    b = np.zeros((nlit, 4), np.int64)
    v[:, 3] = lit_vals
    b[:, 3] = lit_bits
    at = np.cumsum(sw["block_lengths"])[:-1]
    tsyms = sw["tsyms"]
    v[at, 0] = sw["type_codes"][tsyms]
    b[at, 0] = sw["type_bits"][tsyms]
    cc = sw["ccode"][1:]
    v[at, 1] = sw["cnt_codes"][cc]
    b[at, 1] = sw["cnt_bits"][cc]
    v[at, 2] = sw["cextra"][1:]
    b[at, 2] = sw["cbits"][1:]
    return v, b


# backwards-compatible alias used by tests/tools
def _run_positions(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Absolute position of every literal (parallel to _gather_runs)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lengths)
    out_start = ends - lengths
    idx = np.arange(total, dtype=np.int64)
    run_id = np.searchsorted(ends, idx, side="right")
    return starts[run_id] + (idx - out_start[run_id])


def _as_arrays(cmds):
    if isinstance(cmds, tuple) and isinstance(cmds[0], np.ndarray):
        if len(cmds) == 4:
            return cmds
        return (*cmds, np.zeros(len(cmds[0]), np.int64))
    if len(cmds) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    a = np.asarray(cmds, dtype=np.int64)
    if a.shape[1] == 3:
        return a[:, 0], a[:, 1], a[:, 2], np.zeros(len(a), np.int64)
    return a[:, 0], a[:, 1], a[:, 2], a[:, 3]


def _gather_runs(data: np.ndarray, starts: np.ndarray,
                 lengths: np.ndarray) -> np.ndarray:
    """Concatenate data[starts[k]:starts[k]+lengths[k]] for all k."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.uint8)
    # index arithmetic: for each output slot, its source position
    ends = np.cumsum(lengths)
    out_start = ends - lengths
    idx = np.arange(total, dtype=np.int64)
    run_id = np.searchsorted(ends, idx, side="right")
    src = starts[run_id] + (idx - out_start[run_id])
    return data[src]


def _interleave_symbols(plan, lit_stream, lanes, cmd_stream, dist_stream,
                        cmd_sw=None, dist_sw=None):
    """Build the metablock body (value, nbits) stream in decode order:
    per command: [cmd block switch] cmd sym, insert extra, copy extra,
    literals (each with optional literal-switch lanes), [dist block
    switch] dist sym, dist extra. cmd/dist streams come per-command,
    already tree-selected; zero-bit slots vanish in the bit writer."""
    lit_vals_in, lit_bits_in = lit_stream
    ins = plan["ins"]
    n = len(ins)
    nlit = lit_vals_in.shape[0]
    total = n * 11 + nlit * lanes
    values = np.zeros(total, dtype=np.int64)
    nbits = np.zeros(total, dtype=np.int64)
    # record: 3 cmd-switch slots + 3 fixed + ins*lanes + 3 dist-switch
    # slots + 2 dist slots
    rec_len = 11 + ins * lanes
    rec_start = np.concatenate([[0], np.cumsum(rec_len)[:-1]]).astype(
        np.int64)
    if cmd_sw is not None:
        at, sw = cmd_sw
        slots = rec_start[at]
        tsyms = sw["tsyms"]
        values[slots] = sw["type_codes"][tsyms]
        nbits[slots] = sw["type_bits"][tsyms]
        cc = sw["ccode"][1:]
        values[slots + 1] = sw["cnt_codes"][cc]
        nbits[slots + 1] = sw["cnt_bits"][cc]
        values[slots + 2] = sw["cextra"][1:]
        nbits[slots + 2] = sw["cbits"][1:]
    cmd_vals, cmd_bits = cmd_stream
    values[rec_start + 3] = cmd_vals
    nbits[rec_start + 3] = cmd_bits
    iv, ib = plan["insert_extras"]
    values[rec_start + 4] = iv
    nbits[rec_start + 4] = ib
    cv, cb = plan["copy_extras"]
    values[rec_start + 5] = cv
    nbits[rec_start + 5] = cb
    # literals (each `lanes` slots wide) at rec_start + 6 + k*lanes
    if nlit:
        ends = np.cumsum(ins)
        out_start = ends - ins
        idx = np.arange(nlit, dtype=np.int64)
        run_id = np.searchsorted(ends, idx, side="right")
        slot0 = rec_start[run_id] + 6 + (idx - out_start[run_id]) * lanes
        if lanes == 1:
            values[slot0] = lit_vals_in
            nbits[slot0] = lit_bits_in
        else:
            for c in range(lanes):
                values[slot0 + c] = lit_vals_in[:, c]
                nbits[slot0 + c] = lit_bits_in[:, c]
    # distances at record end
    dslot = rec_start + 6 + ins * lanes
    if dist_sw is not None:
        at, sw = dist_sw
        slots = dslot[at]
        tsyms = sw["tsyms"]
        values[slots] = sw["type_codes"][tsyms]
        nbits[slots] = sw["type_bits"][tsyms]
        cc = sw["ccode"][1:]
        values[slots + 1] = sw["cnt_codes"][cc]
        nbits[slots + 1] = sw["cnt_bits"][cc]
        values[slots + 2] = sw["cextra"][1:]
        nbits[slots + 2] = sw["cbits"][1:]
    dist_vals, dist_bits = dist_stream
    has = plan["has_dist"]
    values[dslot + 3] = np.where(has, dist_vals, 0)
    nbits[dslot + 3] = np.where(has, dist_bits, 0)
    dv, db = plan["dist_extras"]
    values[dslot + 4] = np.where(has, dv, 0)
    nbits[dslot + 4] = np.where(has, db, 0)
    return values, nbits
