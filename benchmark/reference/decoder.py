"""RFC 7932 decoder: the benchmark's plain reference.

A frozen copy of the pure-NumPy decoder of `brotli_tpu_torch/dec/
decoder.py` (itself a spec-driven, from-scratch decoder), with its
imports pointed inside this folder. It imports nothing of the measured
program, so a later change to the program cannot move the yardstick
that judges its streams. Every metablock is parsed into (commands,
literals) and the LZ and dictionary expansion runs over plain byte
buffers.

Parity anchors (behavior, not code): c/dec/decode.c (state machine),
c/dec/bit_reader.h, RFC 7932 sections 2-10.
"""

import numpy as np

from . import constants as C
from . import context as ctx
from . import dictionary as dict_mod
from . import prefix
from .bitio import BitReader, NeedMoreInput  # noqa: F401
from .huffman import DecodeTable, simple_table
from .errors import DecoderError as E


class FormatError(Exception):
    """Invalid Brotli stream. `code` identifies the failure precisely,
    mirroring the reference's BrotliDecoderErrorCode values
    (dec/errors.py; c/include/brotli/decode.h:64-105)."""

    def __init__(self, message, code=None):
        super().__init__(message)
        from .errors import DecoderError
        self.code = DecoderError(code) if code is not None else \
            DecoderError.UNREACHABLE


def _read_varlen_uint8(br: BitReader) -> int:
    """1..11 bit encoding of 0..255 (RFC 9.2 NBLTYPES)."""
    if not br.take(1):
        return 0
    n = br.take(3)
    if n == 0:
        return 1
    return (1 << n) + br.take(n)


def _read_window_bits(br: BitReader, large_window: bool) -> tuple:
    """Returns (window_bits, is_large)."""
    if br.take(1) == 0:
        return 16, False
    n = br.take(3)
    if n != 0:
        return 17 + n, False
    n = br.take(3)
    if n == 1:
        if not large_window:
            raise FormatError("large-window stream, flag not set", E.WINDOW_BITS)
        if br.take(1) == 1:
            raise FormatError("invalid large window bits", E.WINDOW_BITS)
        return br.take(6), True
    if n != 0:
        return 8 + n, False
    return 17, False


def read_huffman_code(br: BitReader, alphabet_size_max: int,
                      alphabet_size_limit: int = None) -> DecodeTable:
    """RFC 3.4/3.5: simple or complex prefix-code description."""
    if alphabet_size_limit is None:
        alphabet_size_limit = alphabet_size_max
    kind = br.take(2)
    if kind == 1:  # simple code
        num_symbols = br.take(2) + 1
        max_bits = (alphabet_size_max - 1).bit_length()
        symbols = [br.take(max_bits) for _ in range(num_symbols)]
        for s in symbols:
            if s >= alphabet_size_limit:
                raise FormatError("simple code symbol out of range", E.SIMPLE_HUFFMAN_ALPHABET)
        if len(set(symbols)) != num_symbols:
            raise FormatError("duplicate symbol in simple code", E.SIMPLE_HUFFMAN_SAME)
        tree_select = bool(br.take(1)) if num_symbols == 4 else False
        return simple_table(symbols, tree_select, alphabet_size_limit)

    # complex code: `kind` = number of leading cl-code slots to skip
    cl_table = _read_code_length_code_with_skip(br, kind)
    lengths = np.zeros(alphabet_size_limit, dtype=np.int32)
    space = 32768
    symbol = 0
    prev_len = C.INITIAL_REPEATED_CODE_LENGTH
    repeat = 0
    repeat_len = 0
    while symbol < alphabet_size_limit and space > 0:
        code_len = br.read_symbol(cl_table)
        if code_len < C.REPEAT_PREVIOUS_CODE_LENGTH:
            repeat = 0
            if code_len != 0:
                lengths[symbol] = code_len
                prev_len = code_len
                space -= 32768 >> code_len
            symbol += 1
        else:
            if code_len == C.REPEAT_PREVIOUS_CODE_LENGTH:
                extra_bits, new_len = 2, prev_len
            else:
                extra_bits, new_len = 3, 0
            if repeat_len != new_len:
                repeat = 0
                repeat_len = new_len
            old_repeat = repeat
            if repeat > 0:
                repeat = (repeat - 2) << extra_bits
            repeat += br.take(extra_bits) + 3
            delta = repeat - old_repeat
            if symbol + delta > alphabet_size_limit:
                raise FormatError("repeat overruns alphabet", E.HUFFMAN_SPACE)
            if repeat_len != 0:
                lengths[symbol:symbol + delta] = repeat_len
                space -= delta << (15 - repeat_len)
            symbol += delta
    if space != 0:
        raise FormatError("prefix code over/under-subscribed", E.HUFFMAN_SPACE)
    return DecodeTable(lengths)


def _read_code_length_code_with_skip(br: BitReader, skip: int) -> DecodeTable:
    lengths = np.zeros(C.CODE_LENGTH_CODES, dtype=np.int32)
    space = 32
    num_codes = 0
    fixed = {}
    for sym, (code, ln) in C.CODE_LENGTH_CODE_FIXED.items():
        for pad in range(1 << (4 - ln)):
            fixed[code | (pad << ln)] = (sym, ln)
    for idx in C.CODE_LENGTH_CODE_ORDER[skip:]:
        v, ln = fixed[br.peek(4)]
        br.skip(ln)
        lengths[idx] = v
        if v != 0:
            space -= 32 >> v
            num_codes += 1
            if space <= 0:  # filled (or over-subscribed -> error below)
                break
    if not (num_codes == 1 or space == 0):
        raise FormatError("code-length code space", E.CL_SPACE)
    if num_codes == 1:
        sym = int(np.flatnonzero(lengths)[0])
        t = DecodeTable.__new__(DecodeTable)
        t.max_len = 0
        t.symbols = np.array([sym], dtype=np.int32)
        t.nbits = np.zeros(1, dtype=np.int8)
        return t
    return DecodeTable(lengths, max_len=C.HUFFMAN_MAX_CODE_LENGTH_CODE_LENGTH)


def _inverse_mtf(values: np.ndarray) -> np.ndarray:
    mtf = list(range(256))
    out = np.empty_like(values)
    for i, x in enumerate(values):
        v = mtf.pop(int(x))
        out[i] = v
        mtf.insert(0, v)
    return out


def read_context_map(br: BitReader, size: int) -> tuple:
    """RFC 7.3. Returns (context_map uint8[size], num_htrees)."""
    num_htrees = _read_varlen_uint8(br) + 1
    cmap = np.zeros(size, dtype=np.uint8)
    if num_htrees <= 1:
        return cmap, num_htrees
    use_rle = br.take(1)
    max_run_length_prefix = (br.take(4) + 1) if use_rle else 0
    alphabet = num_htrees + max_run_length_prefix
    table = read_huffman_code(br, alphabet)
    i = 0
    while i < size:
        code = br.read_symbol(table)
        if code == 0:
            cmap[i] = 0
            i += 1
        elif code <= max_run_length_prefix:
            reps = (1 << code) + br.take(code)
            if i + reps > size:
                raise FormatError("context map run overruns", E.CONTEXT_MAP_REPEAT)
            cmap[i:i + reps] = 0
            i += reps
        else:
            cmap[i] = code - max_run_length_prefix
            i += 1
    if br.take(1):
        cmap = _inverse_mtf(cmap)
    return cmap, num_htrees


class _BlockState:
    """Per-category (literal/command/distance) block switching state."""

    __slots__ = ("num_types", "type_rb", "length", "type_table", "len_table")

    def __init__(self, br: BitReader):
        self.num_types = _read_varlen_uint8(br) + 1
        self.type_rb = [1, 0]
        self.length = 1 << 28
        self.type_table = None
        self.len_table = None
        if self.num_types >= 2:
            self.type_table = read_huffman_code(br, self.num_types + 2)
            self.len_table = read_huffman_code(br, C.NUM_BLOCK_LEN_SYMBOLS)
            self.length = self._read_block_length(br)

    def _read_block_length(self, br: BitReader) -> int:
        code = br.read_symbol(self.len_table)
        return int(prefix.BLOCK_COUNT_BASE[code]) + \
            br.take(int(prefix.BLOCK_COUNT_EXTRA[code]))

    def switch(self, br: BitReader) -> int:
        """Read a block-switch command; returns new block type."""
        if self.num_types <= 1:
            raise FormatError("block switch with single block type", E.BLOCK_SWITCH)
        bt = br.read_symbol(self.type_table)
        self.length = self._read_block_length(br)
        if bt == 0:
            bt = self.type_rb[0]
        elif bt == 1:
            bt = self.type_rb[1] + 1
        else:
            bt -= 2
        if bt >= self.num_types:
            bt -= self.num_types
        self.type_rb = [self.type_rb[1], bt]
        return bt


class Decoder:
    """One-shot / incremental RFC 7932 decoder.

    `dictionary`: optional raw LZ77 (compound) dictionary -- distances
    just beyond the window reach into it (parity:
    BrotliDecoderAttachDictionary + decode.c compound branch).
    """

    def __init__(self, large_window: bool = False, dictionary=None,
                 shared=None):
        self.large_window = large_window
        self.compound = bytes(dictionary) if dictionary else b""
        # serialized shared dictionary (format/shared_dictionary.py):
        # raw prefixes become compound data, custom word/transform
        # lists replace the static dictionary per literal context
        self.shared = shared
        if shared is not None:
            self.compound = b"".join(shared.prefixes) + self.compound
        # optional stream-anatomy trace (dissector/diagnostics): when a
        # list, every command appends (insert_len, copy_len, distance,
        # dist_code, position) -- cf. research/brotlidump.py's role
        self.trace = None
        # metadata hook (parity: BrotliDecoderSetMetadataCallbacks,
        # c/include/brotli/decode.h:398): called with each metadata
        # block's content bytes
        self.metadata_callback = None
        # structural-anatomy hook (dissector): when a list, each
        # metablock appends a dict of header fields (mlen, block
        # types, npostfix/ndirect, tree counts, header bit span)
        self.structure = None
        # per-category bit accounting (dissector): when a dict, every
        # bit consumed is attributed to a category (block_headers,
        # dist_params, cmap_lit/cmap_dist, trees_lit/cmd/dist,
        # cmd_syms, lits, dist_syms, switches) -- the per-bit field
        # breakdown role of research/brotlidump.py
        self.bit_account = None
        # per-FIELD bit dump (dissector --bits): when a list, every
        # header field and command appends (bit0, bit1, label, value)
        # -- the research/brotlidump.py print-every-field role
        self.field_trace = None
        # deferred-LZ mode (dec/device_decode.py): when a dict with
        # keys {lits: bytearray, nlit/ncopy/dist: lists}, the command
        # loop decodes SYMBOLS only and records the copy graph instead
        # of resolving it -- the device kernel resolves copies by
        # log-step pointer doubling. Context-modeled literal trees are
        # supported: the only output bytes a literal decode needs are
        # the two previous ones (RFC 7932 7.1), which _dz_byte_at
        # resolves exactly on the host by chasing the copy graph --
        # the bulk byte movement still stays deferred.
        self.defer_lz = None
        self._virtual_len = 0
        self._dz_ends = []      # cumulative output pos after command k
        self._dz_lstarts = []   # literal-stream offset of command k
        self._dz_nlit_total = 0
        self._dz_cache = {}     # resolved byte per chased position
        self._dz_p12 = (0, 0)   # (p1, p2) context bytes across blocks

    def _ft(self, bit0, bit1, label, value):
        if self.field_trace is not None:
            self.field_trace.append((bit0, bit1, label, value))

    def decompress(self, data) -> bytes:
        out, _ = self._decompress_impl(data, allow_trailing=False)
        return out

    def decompress_prefix(self, data):
        """Decode one stream; returns (output, bytes consumed) and
        tolerates trailing data (concatenated streams, brcat)."""
        return self._decompress_impl(data, allow_trailing=True)

    def _decompress_impl(self, data, allow_trailing: bool):
        br = BitReader(data)
        out = bytearray()
        state = self._read_stream_header(br)
        done = False
        while not done:
            done = self._one_metablock(br, out, state)
        pad = br.align_to_byte()
        if pad != 0:
            raise FormatError("non-zero stream padding", E.PADDING_1)
        # Trailing garbage check: remaining bytes must be absent.
        if not allow_trailing and br.available() >= 8:
            raise FormatError("trailing data after last metablock", E.PADDING_2)
        return bytes(out), br.bitpos // 8

    def _read_stream_header(self, br) -> dict:
        b0 = br.bitpos
        window_bits, is_large = _read_window_bits(br, self.large_window)
        self._ft(b0, br.bitpos, "WBITS", window_bits)
        if not is_large and not (10 <= window_bits <= 24):
            raise FormatError(f"bad window bits {window_bits}", E.WINDOW_BITS)
        if is_large and not (C.LARGE_MIN_WINDOW_BITS <= window_bits
                             <= C.LARGE_MAX_WINDOW_BITS):
            raise FormatError(f"bad large window bits {window_bits}", E.WINDOW_BITS)
        return {
            "max_backward": (1 << window_bits) - C.WINDOW_GAP,
            "is_large": is_large,
            "dist_rb": list(C.INITIAL_DISTANCE_RB),
            "rb_idx": 0,
        }

    def _one_metablock(self, br, out, state) -> bool:
        """Decode one metablock; returns True when the stream ended.
        Raises NeedMoreInput on truncation (resumable: re-enter with
        the same `state` and a reader positioned at the same bit)."""
        b0 = br.bitpos
        is_last = br.take(1)
        self._ft(b0, br.bitpos, "ISLAST", is_last)
        if is_last:
            b0 = br.bitpos
            if br.take(1):  # ISLASTEMPTY
                self._ft(b0, br.bitpos, "ISLASTEMPTY", 1)
                return True
            self._ft(b0, br.bitpos, "ISLASTEMPTY", 0)
        b0 = br.bitpos
        mnibbles = br.take(2) + 4
        self._ft(b0, br.bitpos, "MNIBBLES", mnibbles)
        if mnibbles == 7:  # metadata block
            if br.take(1):
                raise FormatError("reserved bit set", E.RESERVED)
            skip_bytes = br.take(2)
            mlen = 0
            for i in range(skip_bytes):
                b = br.take(8)
                if i + 1 == skip_bytes and skip_bytes > 1 and b == 0:
                    raise FormatError("exuberant metadata nibble", E.EXUBERANT_META_NIBBLE)
                mlen |= b << (i * 8)
            if skip_bytes:
                mlen += 1
            if br.align_to_byte() != 0:
                raise FormatError("non-zero metadata padding",
                                  E.PADDING_1)
            meta = br.read_bytes(mlen)
            if self.metadata_callback is not None:
                self.metadata_callback(bytes(meta))
            return bool(is_last)
        mlen = 0
        b0 = br.bitpos
        for i in range(mnibbles):
            nib = br.take(4)
            if i + 1 == mnibbles and mnibbles > 4 and nib == 0:
                raise FormatError("exuberant nibble", E.EXUBERANT_NIBBLE)
            mlen |= nib << (i * 4)
        mlen += 1
        self._ft(b0, br.bitpos, "MLEN", mlen)
        b0 = br.bitpos
        is_uncompressed = 0 if is_last else br.take(1)
        if not is_last:
            self._ft(b0, br.bitpos, "ISUNCOMPRESSED", is_uncompressed)
        if is_uncompressed:
            pad = br.align_to_byte()
            if pad != 0:
                raise FormatError("non-zero padding", E.PADDING_1)
            raw = br.read_bytes(mlen)
            if self.defer_lz is not None:
                # raw bytes are pre-resolved: a literal run for the
                # device kernel
                self.defer_lz["lits"].extend(raw)
                self._dz_emit(mlen, 0, 0)
                self._virtual_len += mlen
                if mlen >= 2:
                    self._dz_p12 = (raw[-1], raw[-2])
                elif mlen == 1:
                    self._dz_p12 = (raw[-1], self._dz_p12[0])
            else:
                out += raw
            return False
        state["rb_idx"] = self._metablock(
            br, out, mlen, state["max_backward"], state["dist_rb"],
            state["rb_idx"], state["is_large"])
        return bool(is_last)

    # -- compressed metablock ------------------------------------------------

    def _metablock(self, br, out, mlen, max_backward, dist_rb, rb_idx,
                   is_large) -> int:
        hdr_bit0 = br.bitpos
        acct = self.bit_account
        if acct is not None:
            def _acc(cat, t0):
                acct[cat] = acct.get(cat, 0) + (br.bitpos - t0)
                return br.bitpos
            t = hdr_bit0
        blocks = []
        for cat in ("L", "I", "D"):
            b0 = br.bitpos
            bs = _BlockState(br)
            self._ft(b0, br.bitpos, f"NBLTYPES{cat}+trees", bs.num_types)
            blocks.append(bs)
        if acct is not None:
            t = _acc("block_headers", t)
        b0 = br.bitpos
        npostfix = br.take(2)
        ndirect = br.take(4) << npostfix
        self._ft(b0, br.bitpos, "NPOSTFIX/NDIRECT", (npostfix, ndirect))
        b0 = br.bitpos
        context_modes = [br.take(2) for _ in range(blocks[0].num_types)]
        self._ft(b0, br.bitpos, "CMODE[]", context_modes)
        if acct is not None:
            t = _acc("dist_params", t)
        b0 = br.bitpos
        lit_cmap, n_lit_trees = read_context_map(
            br, blocks[0].num_types << C.LITERAL_CONTEXT_BITS)
        self._ft(b0, br.bitpos, "CMAPL", f"{n_lit_trees} trees")
        if acct is not None:
            t = _acc("cmap_lit", t)
        b0 = br.bitpos
        dist_cmap, n_dist_trees = read_context_map(
            br, blocks[2].num_types << C.DISTANCE_CONTEXT_BITS)
        self._ft(b0, br.bitpos, "CMAPD", f"{n_dist_trees} trees")
        if acct is not None:
            t = _acc("cmap_dist", t)
        lit_trees = []
        for ti in range(n_lit_trees):
            b0 = br.bitpos
            lit_trees.append(read_huffman_code(br, C.NUM_LITERAL_SYMBOLS))
            self._ft(b0, br.bitpos, f"HTREEL[{ti}]", None)
        if acct is not None:
            t = _acc("trees_lit", t)
        cmd_trees = []
        for ti in range(blocks[1].num_types):
            b0 = br.bitpos
            cmd_trees.append(read_huffman_code(br, C.NUM_COMMAND_SYMBOLS))
            self._ft(b0, br.bitpos, f"HTREEI[{ti}]", None)
        if acct is not None:
            t = _acc("trees_cmd", t)
        maxnbits = (C.LARGE_MAX_DISTANCE_BITS if is_large
                    else C.MAX_DISTANCE_BITS)
        dist_alpha = C.distance_alphabet_size(npostfix, ndirect, maxnbits)
        dist_trees = []
        for ti in range(n_dist_trees):
            b0 = br.bitpos
            dist_trees.append(read_huffman_code(br, dist_alpha))
            self._ft(b0, br.bitpos, f"HTREED[{ti}]", None)
        if acct is not None:
            t = _acc("trees_dist", t)
        if self.structure is not None:
            self.structure.append({
                "mlen": mlen,
                "nbltypes": [b.num_types for b in blocks],
                "npostfix": npostfix, "ndirect": ndirect,
                "context_modes": context_modes,
                "n_lit_trees": n_lit_trees,
                "n_dist_trees": n_dist_trees,
                "header_bits": br.bitpos - hdr_bit0,
                "data_bit0": br.bitpos,
            })
        dist_extra, dist_offset = prefix.distance_lut(
            npostfix, ndirect, maxnbits)
        cmd_lut = prefix.cmd_lut()

        lit_block, cmd_block, dist_block = 0, 0, 0
        lit_lut = ctx.context_lut(context_modes[0])
        if self.defer_lz is not None:
            return self._metablock_deferred(
                br, mlen, max_backward, dist_rb, rb_idx, blocks,
                lit_cmap, lit_trees, cmd_trees, dist_trees, dist_cmap,
                dist_extra, dist_offset, npostfix, cmd_lut,
                context_modes)
        remaining = mlen
        while remaining > 0:
            # --- command symbol
            cmd_bit0 = br.bitpos
            if acct is not None:
                t = br.bitpos
            if blocks[1].length == 0:
                cmd_block = blocks[1].switch(br)
                if acct is not None:
                    t = _acc("switches", t)
            blocks[1].length -= 1
            tbl = cmd_trees[cmd_block]
            sym = br.read_symbol(tbl)
            insert_len = int(cmd_lut["insert_base"][sym]) + \
                br.take(int(cmd_lut["insert_extra"][sym]))
            copy_len = int(cmd_lut["copy_base"][sym]) + \
                br.take(int(cmd_lut["copy_extra"][sym]))
            implicit_dist0 = bool(cmd_lut["implicit_dist0"][sym])
            dctx = int(cmd_lut["dist_context"][sym])
            if acct is not None:
                t = _acc("cmd_syms", t)

            # --- literals
            for _ in range(insert_len):
                if blocks[0].length == 0:
                    if acct is not None:
                        t = _acc("lits", t)  # pending run so far
                    lit_block = blocks[0].switch(br)
                    lit_lut = ctx.context_lut(context_modes[lit_block])
                    if acct is not None:
                        t = _acc("switches", t)
                blocks[0].length -= 1
                p1 = out[-1] if out else 0
                p2 = out[-2] if len(out) >= 2 else 0
                c = int(lit_lut[0][p1] | lit_lut[1][p2])
                tree = lit_trees[lit_cmap[
                    (lit_block << C.LITERAL_CONTEXT_BITS) + c]]
                lit = br.read_symbol(tree)
                out.append(lit)
            if acct is not None and insert_len:
                t = _acc("lits", t)
            remaining -= insert_len
            if remaining <= 0:
                if self.trace is not None:
                    self.trace.append((insert_len, 0, 0, -2, len(out)))
                self._ft(cmd_bit0, br.bitpos, "CMD",
                         (insert_len, 0, 0, -2))
                break

            # --- distance
            max_distance = min(len(out), max_backward)
            if implicit_dist0:
                distance = dist_rb[(rb_idx - 1) & 3]
                dist_code_is_zero = True
            else:
                if blocks[2].length == 0:
                    if acct is not None:
                        t = br.bitpos
                    dist_block = blocks[2].switch(br)
                    if acct is not None:
                        t = _acc("switches", t)
                blocks[2].length -= 1
                dtree = dist_trees[dist_cmap[
                    (dist_block << C.DISTANCE_CONTEXT_BITS) + dctx]]
                dcode = br.read_symbol(dtree)
                dist_code_is_zero = (dcode == 0)
                if dcode < C.NUM_DISTANCE_SHORT_CODES:
                    ring, delta = prefix.DISTANCE_SHORT_CODES[dcode]
                    distance = dist_rb[(rb_idx - 1 - ring) & 3] + delta
                    if distance <= 0:
                        raise FormatError("non-positive short-code distance", E.DISTANCE)
                else:
                    extra = br.take(int(dist_extra[dcode]))
                    distance = int(dist_offset[dcode]) + (extra << npostfix)
                if acct is not None:
                    t = _acc("dist_syms", t)

            if self.trace is not None:
                self.trace.append((
                    insert_len, copy_len, distance,
                    -1 if implicit_dist0 else dcode, len(out)))
            self._ft(cmd_bit0, br.bitpos, "CMD",
                     (insert_len, copy_len, distance,
                      -1 if implicit_dist0 else dcode))
            if distance > max_distance:
                if distance > C.MAX_ALLOWED_DISTANCE:
                    raise FormatError("distance too large", E.DISTANCE)
                address = distance - max_distance - 1
                csize = len(self.compound)
                if address < csize:
                    # compound (raw attached) dictionary reference; unlike
                    # static-dict words these DO update the distance ring
                    # (decode.c InitializeCompoundDictionaryCopy)
                    start = csize - (address + 1)
                    if start + copy_len > csize:
                        raise FormatError("compound reference overruns", E.COMPOUND_DICTIONARY)
                    if not dist_code_is_zero:
                        dist_rb[rb_idx & 3] = distance
                        rb_idx += 1
                    out += self.compound[start:start + copy_len]
                    remaining -= copy_len
                else:
                    if self.shared is not None:
                        from . import shared_dictionary as shd
                        word = shd.decode_reference(
                            self.shared, copy_len, address - csize,
                            out[-1] if out else 0,
                            out[-2] if len(out) >= 2 else 0, lit_lut)
                    else:
                        word = dict_mod.decode_reference(
                            copy_len, address - csize)
                    if word is None:
                        raise FormatError("invalid dictionary reference", E.DICTIONARY)
                    out += word
                    remaining -= len(word)
            else:
                if not dist_code_is_zero:
                    dist_rb[rb_idx & 3] = distance
                    rb_idx += 1
                # overlapping copy: byte-serial semantics
                start = len(out) - distance
                if copy_len <= distance:
                    out += out[start:start + copy_len]
                else:
                    for k in range(copy_len):
                        out.append(out[start + k])
                remaining -= copy_len
        if remaining < 0:
            raise FormatError("metablock length overrun", E.BLOCK_LENGTH_1)
        return rb_idx

    def _dz_emit(self, nlit: int, ncopy: int, dist: int):
        """Append one command to the deferred copy graph, keeping the
        cumulative position/literal-offset indexes in lockstep (they
        drive the host-side _dz_byte_at context peeks)."""
        D = self.defer_lz
        D["nlit"].append(nlit)
        D["ncopy"].append(ncopy)
        D["dist"].append(dist)
        prev = self._dz_ends[-1] if self._dz_ends else 0
        self._dz_ends.append(prev + nlit + ncopy)
        self._dz_lstarts.append(self._dz_nlit_total)
        self._dz_nlit_total += nlit

    def _dz_byte_at(self, i: int) -> int:
        """Exact output byte at virtual position `i`, resolved on the
        host by chasing the deferred copy graph. Overlapping copies
        (dist < len, the RLE chains) collapse in ONE step with a
        modulo jump, so each query is O(#commands crossed), not
        O(bytes). Only the <=2 context bytes a literal needs (RFC
        7932 7.1) are ever queried; bulk byte movement stays on the
        device (ops/lz_resolve.py)."""
        from bisect import bisect_right
        D = self.defer_lz
        ends, nlit, dist = self._dz_ends, D["nlit"], D["dist"]
        lits, lstarts = D["lits"], self._dz_lstarts
        cache = self._dz_cache  # the graph is append-only, so
        path = []               # resolved bytes stay valid forever
        while True:
            val = cache.get(i)
            if val is not None:
                break
            k = bisect_right(ends, i)
            base = ends[k - 1] if k else 0
            off = i - base
            nl = nlit[k]
            if off < nl:
                val = lits[lstarts[k] + off]
                break
            # every position on the chase resolves to the SAME byte:
            # memoize the whole path so adversarial tail-chains (each
            # copy tail sourcing the previous copy's tail) stay O(1)
            # amortized instead of O(commands crossed) per peek
            path.append(i)
            j = off - nl
            d = dist[k]
            i = base + nl + (j % d) - d
        cache[i] = val
        for p in path:
            cache[p] = val
        return val

    def _metablock_deferred(self, br, mlen, max_backward, dist_rb,
                            rb_idx, blocks, lit_cmap, lit_trees,
                            cmd_trees, dist_trees, dist_cmap,
                            dist_extra, dist_offset, npostfix,
                            cmd_lut, context_modes):
        """Symbol-only command loop (deferred LZ): emits the copy
        graph into self.defer_lz for device-side resolution
        (ops/lz_resolve.py). The reference's hot loop
        (c/dec/decode.c:2401 ProcessCommands) fuses symbol decode and
        byte movement; on the card the byte movement is the parallel half.

        Context-modeled literal trees are supported WITHOUT resolving
        the output: a literal decode needs only the two previous
        output bytes (p1, p2), which are literals we already hold or
        the trailing 1-2 bytes of the preceding copy -- _dz_byte_at
        chases exactly those through the copy graph (reference role:
        c/dec/decode.c:2076-2150 context re-computation, re-split so
        the byte movement stays data-parallel)."""
        if self.compound or self.shared is not None:
            raise UnsupportedForDevice("attached dictionaries")
        D = self.defer_lz
        lits = D["lits"]
        lit_block = cmd_block = dist_block = 0
        lit_lut = ctx.context_lut(context_modes[0])
        cmap_base = 0  # lit_block << LITERAL_CONTEXT_BITS
        p1, p2 = self._dz_p12
        remaining = mlen
        vlen = self._virtual_len
        while remaining > 0:
            if blocks[1].length == 0:
                cmd_block = blocks[1].switch(br)
            blocks[1].length -= 1
            tbl = cmd_trees[cmd_block]
            sym = br.read_symbol(tbl)
            insert_len = int(cmd_lut["insert_base"][sym]) +                 br.take(int(cmd_lut["insert_extra"][sym]))
            copy_len = int(cmd_lut["copy_base"][sym]) +                 br.take(int(cmd_lut["copy_extra"][sym]))
            implicit_dist0 = bool(cmd_lut["implicit_dist0"][sym])
            dctx = int(cmd_lut["dist_context"][sym])
            nlit_cmd = insert_len
            for _ in range(insert_len):
                if blocks[0].length == 0:
                    lit_block = blocks[0].switch(br)
                    lit_lut = ctx.context_lut(context_modes[lit_block])
                    cmap_base = lit_block << C.LITERAL_CONTEXT_BITS
                blocks[0].length -= 1
                c = int(lit_lut[0][p1] | lit_lut[1][p2])
                tree = lit_trees[lit_cmap[cmap_base + c]]
                lit = br.read_symbol(tree)
                lits.append(lit)
                p2, p1 = p1, lit
            vlen += insert_len
            remaining -= insert_len
            if remaining <= 0:
                self._dz_emit(nlit_cmd, 0, 0)
                break
            max_distance = min(vlen, max_backward)
            if implicit_dist0:
                distance = dist_rb[(rb_idx - 1) & 3]
                dist_code_is_zero = True
            else:
                if blocks[2].length == 0:
                    dist_block = blocks[2].switch(br)
                blocks[2].length -= 1
                dtree = dist_trees[dist_cmap[
                    (dist_block << C.DISTANCE_CONTEXT_BITS) + dctx]]
                dcode = br.read_symbol(dtree)
                dist_code_is_zero = (dcode == 0)
                if dcode < C.NUM_DISTANCE_SHORT_CODES:
                    ring, delta = prefix.DISTANCE_SHORT_CODES[dcode]
                    distance = dist_rb[(rb_idx - 1 - ring) & 3] + delta
                    if distance <= 0:
                        raise FormatError(
                            "non-positive short-code distance",
                            E.DISTANCE)
                else:
                    extra = br.take(int(dist_extra[dcode]))
                    distance = int(dist_offset[dcode]) +                         (extra << npostfix)
            if distance > max_distance:
                if distance > C.MAX_ALLOWED_DISTANCE:
                    raise FormatError("distance too large", E.DISTANCE)
                word = dict_mod.decode_reference(
                    copy_len, distance - max_distance - 1)
                if word is None:
                    raise FormatError("invalid dictionary reference",
                                      E.DICTIONARY)
                # fold the expanded word into the literal stream: a
                # dictionary reference has no in-window source, so the
                # device kernel treats its bytes as resolved
                lits.extend(word)
                nlit_cmd += len(word)
                vlen += len(word)
                remaining -= len(word)
                self._dz_emit(nlit_cmd, 0, 0)
                if len(word) >= 2:
                    p2, p1 = word[-2], word[-1]
                elif len(word) == 1:
                    p2, p1 = p1, word[-1]
            else:
                if not dist_code_is_zero:
                    dist_rb[rb_idx & 3] = distance
                    rb_idx += 1
                vlen += copy_len
                remaining -= copy_len
                self._dz_emit(nlit_cmd, copy_len, distance)
                old_p1 = p1
                p1 = self._dz_byte_at(vlen - 1)
                p2 = self._dz_byte_at(vlen - 2) if copy_len >= 2 \
                    else old_p1
        if remaining < 0:
            raise FormatError("metablock length overrun",
                              E.BLOCK_LENGTH_1)
        self._virtual_len = vlen
        self._dz_p12 = (p1, p2)
        return rb_idx


class UnsupportedForDevice(Exception):
    """Stream shape the deferred-LZ device pipeline cannot decode
    (context-modeled literals or attached dictionaries); callers fall
    back to the host decoder."""


class IncrementalDecoder:
    """Push-style resumable decoder (role parity: the reference's
    suspend-anywhere streaming decoder, c/dec/decode.c
    BrotliDecoderDecompressStream -- re-designed at metablock
    granularity: state snapshots at metablock boundaries instead of a
    27-state bit-level machine; NEEDS_MORE_INPUT == NeedMoreInput)."""

    def __init__(self, large_window: bool = False, dictionary=None):
        self._dec = Decoder(large_window=large_window,
                            dictionary=dictionary)
        self._buf = bytearray()
        self._bitpos = 0        # after last complete metablock
        self._state = None
        self._out = bytearray()
        self._emitted = 0
        self.finished = False

    def feed(self, chunk: bytes) -> bytes:
        """Absorb input, return newly decoded output (possibly b'')."""
        if self.finished:
            if chunk:
                raise FormatError("data after stream end", E.PADDING_2)
            return b""
        self._buf += chunk
        br = BitReader(bytes(self._buf))
        br.bitpos = self._bitpos
        if self._state is None:
            try:
                self._state = self._dec._read_stream_header(br)
                self._bitpos = br.bitpos
            except NeedMoreInput:
                return b""
        while not self.finished:
            snap_len = len(self._out)
            snap_rb = list(self._state["dist_rb"])
            snap_idx = self._state["rb_idx"]
            snap_bit = br.bitpos
            try:
                done = self._dec._one_metablock(br, self._out,
                                                self._state)
            except NeedMoreInput:
                del self._out[snap_len:]
                self._state["dist_rb"] = snap_rb
                self._state["rb_idx"] = snap_idx
                br.bitpos = snap_bit
                break
            self._bitpos = br.bitpos
            if done:
                self.finished = True
        new = bytes(self._out[self._emitted:])
        self._emitted = len(self._out)
        return new


def decompress(data, large_window: bool = False) -> bytes:
    """One-shot decode (API parity: python/brotli.py `decompress`)."""
    return Decoder(large_window=large_window).decompress(bytes(data))
