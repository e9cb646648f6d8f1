"""Device-side metablock serialization: symbol planning + bit packing
(counterpart of brotli_tpu.ops.bitpack; reference role:
c/enc/brotli_bit_stream.c:833-943 BlockEncoder symbol streams +
write_bits.h).

  * `plan`: the command stream of one trivial metablock resolves to
    (value, marker) fields in decode order -- insert/copy codes by table
    search, the 4-slot distance ring simulated exactly with the collapse
    trick (the push sequence is the copy-distance sequence with
    consecutive duplicates collapsed), literal bytes scattered between
    their commands -- plus the three histograms. Torch ops on the
    inputs' device, line by line the JAX package's `_plan_math`.
  * trees stay on the host (parallel/device_serialize.py); their code
    tables come back as (alphabet,) arrays.
  * `pack`: each field's marker resolves through the code tables, an
    exclusive scan of the lengths gives bit offsets, and each field adds
    into (at most) two u32 words (bit-disjoint, so add == or). K6
    (csrc/bitpack.cu) on the card, `pack_plain` on the CPU.

torch has no uint32 scatter: the plain packer works in int64 lanes
holding uint32 values, and the words come back as an int32 tensor of
their bit patterns.
"""

import torch

from ..format import constants as C
from ..format import prefix
from ..utils import u32
from . import kernels

DIST_SYM = 4096  # distance symbols ride the tree marker at +4096
_CELL = [128, 192, 384, 256, 320, 512, 448, 576, 640]  # RFC 7932 5


def _encode_values(vals, base, extra):
    """(code, extra value, extra bits) of int32 lanes: the code is the
    number of bases after the first that vals reaches (JAX's unrolled
    compares), i.e. searchsorted right - 1, clamped at 0."""
    b = torch.as_tensor(base, dtype=torch.int32, device=vals.device)
    e = torch.as_tensor(extra, dtype=torch.int32, device=vals.device)
    code = (torch.searchsorted(b, vals, right=True, out_int32=True) -
            1).clamp(min=0)
    return code, vals - b[code], e[code]


def _combine_codes(icode, ccode, implicit):
    low = ((icode & 7) << 3) | (ccode & 7)
    cell = torch.tensor(_CELL, dtype=torch.int32, device=icode.device)
    start = cell[(icode >> 3) * 3 + (ccode >> 3)]
    imp_start = torch.where((ccode >> 3) == 0, 0, 64)
    return torch.where(implicit, imp_start + low, start + low)


def plan(data, m, lens, dists, flags, ncmd_valid: int, ring_in, mlen: int):
    """Symbol plan of ONE trivial metablock over data[0:mlen] (the JAX
    package's `_plan_math`).

    data: uint8 (n,); m/lens/dists/flags: int32 (ncap,) padded command
    arrays (matches only, sorted; slots >= ncmd_valid are dead); ring_in:
    int32 (4,) entry ring, newest first. The final insert-only command
    is synthesized from the gap after the last match. Returns int32
    tensors on the inputs' device: (vals, markers) of 5 * ncap + n
    fields in decode order (markers: -1 tree symbol, a distance symbol
    at +4096; -2 literal byte; >= 0 raw extra bits), the literal,
    command and distance histograms and the exit ring."""
    i32 = torch.int32
    dev = m.device
    ncap = m.shape[0]
    n = data.shape[0]
    iota = torch.arange(ncap, dtype=i32, device=dev)
    valid = iota < ncmd_valid

    # inserts = gaps between consecutive matches; final insert-only
    # command covers the tail (always present as slot ncmd_valid)
    end = m + lens
    prev_end = torch.where(iota == 0, 0, torch.roll(end, 1))
    prev_end = torch.where(valid, prev_end, 0)
    ins = torch.where(valid, m - prev_end, 0)
    last_end = torch.where(valid, end, 0).max()
    tail_ins = mlen - last_end
    is_tail = iota == ncmd_valid
    has_tail = tail_ins > 0
    active = valid | (is_tail & has_tail)
    ins = torch.where(is_tail, torch.where(has_tail, tail_ins, 0), ins)
    cpy = torch.where(valid, lens, 0)
    dist = torch.where(valid, dists, 0)
    fl = torch.where(valid, flags, 0)
    final_insert = is_tail

    icode, iextra, ibits = _encode_values(ins, prefix.INSERT_BASE,
                                          prefix.INSERT_EXTRA)
    builtin_gen = fl >= 2000
    custom = (fl >= 1000) & ~builtin_gen
    cut = torch.where(custom | builtin_gen, 0, (fl - 2).clamp(min=0))
    eff_cpy = torch.where(builtin_gen, fl - 2000,
                          torch.where(custom, fl - 1000, cpy + cut))
    ccode, cextra, cbits = _encode_values(
        torch.where(final_insert, 2, eff_cpy), prefix.COPY_BASE,
        prefix.COPY_EXTRA)
    is_dict = fl >= 2

    # exact ring simulation (collapse trick): pushes = copy distances
    # with consecutive duplicates collapsed
    is_copy = valid & ~is_dict
    cd = torch.where(is_copy, dist, 0)
    copy_rank = torch.cumsum(is_copy, 0, dtype=i32) - is_copy.to(i32)
    # previous copy distance: the last positive value so far (JAX's
    # associative_scan fill), by a cummax of its index
    last = torch.cummax(torch.where(cd > 0, iota, -1), 0).values
    carry = torch.where(last >= 0, cd[last.clamp(min=0)], cd[0])
    prev_copy_d = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                             carry[:-1]])
    top_before = torch.where(copy_rank == 0, ring_in[0], prev_copy_d)
    newpush = is_copy & (dist != top_before)
    push_rank = torch.cumsum(newpush, 0, dtype=i32)  # inclusive
    cnt_before = 4 + push_rank - newpush.to(i32)
    # pv: oldest..newest pushed values, indices 0..3 = ring reversed;
    # lanes that push nothing write 0 to slot ncap + 4
    pv = torch.zeros(ncap + 5, dtype=i32, device=dev)
    pv[:4] = ring_in.flip(0)
    pidx = torch.where(newpush, 3 + push_rank, ncap + 4)
    pv.index_put_((pidx,), torch.where(newpush, dist, 0))
    slot0, slot1, slot2, slot3 = (pv[cnt_before - k] for k in (1, 2, 3, 4))
    npush = push_rank.max()
    new_ring = pv[torch.stack([3 + npush, 2 + npush,
                               (1 + npush).clamp(min=0),
                               npush.clamp(min=0)])]

    is_reuse = is_copy & (dist == slot0)
    implicit = is_reuse & (icode < 8) & (ccode < 16)
    d0 = dist - slot0
    d1 = dist - slot1
    near0 = torch.where(d0 < 0, 4 + 2 * (-d0 - 1), 5 + 2 * (d0 - 1))
    near1 = torch.where(d1 < 0, 10 + 2 * (-d1 - 1), 11 + 2 * (d1 - 1))
    eligible = is_copy & ~is_reuse
    short = torch.full((ncap,), -1, dtype=i32, device=dev)
    for cond, code in [
            (dist == slot1, 1), (dist == slot2, 2), (dist == slot3, 3),
            ((d0.abs() <= 3) & (d0 != 0), near0),
            ((d1.abs() <= 3) & (d1 != 0), near1)]:
        pick = eligible & (short < 0) & cond
        short = torch.where(pick, code, short)
    near = short >= 0
    # explicit new distances (npostfix = ndirect = 0)
    expl = (active & ~final_insert) & ~is_reuse & ~near
    dd = dist.clamp(min=1) - 1
    v4 = dd + 4  # hcode + 4 with npostfix 0, ndirect 0
    nbits_d = u32.bit_length((v4 >> 2) | 1).to(i32).clamp(min=1)
    rest = dd - ((2 << nbits_d) - 4)
    half = rest >> nbits_d
    extra_d = rest - (half << nbits_d)
    dcode_expl = 16 + (((nbits_d - 1) << 1) | half)
    dcode = torch.where(near, short, torch.where(expl, dcode_expl, 0))
    dextra = torch.where(expl, extra_d, 0)
    dbits = torch.where(expl, nbits_d, 0)
    has_dist = active & ~final_insert & ~implicit

    imp_or_tail = implicit | (final_insert & (icode < 8))
    cmd_syms = _combine_codes(icode, ccode, imp_or_tail)
    cmd_syms = torch.where(active, cmd_syms, 0)

    # literal positions: bytes outside every match span
    pos_i = torch.arange(n, dtype=i32, device=dev)
    ones = torch.ones(ncap, dtype=i32, device=dev)
    cov = torch.zeros(n + 1, dtype=i32, device=dev)
    cov.index_add_(0, torch.where(valid, m.clamp(0, n), n), ones)
    cov.index_add_(0, torch.where(valid, end.clamp(0, n), n), -ones)
    inside = torch.cumsum(cov[:n], 0, dtype=i32) > 0
    is_lit = ~inside & (pos_i < mlen)
    lit_rank = torch.cumsum(is_lit, 0, dtype=i32) - is_lit.to(i32)
    # command index of each literal: literals before match k belong to
    # command k; tail literals to the final command
    cmd_of_lit = torch.searchsorted(
        torch.where(valid, m, 0x7FFFFFFF), pos_i, right=True,
        out_int32=True)

    # interleave: per command 5 slots + its literals; a literal with
    # global rank r under command k lands at 5*k + 3 + r. Active slot
    # indices are unique by construction; inactive lanes write 0/0 to a
    # sacrificial slot, so the repeated writes all carry the same 0.
    ins_a = torch.where(active, ins, 0)
    lit_before = torch.cumsum(ins_a, 0, dtype=i32) - ins_a
    rec_start = 5 * iota + lit_before
    total_slots = 5 * ncap + n
    vals = torch.zeros(total_slots, dtype=i32, device=dev)
    nbits = torch.zeros(total_slots, dtype=i32, device=dev)
    dead = total_slots - 1  # sacrificial slot (nbits stays 0)

    def sat(slot, cond, v, b):
        i = torch.where(cond, slot, dead)
        vals.index_put_((i,), torch.where(cond, v, 0).to(i32))
        nbits.index_put_((i,), torch.where(cond, b, 0).to(i32))

    data_i = data.to(i32)
    sat(rec_start, active, cmd_syms, -1)
    sat(rec_start + 1, active, iextra, ibits)
    sat(rec_start + 2, active, torch.where(final_insert, 0, cextra),
        torch.where(final_insert, 0, cbits))
    dslot = rec_start + 3 + ins_a
    sat(dslot, has_dist, dcode + DIST_SYM, -1)
    sat(dslot + 1, has_dist, dextra, dbits)
    lit_slot = 5 * cmd_of_lit.clamp(0, ncap - 1) + 3 + lit_rank
    sat(lit_slot, is_lit, data_i, -2)

    def hist(size, idx, cond):
        return torch.zeros(size, dtype=i32, device=dev).index_add_(
            0, torch.where(cond, idx, 0), cond.to(i32))

    hist_lit = hist(256, data_i, is_lit)
    hist_cmd = hist(C.NUM_COMMAND_SYMBOLS, cmd_syms, active)
    hist_dist = hist(64, dcode, has_dist)
    return vals, nbits, hist_lit, hist_cmd, hist_dist, new_ring


def pack_bits_plain(values, nbits, bit0: int, cap_words: int):
    """(values, nbits) fields -> u32 words added at running bit offsets
    starting at bit0 (the JAX package's `_pack_bits_math`, uint32 lanes
    in int64). Returns (words int32 (cap_words,) bit patterns, total
    bits int64 0-dim), both mod 2**32 as in uint32."""
    nb = nbits.to(torch.int64) & u32.MASK32
    csum = torch.cumsum(nb, 0)
    offs = (bit0 + csum - nb) & u32.MASK32  # exclusive scan
    total = (bit0 + nb.sum()) & u32.MASK32
    v = values.to(torch.int64) & u32.MASK32 & ((1 << nb.clamp(max=32)) - 1)
    idx = offs >> 5
    sh = offs & 31
    t = v << sh  # < 2**63: the low word and the bits spilling over
    lo = torch.where(nb > 0, t & u32.MASK32, 0)
    hi = torch.where((sh > 0) & (nb > 0), t >> 32, 0)
    words = torch.zeros(cap_words, dtype=torch.int64, device=values.device)
    words.index_add_(0, idx.clamp(0, cap_words - 1), lo)
    words.index_add_(0, (idx + 1).clamp(0, cap_words - 1), hi)
    words &= u32.MASK32
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32), total


def pack_plain(vals, markers, lit_code, lit_len, cmd_code, cmd_len,
               dist_code, dist_len, bit0: int, cap_words: int):
    """The JAX package's `pack_kernel` in torch ops: tree symbols and
    literal bytes resolve through their code tables, raw extra bits stay
    as they are, then the fields pack into cap_words words."""
    is_cmd = markers == -1
    is_lit = markers == -2
    is_dsym = is_cmd & (vals >= DIST_SYM)
    is_csym = is_cmd & ~is_dsym
    v = torch.where(is_dsym, vals - DIST_SYM, vals)
    lv, cv, dv = v.clamp(0, 255), v.clamp(0, 703), v.clamp(0, 63)
    code = torch.where(
        is_lit, lit_code[lv],
        torch.where(is_csym, cmd_code[cv],
                    torch.where(is_dsym, dist_code[dv], v)))
    nb = torch.where(
        is_lit, lit_len[lv],
        torch.where(is_csym, cmd_len[cv],
                    torch.where(is_dsym, dist_len[dv],
                                markers.clamp(min=0))))
    return pack_bits_plain(code, nb, bit0, cap_words)


def pack(vals, markers, lit_code, lit_len, cmd_code, cmd_len, dist_code,
         dist_len, bit0: int, cap_words: int):
    """K6: `pack_plain` for tensors on the CPU, csrc/bitpack.cu for
    tensors on the card. Returns (words int32 (cap_words,), total bits
    int64 0-dim), on the inputs' device."""
    if vals.device.type == "cpu":
        return pack_plain(vals, markers, lit_code, lit_len, cmd_code,
                          cmd_len, dist_code, dist_len, bit0, cap_words)
    return kernels.bitpack(vals, markers, (lit_code, lit_len, cmd_code,
                                           cmd_len, dist_code, dist_len),
                           bit0, cap_words)
