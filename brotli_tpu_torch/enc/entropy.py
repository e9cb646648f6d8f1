"""Entropy coding: optimal length-limited prefix codes + RFC 3.4/3.5
code-description serialization (copy of brotli_tpu.enc.entropy).

Code lengths come from the package-merge algorithm, which is optimal
under the depth limit.
"""

import ctypes

import numpy as np

from .. import native
from ..format import constants as C
from ..format.huffman import lengths_to_codes


def package_merge(freqs, max_len: int) -> np.ndarray:
    """Optimal depth-limited code lengths (package-merge).

    freqs: int array over the alphabet; zeros get length 0.
    Returns int32 lengths with max(lengths) <= max_len and exact Kraft
    equality over the used symbols (when >= 2 symbols are used).
    Alphabets of at most 1200 symbols with counts below 2**32 go to the
    native engine (btpu_pm_lengths), as in the JAX package; a failure
    to load the native library raises. The Python algorithm below is
    the semantics reference."""
    freqs = np.asarray(freqs, dtype=np.int64)
    used = np.flatnonzero(freqs)
    n = len(used)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[used[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError("alphabet larger than 2^max_len")
    if len(freqs) <= 1200 and freqs.max() < (1 << 32):
        f32 = np.ascontiguousarray(freqs, dtype=np.uint32)
        out = np.zeros(len(freqs), dtype=np.uint8)
        rc = native.get_lib().btpu_pm_lengths(
            f32.ctypes.data_as(ctypes.c_void_p), len(freqs), int(max_len),
            out.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return out.astype(np.int32)
    w = freqs[used]
    # Standard package-merge: items are (weight, [leaf]) pairs; merge up.
    items = sorted(range(n), key=lambda i: w[i])
    counts = np.zeros(n, dtype=np.int32)  # times each leaf is selected
    prev = [(int(w[i]), np.eye(1, n, i, dtype=np.int32)[0]) for i in items]
    level_list = prev
    for _ in range(max_len - 1):
        # package: pair up adjacent
        packaged = []
        for k in range(0, len(level_list) - 1, 2):
            wsum = level_list[k][0] + level_list[k + 1][0]
            csum = level_list[k][1] + level_list[k + 1][1]
            packaged.append((wsum, csum))
        # merge with original items
        merged = []
        i = j = 0
        while i < len(prev) and j < len(packaged):
            if prev[i][0] <= packaged[j][0]:
                merged.append(prev[i])
                i += 1
            else:
                merged.append(packaged[j])
                j += 1
        merged.extend(prev[i:])
        merged.extend(packaged[j:])
        level_list = merged
    for k in range(2 * n - 2):
        counts += level_list[k][1]
    lengths[used] = counts
    return lengths


# --- RFC 3.5 code description serialization ---------------------------------

def _rle_tree_symbols(lengths: np.ndarray):
    """Convert a code-length sequence to (cl_symbol, extra, extra_bits)
    triples using the 16/17 repeat codes. Trailing zeros are dropped."""
    used = np.flatnonzero(lengths)
    seq = lengths[:used[-1] + 1] if len(used) else lengths[:0]
    out = []  # (symbol, extra_value, extra_bits)
    prev_nonzero = C.INITIAL_REPEATED_CODE_LENGTH
    i = 0
    n = len(seq)
    while i < n:
        v = int(seq[i])
        j = i
        while j < n and int(seq[j]) == v:
            j += 1
        run = j - i
        if v == 0:
            _emit_repeat(out, 17, run, 3, zero_first=True)
        else:
            if v != prev_nonzero:
                out.append((v, 0, 0))
                run -= 1
            prev_nonzero = v
            _emit_repeat(out, 16, run, 2, zero_first=False, value=v)
        i = j
    return out


def _emit_repeat(out, code, run, extra_bits, zero_first, value=None):
    """Emit `run` repetitions via repeat code `code` (16 or 17).

    Decoder recurrence: total_1 = 3 + e_1;
    total_{k+1} = (total_k - 2) << extra_bits + 3 + e_{k+1}.
    """
    if run <= 0:
        return
    if run < 3:
        sym = 0 if zero_first else value
        out.extend([(sym, 0, 0)] * run)
        return
    reps = run - 3
    stack = []
    while True:
        stack.append(reps & ((1 << extra_bits) - 1))
        reps >>= extra_bits
        if reps == 0:
            break
        reps -= 1
    for e in reversed(stack):
        out.append((code, e, extra_bits))


def write_huffman_code(bw, lengths: np.ndarray, alphabet_size: int) -> None:
    """Serialize a prefix code (simple or complex form, RFC 3.4/3.5)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    used = np.flatnonzero(lengths)
    if len(used) == 0:
        # Degenerate: no symbols of this category appear. Emit a 1-symbol
        # simple code over symbol 0 (costs ~14 bits, never used).
        used = np.array([0])
        lengths = lengths.copy()
        lengths[0] = 1
    if len(used) <= 4:
        _write_simple(bw, lengths, used, alphabet_size)
    else:
        _write_complex(bw, lengths)


def _write_simple(bw, lengths, used, alphabet_size):
    nsym = len(used)
    # order symbols by (length, value): satisfies the decoder's expected
    # stream order for every simple shape (c/dec/huffman.c
    # BrotliBuildSimpleHuffmanTable).
    order = sorted(used, key=lambda s: (int(lengths[s]), int(s)))
    bw.write(1, 2)  # simple code marker
    bw.write(nsym - 1, 2)
    max_bits = (alphabet_size - 1).bit_length()
    for s in order:
        bw.write(int(s), max_bits)
    if nsym == 4:
        shape = sorted(int(lengths[s]) for s in used)
        bw.write(1 if shape == [1, 2, 3, 3] else 0, 1)


def _write_complex(bw, lengths):
    syms = _rle_tree_symbols(lengths)
    # histogram over code-length symbols 0..17
    cl_freq = np.zeros(C.CODE_LENGTH_CODES, dtype=np.int64)
    for s, _, _ in syms:
        cl_freq[s] += 1
    cl_lengths = package_merge(cl_freq,
                               C.HUFFMAN_MAX_CODE_LENGTH_CODE_LENGTH)
    # Degenerate single-cl-symbol code: decoder accepts num_codes == 1
    # with a zero-bit code, but only if exactly one cl symbol is used; we
    # keep its length 1 and the space check passes via num_codes == 1.
    cl_codes = lengths_to_codes(cl_lengths)

    # skip marker: 0 = none, 2/3 = skip leading zero-length cl slots
    order = C.CODE_LENGTH_CODE_ORDER
    skip = 0
    while skip < 3 and cl_lengths[order[skip]] == 0:
        skip += 1
    if skip == 1:
        skip = 0
    bw.write(skip if skip else 0, 2)

    # cl-code lengths in stream order; the decoder stops reading as soon
    # as the 5-bit Kraft space fills, so the encoder must stop there too.
    # A single used cl symbol (e.g. every literal at length 8 riding the
    # decoder's initial prev_len = 8) decodes with a zero-bit cl code.
    num_codes = int(np.count_nonzero(cl_lengths))
    single = num_codes == 1
    space = 32
    for idx in order[skip:]:
        v = int(cl_lengths[idx])
        code, nbits = C.CODE_LENGTH_CODE_FIXED[v]
        bw.write(code, nbits)
        if v != 0:
            space -= 32 >> v
            if space <= 0:
                break

    # symbol code lengths via the cl code
    for s, extra, ebits in syms:
        if not single:
            bw.write(int(cl_codes[s]), int(cl_lengths[s]))
        if ebits:
            bw.write(extra, ebits)


def code_bit_cost(freqs, lengths) -> int:
    return int(np.sum(np.asarray(freqs, np.int64) *
                      np.asarray(lengths, np.int64)))
