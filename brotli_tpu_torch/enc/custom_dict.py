"""Encoder-side custom-word matching for serialized shared
dictionaries (copy of brotli_tpu.enc.custom_dict; role parity:
BrotliInitCustomSharedEncoderDictionary + ComputeDictionary,
c/enc/encoder_dict.c:508-594 BROTLI_EXPERIMENTAL).

All (word x transform) outputs of each attached word list materialize
once into prefix-keyed indexes; matching probes parse gaps whose
4-byte window hits an index. Context-based dictionaries select the
index by the literal context of the two preceding bytes -- the
encoder's input IS the decoder's output, so the context is known
exactly at every position.
"""

from functools import lru_cache

import numpy as np

from ..format import shared_dictionary as shd

MAX_INDEX_ENTRIES = 1 << 20
MIN_OUT = 4


def build_index(sd: "shd.SharedDictionary"):
    """Per-dictionary {transformed_bytes: (copy_len, word_idx,
    transform_idx, nbits)} indexes plus 4-byte prefix sets, and (for
    context-based dictionaries) the context -> dictionary map. None
    when no attached dictionary has a custom word list."""
    if not sd.dictionaries:
        return None
    indexes = [_index_one(words, tlist)
               for words, tlist in sd.dictionaries]
    if all(ix is None for ix in indexes):
        return None
    out = {"dicts": indexes}
    if sd.context_based:
        out["context_map"] = np.asarray(sd.context_map, np.int64)
    return out


def _index_one(words, tlist):
    if words is None:
        return None
    index = {}
    prefixes = set()
    ntr = len(tlist.triples) if tlist is not None else 121
    size_bits = words.size_bits
    full = False
    for L in range(len(size_bits)):
        if full:
            break
        nbits = int(size_bits[L])
        if nbits == 0 or L < 1:
            continue
        for idx in range(1 << nbits):
            if full:
                break
            w = words.word(L, idx)
            if len(w) != L:
                continue
            for tr in range(ntr):
                if len(index) >= MAX_INDEX_ENTRIES:
                    full = True
                    break
                if tlist is not None:
                    pid, typ, sid = tlist.triples[tr]
                    out = shd.apply_transform(
                        w, (tlist.stringlets[pid], typ,
                            tlist.stringlets[sid]),
                        tlist.params[tr])
                else:
                    from ..format import transforms as T
                    out = w if tr == T.IDENTITY_TRANSFORM else \
                        T.transform_word(w, tr)
                if not out or len(out) < MIN_OUT:
                    continue
                # first writer wins: earlier transform ids cost fewer
                # distance bits
                if out not in index:
                    index[out] = (L, idx, tr, nbits)
                    prefixes.add(out[:4])
    if not index:
        return None
    lengths = sorted({len(k) for k in index}, reverse=True)
    return {"map": index, "prefixes": prefixes, "lengths": lengths}


def add_custom_matches(data: np.ndarray, matches, index, max_backward,
                       csize: int):
    """Insert custom-word references into parse gaps.

    Match flags encode the emitted copy length directly
    (flag = 1000 + copy_len): custom transforms may lengthen OR
    shorten the word, so the builtin cutoff encoding (flag = 2 + cut)
    cannot carry them. Distances address past the compound region
    (`csize`), matching decode_reference's address split."""
    m, lens, dists, flags = matches
    n = len(data)
    covered = np.zeros(n + 1, np.int32)
    np.add.at(covered, np.minimum(m, n), 1)
    np.add.at(covered, np.minimum(m + lens, n), -1)
    in_gap = np.cumsum(covered[:n], dtype=np.int32) == 0
    blob = data.tobytes()
    cand = np.flatnonzero(in_gap[:max(n - MIN_OUT, 0)])
    if len(cand) == 0:
        return matches
    cmap = index.get("context_map")
    dicts = index["dicts"]
    if cmap is not None:
        # literal context of the two PRECEDING bytes selects the
        # dictionary (decode.c:2234 role); the encoder's input is the
        # decoder's output, so the context is exact
        from ..format import context as ctx
        lut = ctx.context_lut(2)
        p1 = data[np.maximum(cand - 1, 0)].astype(np.int64)
        p2 = data[np.maximum(cand - 2, 0)].astype(np.int64)
        which = cmap[(lut[0][p1] | lut[1][p2]).astype(np.int64)]
    else:
        which = np.zeros(len(cand), np.int64)
    new = []
    last_end = -1
    for p, di in zip(cand.tolist(), which.tolist()):
        if p < last_end:
            continue
        sub = dicts[di] if di < len(dicts) else None
        if sub is None or blob[p:p + 4] not in sub["prefixes"]:
            continue
        imap = sub["map"]
        for L_out in sub["lengths"]:
            if p + L_out > n:
                continue
            ent = imap.get(blob[p:p + L_out])
            if ent is None:
                continue
            # whole output must stay inside this gap
            seg = in_gap[p:p + L_out]
            if not seg.all():
                continue
            wlen, widx, tr, nbits = ent
            maxd = min(p, max_backward)
            dist = maxd + 1 + csize + ((tr << nbits) | widx)
            new.append((p, L_out, dist, 1000 + wlen))
            last_end = p + L_out
            break
    if not new:
        return matches
    a = np.array(new, np.int64)
    nm = np.concatenate([m, a[:, 0]])
    order = np.argsort(nm, kind="stable")
    return (nm[order],
            np.concatenate([lens, a[:, 1]])[order],
            np.concatenate([dists, a[:, 2]])[order],
            np.concatenate([flags, a[:, 3]])[order])
