"""Host glue for device-side shard serialization (counterpart of
brotli_tpu.parallel.device_serialize): per metablock, the card plans the
symbol stream and packs the payload bits (ops/bitpack.py, K6); the host
contributes only the few-hundred-bit header (metablock length, trivial
prelude, three canonical tree descriptions from ~4 KB of histograms)
and splices the byte streams.

Output framing matches the native path: every metablock is
byte-aligned via an empty metadata block (the FLUSH stitch) so
metablocks and shards concatenate freely; the final metablock of the
last shard is ISLAST. Reference role: BrotliStoreMetaBlockTrivial +
brotli_bit_stream.c:833-943, with the bit emission on the card.

Every metablock is padded to its bucket as the JAX package's jit pads
it, so `ncap` and `cap_words` decide the same cases. A metablock costs
two waits on the card: the histograms (with the exit ring) for the
trees, then the words with the total bit count.
"""

import threading

import numpy as np
import torch

from ..enc import bitstream
from ..enc.entropy import package_merge, write_huffman_code
from ..format import constants as C
from ..format.bitio import BitWriter
from ..format.huffman import lengths_to_codes
from ..ops import bitpack
from ..utils import fetch, trace
from ..utils.device import resolve

_BUCKETS = [1 << 18, 1 << 22]

# shards the device path did not take (serialize_shard_device returned
# None), for the caller to serialize natively
HOST_SHARDS = 0
_host_lock = threading.Lock()


def _bucket(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


def _tables(freq, alphabet):
    lens = package_merge(np.asarray(freq[:alphabet], np.int64),
                         C.HUFFMAN_MAX_CODE_LENGTH)
    lens_e = bitstream._emission(lens)
    codes = lengths_to_codes(lens_e)
    return lens, lens_e.astype(np.int32), codes.astype(np.int32)


def _to_host():
    """The shard goes to the native serializer: count it, say None."""
    global HOST_SHARDS
    with _host_lock:
        HOST_SHARDS += 1


def serialize_shard_device(arr, lo, hi, matches, ring, lgwin,
                           write_header, is_last, mb_bits=22, device=None):
    """Serialize shard [lo, hi) of `arr` (uint8) with symbol planning
    and bit packing on `device` (None = "cuda"; "cpu" runs the plain
    versions). Returns byte-aligned bytes, or None, counted in
    HOST_SHARDS, when the device path does not take the shard: a
    custom-word flag, more than ncap - 2 commands or a distance of 2**25
    or more in a metablock, or a payload over 32 * cap_words bits. The
    caller then serializes the shard natively."""
    dev = resolve(device)
    m, lens, dists, flags = (np.asarray(a, np.int64) for a in matches)
    if np.any((flags >= 1000) & (flags < 2000)):
        _to_host()
        return None  # custom-word refs need the host serializer
    mb = 1 << mb_bits
    out = bytearray()
    if ring is None:
        ring = bitstream.initial_ring()
    ring = np.asarray(ring, np.int64)
    dist_alpha = C.distance_alphabet_size(0, 0, C.MAX_DISTANCE_BITS)
    pos = lo
    first = True
    while pos < hi:
        bhi = min(pos + mb, hi)
        mlen = bhi - pos
        keep = (m >= pos) & (m + lens <= bhi)
        block = np.stack([m[keep] - pos, lens[keep], dists[keep],
                          flags[keep]]).astype(np.int32)
        ncmd = block.shape[1]
        b = _bucket(mlen)
        ncap = b // 4 + 8
        if ncmd > ncap - 2 or np.any(block[2] >= (1 << 25)):
            _to_host()
            return None
        cmds = np.zeros((4, ncap), np.int32)
        cmds[:, :ncmd] = block
        data = np.zeros(b, np.uint8)
        data[:mlen] = arr[pos:bhi]
        cap_words = b // 2 + 64

        with trace.stage("serialize.plan"):
            cmds_t = torch.from_numpy(cmds).to(dev)
            vals, markers, h_lit, h_cmd, h_dist, new_ring = bitpack.plan(
                torch.from_numpy(data).to(dev), cmds_t[0], cmds_t[1],
                cmds_t[2], cmds_t[3], ncmd,
                torch.from_numpy(ring.astype(np.int32)).to(dev), mlen)
            hists = torch.cat([h_lit, h_cmd, h_dist, new_ring])
            # the event goes after the cat that it guards
            host = fetch.fetch_after([fetch.mark(dev)], [hists])[0].numpy()
        h_lit, h_cmd, h_dist, new_ring = np.split(
            host.astype(np.int64), [256, 256 + C.NUM_COMMAND_SYMBOLS,
                                    256 + C.NUM_COMMAND_SYMBOLS + 64])

        # host: trees + header
        with trace.stage("serialize.trees"):
            lit_l, lit_le, lit_c = _tables(np.maximum(h_lit, 0), 256)
            cmd_l, cmd_le, cmd_c = _tables(np.maximum(h_cmd, 0),
                                           C.NUM_COMMAND_SYMBOLS)
            h_dist_full = np.zeros(dist_alpha, np.int64)
            h_dist_full[:64] = np.maximum(h_dist, 0)
            dist_l, dist_le64, dist_c64 = _tables(h_dist_full, dist_alpha)
            hb = BitWriter()
            if write_header and first:
                bitstream.write_stream_header(hb, lgwin)
            bitstream.write_metablock_header_mlen(
                hb, mlen, is_last and bhi >= hi)
            for _ in range(3):
                bitstream.write_varlen_uint8(hb, 0)  # NBLTYPES = 1
            hb.write(0, 2)  # NPOSTFIX
            hb.write(0, 4)  # NDIRECT
            hb.write(0, 2)  # context mode (no context modeling)
            bitstream.write_varlen_uint8(hb, 0)  # NTREES_L = 1
            bitstream.write_varlen_uint8(hb, 0)  # NTREES_D = 1
            write_huffman_code(hb, lit_l, 256)
            write_huffman_code(hb, cmd_l, C.NUM_COMMAND_SYMBOLS)
            write_huffman_code(hb, dist_l, dist_alpha)
            bit0 = hb.bit_length & 7

        with trace.stage("serialize.pack"):
            tab = torch.from_numpy(np.concatenate(
                [lit_c, lit_le, cmd_c, cmd_le, dist_c64[:64],
                 dist_le64[:64]])).to(dev)
            tables = torch.split(tab, [256, 256, C.NUM_COMMAND_SYMBOLS,
                                       C.NUM_COMMAND_SYMBOLS, 64, 64])
            words, total = bitpack.pack(vals, markers, *tables, bit0,
                                        cap_words)
            del vals, markers
            # the words and the total in one read (cap_words is even)
            packed = torch.cat([words.view(torch.int64), total.reshape(1)])
            host = fetch.fetch_after([fetch.mark(dev)], [packed])[0].numpy()
        total_bits = int(host[-1])
        if total_bits > 32 * cap_words:
            _to_host()
            return None  # payload overflow: host serializer
        nbytes = (total_bits + 7) // 8
        payload = host[:-1].view(np.uint8)[:nbytes]

        header = bytearray(hb.getvalue())  # byte-padded
        hbits = hb.bit_length
        if bit0:
            # the device payload's first byte overlaps the header's
            # ragged last byte: OR-splice
            header[hbits // 8] |= int(payload[0])
            out += header[: hbits // 8 + 1]
            out += payload[1:].tobytes()
        else:
            out += header[: hbits // 8]
            out += payload.tobytes()
        # trailing partial byte of the payload: the next metablock
        # starts byte-aligned via the FLUSH stitch below
        tail_bits = total_bits & 7
        ring = new_ring
        pos = bhi
        first = False
        if not (is_last and pos >= hi):
            # empty metadata block starting at bit offset tail_bits of
            # the last payload byte: ISLAST=0, MNIBBLES=3 (metadata),
            # reserved 0, MSKIPBYTES=0, then align
            sb = BitWriter()
            if tail_bits:
                lastb = out[-1]
                del out[-1]
                sb.write(lastb & ((1 << tail_bits) - 1), tail_bits)
            sb.write(0, 1)
            sb.write(3, 2)
            sb.write(0, 1)
            sb.write(0, 2)
            sb.align_to_byte()
            out += sb.getvalue()
    return bytes(out)
