"""Sharded compression (counterpart of brotli_tpu.parallel):
`shard.compress_sharded` (one card, or one shard per card: the mesh),
`multihost.compress_sharded_mp` (the shards of several processes) and
`device_serialize` (the device serializer); here, the native and the
Python serializers of one shard."""

from .. import native
from ..enc import bitstream, encoder
from ..format.bitio import BitWriter


def serialize_shard_native(raw, lo, hi, matches, quality, lgwin, ring,
                           write_header, is_last):
    """Serialize one shard's matches through the native serializer
    (btpu_serialize): byte-aligned metablocks of raw[lo:hi], the entry
    distance ring `ring`. Returns the bytes; raises ValueError for flags
    the native serializer does not take."""
    out, _ = native.serialize_region(
        raw, lo, hi, matches, quality, lgwin, ring=ring,
        write_header=write_header, is_last=is_last)
    return out


def serialize_shard_python(arr, lo, hi, matches, quality, lgwin, ring,
                           write_header, is_last):
    """Serialize one shard through the Python serializer, as the JAX
    package does under BROTLI_TPU_SERIALIZER=python (its
    parallel/shard.py serialize): `enc.encoder._write_blocks` over
    arr[lo:hi] from the entry ring `ring`, matches at absolute positions;
    a shard that is not the last ends with an empty metadata block, so
    shards concatenate on byte boundaries."""
    bw = BitWriter()
    if write_header:
        bitstream.write_stream_header(bw, lgwin)
    encoder._write_blocks(bw, arr, lo, hi, matches, encoder._DEFAULT_MB_BITS,
                          is_last, ring, quality=quality)
    if not is_last:
        bitstream.write_metadata_block(bw, b"")
    bw.align_to_byte()
    return bw.getvalue()
