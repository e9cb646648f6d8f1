"""Sharded compression (counterpart of brotli_tpu.parallel):
`shard.compress_sharded` (one card, or one shard per card: the mesh),
`multihost.compress_sharded_mp` (the shards of several processes) and
`device_serialize` (the device serializer); here, the native serializer
of one shard, which both sharded encoders call."""

from .. import native


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
