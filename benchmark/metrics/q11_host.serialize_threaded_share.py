"""Share (%) of the window's metablocks whose native serialization ran
its q10/q11 literal passes (the split ladder's rungs, the per-type
context clustering) on more than one thread (counters serialize.threaded
and serialize.metablocks of enc/encoder._encode_q11_streamed, counted
once a span from what native.serialize_region returns). A span's thread
budget is the cores the other spans and the parse leave free, so a
one-span request reads 100% on a host of several cores; 0% is every
metablock on its serializer's thread alone. Nothing to read from a
program that counts no metablocks or no threaded ones."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or not got[1].get("serialize.metablocks") or \
            "serialize.threaded" not in got[1]:
        return None
    return 100.0 * got[1]["serialize.threaded"] / \
        got[1]["serialize.metablocks"]
