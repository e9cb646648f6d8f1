"""Share (%) of q11's metablock spans whose native serialization began
while an earlier span of the same request was still being serialized
(counters serialize.overlapped and serialize.spans of enc/encoder._
encode_q11_streamed, which hands a request's spans to a pool of
serializers). A 16 MiB request at lgblock 22 is four spans, so 75% is
every span after the first beside another; 0% is one serializer's
order. Nothing to read from a program that counts no spans."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None or not got[1].get("serialize.spans"):
        return None
    return 100 * got[1].get("serialize.overlapped", 0) / \
        got[1]["serialize.spans"]
