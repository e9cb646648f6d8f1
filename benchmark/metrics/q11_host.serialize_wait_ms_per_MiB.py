"""Host ms a MiB of input that q11's request thread waited on its
serializer worker (span serialize.wait of enc/encoder._encode_q11_
streamed: handing a span to the worker, and the final hand-off and
join), from the program's spans of every thread."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None:
        return None
    sp, _ = got
    if not any(s.name == "serialize.wait" for s in sp):
        return None
    return 1e3 * S.seconds(sp, "serialize.wait") / S.mib(w)
