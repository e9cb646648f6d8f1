"""Host ms a MiB of document that the dcb route's request thread waited
on its serializer worker (span serialize.wait of enc/encoder._encode_
q11_streamed), in a window whose requests took the dcb route (a dcb.*
stage ran)."""

from benchmark import spans as S


def read(w):
    got = S.window()
    if got is None:
        return None
    sp, _ = got
    names = {s.name for s in sp}
    if "serialize.wait" not in names or "dcb.lift" not in names:
        return None
    return 1e3 * S.seconds(sp, "serialize.wait") / S.mib(w)
