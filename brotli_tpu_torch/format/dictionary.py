"""RFC 7932 Appendix A static dictionary blob (the dictionary_data()
of brotli_tpu.format.dictionary; 122,784 bytes shipped in
``brotli_tpu_torch/data``)."""

from functools import lru_cache
from pathlib import Path

_DATA_PATH = Path(__file__).resolve().parent.parent / "data" / \
    "static_dictionary_rfc7932.bin"


@lru_cache(maxsize=1)
def dictionary_data() -> bytes:
    """The RFC 7932 dictionary blob. Cached so every caller sees ONE
    stable object: the native library keys its global dictionary
    index on the blob POINTER (btpu_enc.c dict_index_init) and keeps
    it after the call returns -- a fresh bytes object per call both
    dangles that pointer and forces an index rebuild."""
    data = _DATA_PATH.read_bytes()
    if len(data) != 122784:
        raise RuntimeError("static dictionary blob corrupted")
    return data
