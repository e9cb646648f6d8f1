"""The reference's tables against upstream brotli's, which the program
cannot share: the static dictionary (RFC 7932 Appendix A) and the 121
transforms (Appendix B). A wrong entry that the program and the
reference both held would still round-trip, so the round trip alone
cannot catch it; these tests hold the frozen tables to upstream's.

The checksums were read from upstream brotli 1.0.9's libbrotlicommon
(BrotliGetDictionary, BrotliGetTransforms; c/common/dictionary.c and
c/common/transform.c) and equal the frozen tables. Where the library is
installed, the tables are also compared with it entry by entry, and its
decoder (BrotliDecoderDecompress) decodes streams as the reference does.
"""

import ctypes
import ctypes.util
import hashlib

import pytest

from benchmark import core, reference
from benchmark.reference import dictionary, transforms

# SHA-256 of the 122,784 bytes of upstream's static dictionary
DICTIONARY_SHA256 = (
    "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70")
# SHA-256 of repr((TRANSFORMS, CUTOFF_TRANSFORMS)) as upstream's table
# reads into them: (prefix, operation, suffix) for ids 0..120
TRANSFORMS_SHA256 = (
    "8f01b6809a84794bd9196b3ec8cde33fd090a241a87cf572e29029295e7f6d48")


class _Dictionary(ctypes.Structure):
    _fields_ = [("size_bits_by_length", ctypes.c_uint8 * 32),
                ("offsets_by_length", ctypes.c_uint32 * 32),
                ("data_size", ctypes.c_size_t),
                ("data", ctypes.POINTER(ctypes.c_uint8))]


class _Transforms(ctypes.Structure):
    _fields_ = [("prefix_suffix_size", ctypes.c_uint16),
                ("prefix_suffix", ctypes.POINTER(ctypes.c_uint8)),
                ("prefix_suffix_map", ctypes.POINTER(ctypes.c_uint16)),
                ("num_transforms", ctypes.c_uint32),
                ("transforms", ctypes.POINTER(ctypes.c_uint8)),
                ("params", ctypes.POINTER(ctypes.c_uint8)),
                ("cutOffTransforms", ctypes.c_int16 * 10)]


def _library(name):
    path = ctypes.util.find_library(name)
    if path is None:
        pytest.skip(f"upstream lib{name} is not installed")
    return ctypes.CDLL(path)


def _blob() -> bytes:
    return dictionary._DATA_PATH.read_bytes()


def test_dictionary_is_upstreams():
    blob = _blob()
    assert len(blob) == 122_784
    assert hashlib.sha256(blob).hexdigest() == DICTIONARY_SHA256


def test_transforms_are_upstreams():
    table = repr((transforms.TRANSFORMS, transforms.CUTOFF_TRANSFORMS))
    assert len(transforms.TRANSFORMS) == 121
    assert hashlib.sha256(table.encode()).hexdigest() == TRANSFORMS_SHA256


def test_tables_equal_the_installed_upstream_library():
    lib = _library("brotlicommon")
    lib.BrotliGetDictionary.restype = ctypes.POINTER(_Dictionary)
    lib.BrotliGetTransforms.restype = ctypes.POINTER(_Transforms)
    d = lib.BrotliGetDictionary().contents
    assert ctypes.string_at(d.data, d.data_size) == _blob()
    assert list(d.size_bits_by_length)[4:25] == \
        list(dictionary.SIZE_BITS_BY_LENGTH)[4:25]
    t = lib.BrotliGetTransforms().contents
    ps = ctypes.string_at(t.prefix_suffix, t.prefix_suffix_size)

    def piece(i):  # a length byte, then the bytes
        o = t.prefix_suffix_map[i]
        return ps[o + 1:o + 1 + ps[o]]

    ops = {0: "IDENTITY", 10: "UPPERCASE_FIRST", 11: "UPPERCASE_ALL"}
    for k in range(1, 10):
        ops[k], ops[11 + k] = f"OMIT_LAST_{k}", f"OMIT_FIRST_{k}"
    up = tuple((piece(t.transforms[3 * i]), ops[t.transforms[3 * i + 1]],
                piece(t.transforms[3 * i + 2]))
               for i in range(t.num_transforms))
    assert up == transforms.TRANSFORMS
    assert tuple(t.cutOffTransforms) == transforms.CUTOFF_TRANSFORMS


def _upstream_decode(lib, stream: bytes, size: int) -> bytes:
    out = ctypes.create_string_buffer(size + 1)
    n = ctypes.c_size_t(size + 1)
    ok = lib.BrotliDecoderDecompress(ctypes.c_size_t(len(stream)), stream,
                                     ctypes.byref(n), out)
    assert ok == 1
    return out.raw[:n.value]


@pytest.mark.parametrize("traffic,quality", [("bulk16m", 11),
                                             ("bulk16m", 5),
                                             ("logs16m", 5)])
def test_upstream_decoder_agrees_with_the_reference(traffic, quality):
    from brotli_tpu_torch import native
    lib = _library("brotlidec")
    t = core.load_json("traffic", traffic)
    params = {k: v for k, v in t["params"].items()
              if k not in ("doc_bytes", "pool")}
    doc = core.load_module("gen", t["gen"]).document(200_000, 3, **params)
    stream = native.encode(doc, quality, 22)
    assert _upstream_decode(lib, stream, len(doc)) == doc
    assert reference.decompress(stream) == doc
