"""(g) The port's q10/q11 encode on the CPU against the JAX package's
`_encode_q11_streamed`, byte for byte, and both decoders on the result.

300 KB in 64 KiB segments: with a metablock that divides the segment
the spans stream in two collected groups; with a metablock larger than
the segment the parse is collected whole and then split."""

import os

import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as bt
from brotli_tpu import native as JN
from brotli_tpu.enc import encoder as JE
from brotli_tpu.format import constants as C
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus

SEG = 1 << 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes
    at once, and their OpenMP threads spinning on the same cores made
    these tests twenty times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def v3():
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("BROTLI_TPU_"):
                mp.delenv(k)
        mp.setenv("BROTLI_TPU_DP", "v3")
        mp.setattr(OJ, "SEG_V3", SEG)
        mp.setattr(OJ, "_BUCKETS_V3", [SEG])
        mp.setattr(O, "SEG_V3", SEG)
        mp.setattr(O, "BUCKETS_V3", [SEG])
        yield


@pytest.fixture(scope="module")
def data():
    return build_corpus(1 << 20)[50_000:350_000]


@pytest.mark.parametrize("quality,lgblock", [(11, 16), (10, 18)])
def test_compress_matches_jax_stream(v3, data, quality, lgblock):
    arr = np.frombuffer(data, np.uint8)
    ref = JE._encode_q11_streamed(arr, len(arr),
                                  C.max_backward_distance(22), quality,
                                  lgblock, 22)
    out = bt.compress(data, quality=quality, lgblock=lgblock,
                      device="cpu")
    assert out == ref
    assert len(out) < len(data) // 3
    assert JN.decode(out) == data
    assert bt.decompress(out) == data


def test_positional_arguments_match_jax(v3, data):
    """Both packages take (string, mode, quality, lgwin, lgblock,
    dictionary, large_window, ...) and (string, dictionary,
    large_window) in that order: the positional call gives the JAX
    stream, and a positional mode, dictionary or large window reaches
    its own parameter (the JAX package's bytes and decodes)."""
    arr = np.frombuffer(data, np.uint8)
    ref = JE._encode_q11_streamed(arr, len(arr),
                                  C.max_backward_distance(22), 11, 16, 22)
    out = bt.compress(data, 0, 11, 22, 16, device="cpu")
    assert out == ref
    assert bt.decompress(out, None, False) == data == \
        brotli_tpu.decompress(out, None, False)
    small, dic = data[100_000:164_000], data[:40_000]
    assert bt.compress(small, 1) == brotli_tpu.compress(small, 1)
    with_dict = bt.compress(small, 0, 5, 22, 0, dic)
    assert with_dict == brotli_tpu.compress(small, 0, 5, 22, 0, dic)
    assert bt.decompress(with_dict, dic, False) == small == \
        brotli_tpu.decompress(with_dict, dic, False)
    large = bt.compress(small, 0, 5, 26, 0, None, True)
    assert large == brotli_tpu.compress(small, 0, 5, 26, 0, None, True)
    assert bt.decompress(large, None, True) == small
