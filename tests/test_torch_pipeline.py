"""(f) The port's device q11 parse, `find_matches_optimal`, against
`find_matches_optimal_jax` on the CPU, bit for bit: 200 KB in 64 KiB
segments (three full, one tail padded to its bucket), so the fast first
segment, its dictionary-table merge and the batched collect all run.
The match arrays must also describe a valid parse of the input."""

import os

import numpy as np
import pytest
import torch

from brotli_tpu.format import constants as C
from brotli_tpu.ops import optimal_jax as OJ
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.tools.corpus import build_corpus

MAXD = C.max_backward_distance(22)
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
def parses(v3):
    arr = np.frombuffer(build_corpus(1 << 20)[120_000:320_000], np.uint8)
    port = O.find_matches_optimal(arr, MAXD, device="cpu")
    ref = OJ.find_matches_optimal_jax(arr, MAXD, 11)
    return arr, port, ref


@pytest.mark.parametrize("k,name", [(0, "pos"), (1, "len"), (2, "dist"),
                                    (3, "flag")])
def test_find_matches_optimal_matches_jax(parses, k, name):
    _, port, ref = parses
    assert port[k].dtype == np.int64
    np.testing.assert_array_equal(port[k], ref[k], err_msg=name)


def test_parse_is_valid(parses):
    arr, (m, lens, dists, flags), _ = parses
    assert len(m) > 5000
    assert np.all(np.diff(m) > 0) and np.all(m[1:] >= (m + lens)[:-1])
    assert np.all(lens >= 2) and m[-1] + lens[-1] <= len(arr)
    lz = flags == 0
    src = m[lz] - dists[lz]
    assert np.all(dists[lz] >= 1) and np.all(src >= 0)
    for s, p, ln in zip(src, m[lz], lens[lz]):
        assert bytes(arr[s:s + ln]) == bytes(arr[p:p + ln])
    words = flags >= 2000
    assert words.sum() > 10  # dictionary references survive the collect
    assert np.all(dists[words] > np.minimum(m[words], MAXD))
