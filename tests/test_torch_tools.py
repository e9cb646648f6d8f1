"""The port's last tools against the JAX package's, on the CPU.

  (a) `tools/dissect.dissect`: the same text as brotli_tpu.tools.dissect
      (plain, -v and --bits) on native q1, q5, q9 and q11 streams of
      corpus slices, one of them with static-dictionary references,
      and on every file of tests/fuzz_corpus/ (or the same error);
      `main` on a file;
  (b) `tools/replay`: `parse_stream` and `replay` give the JAX bytes
      for q5, q9 and q11 streams, and the replay decodes; `main`
      without the reference CLI exits with a message;
  (c) `enc/bitstream.ACCOUNT_SINK`: the JAX entries for the same
      `store_metablock` inputs at q5 and q11, and the same stream
      bytes with the sink set and unset;
  (d) `tools/stress` with device="cpu": two seeded trials of every
      route, the device routes held at their thresholds (q10/q11 on
      256 KiB, the device matcher on 64 KiB), zero failures, and each
      route's kernels reached (counting stand-ins over the wrappers'
      plain paths); `main` on four small trials;
  (e) the stress's native, python and raw-dictionary routes give
      brotli_tpu.compress's bytes on the same trials (a raw-dictionary
      stream wherever the JAX one decodes: ROADMAP queue 3).

The DP's segments, the matcher's buckets and the device serializer's
buckets are shrunk as in the other tests. Inputs are in-repo only.
"""

import io
import os
import pathlib
import threading

import numpy as np
import pytest
import torch

import brotli_tpu
from brotli_tpu.enc import bitstream as JB
from brotli_tpu.format.bitio import BitWriter as JBW
from brotli_tpu.tools import dissect as JDI
from brotli_tpu.tools import replay as JRE
from brotli_tpu_torch import native as PN
from brotli_tpu_torch.enc import bitstream as PB
from brotli_tpu_torch.enc import matcher as PM_
from brotli_tpu_torch.format import constants as C
from brotli_tpu_torch.format.bitio import BitWriter as PBW
from brotli_tpu_torch.ops import bitpack as PBP
from brotli_tpu_torch.ops import lz_resolve as LZ
from brotli_tpu_torch.ops import matcher as PM
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel import device_serialize as DS
from brotli_tpu_torch.tools import dissect as PDI
from brotli_tpu_torch.tools import replay as PRE
from brotli_tpu_torch.tools import stress
from brotli_tpu_torch.tools.corpus import build_corpus

REPO = pathlib.Path(__file__).resolve().parent.parent
FUZZ = sorted((REPO / "tests" / "fuzz_corpus").glob("*.bin"))
CORPUS = build_corpus(1 << 20)
MAXD = C.max_backward_distance(22)
SEG = 1 << 16
JOIN_S = 600
# the stress trials of (d): seed 6 draws a q11 card trial and
# encoder="device" trials at q2 and q11, each at its threshold
# (asserted below)
STRESS_SEED = 6
STRESS_SIZES = (stress.SMALL, (64 << 10, (64 << 10) + 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_serializer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slice(q, size=20_000):
    return {1: CORPUS[:size], 5: CORPUS[300_000:300_000 + size],
            9: CORPUS[600_000:600_000 + size],
            11: CORPUS[900_000:900_000 + size]}[q]


STREAMS = {f"q{q}": (q, _slice(q)) for q in (1, 5, 9, 11)}
# dictionary text: its stream holds static-dictionary references
STREAMS["q5 dictionary refs"] = (5, CORPUS[400_000:430_000])


def _dissect(mod, blob, verbose, bits):
    out = io.StringIO()
    try:
        mod.dissect(blob, verbose=verbose, bits=bits, out=out)
    except Exception as e:
        return type(e).__name__, getattr(e, "code", None)
    return "ok", out.getvalue()


OPTIONS = {"plain": (False, False), "-v": (True, False),
           "--bits": (False, True)}


# -- (a) dissect ----------------------------------------------------------

@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("name", STREAMS)
def test_dissect_matches_jax(name, option):
    q, data = STREAMS[name]
    blob = PN.encode(data, q, 22)
    got = _dissect(PDI, blob, *OPTIONS[option])
    assert got == _dissect(JDI, blob, *OPTIONS[option])
    assert got[0] == "ok"
    if name == "q5 dictionary refs":
        refs = int(got[1].split("(dictionary) refs: ~")[1].split()[0])
        assert refs > 0


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("path", FUZZ, ids=[p.name for p in FUZZ])
def test_dissect_fuzz_corpus_matches_jax(path, option):
    blob = path.read_bytes()
    assert (_dissect(PDI, blob, *OPTIONS[option]) ==
            _dissect(JDI, blob, *OPTIONS[option]))


def test_dissect_main(tmp_path, capsys):
    q, data = STREAMS["q9"]
    f = tmp_path / "s.br"
    f.write_bytes(PN.encode(data, q, 22))
    assert PDI.main(["-v", str(f)]) == 0
    got = capsys.readouterr().out
    want = io.StringIO()
    JDI.dissect(f.read_bytes(), verbose=True, out=want)
    assert got == want.getvalue()


# -- (b) replay -----------------------------------------------------------

@pytest.mark.parametrize("q", [5, 9, 11])
def test_replay_matches_jax(q, monkeypatch):
    data = _slice(q, 60_000)
    blob = PN.encode(data, q, 22)
    out, matches = PRE.parse_stream(blob, MAXD)
    monkeypatch.setattr(JRE, "d_maxback", MAXD)
    jout, jmatches = JRE.parse_stream(blob)
    assert out == jout == data
    for a, b in zip(matches, jmatches):
        np.testing.assert_array_equal(a, b)
    got = PRE.replay(data, blob, q, 22)
    assert got == JRE.replay(data, blob, q, 22)
    assert PN.decode(got) == data


def test_replay_main_needs_the_reference_cli(tmp_path, monkeypatch):
    f = tmp_path / "in"
    f.write_bytes(b"abc")
    monkeypatch.setattr(PRE, "REF_CLI", tmp_path / "no-brotli")
    with pytest.raises(SystemExit, match="reference CLI .* is missing"):
        PRE.main([str(f)])


# -- (c) ACCOUNT_SINK -----------------------------------------------------

def _store(B, BW, arr, matches, quality):
    bw = BW()
    B.write_stream_header(bw, 22)
    cmds = PM_.matches_to_commands(*matches, 0, len(arr))
    B.store_metablock(bw, arr, 0, len(arr), cmds, True, None,
                      quality=quality)
    bw.align_to_byte()
    return bw.getvalue()


@pytest.mark.parametrize("quality", [5, 11])
def test_account_sink_matches_jax(quality, monkeypatch):
    arr = np.frombuffer(CORPUS[380_000:380_000 + (1 << 16)], np.uint8)
    matches = PM_.find_matches_vectorized(arr, MAXD, num_candidates=4,
                                          use_dict=True)
    assert (matches[3] >= 2).any(), "no dictionary reference in the parse"
    plain = _store(PB, PBW, arr, matches, quality)
    sink, jsink = [], []
    monkeypatch.setattr(PB, "ACCOUNT_SINK", sink)
    monkeypatch.setattr(JB, "ACCOUNT_SINK", jsink)
    got = _store(PB, PBW, arr, matches, quality)
    assert got == plain == _store(JB, JBW, arr, matches, quality)
    assert len(sink) == 1 and sink == jsink
    assert sink[0]["nlit"] + int(matches[1].sum()) == len(arr)


# -- (d) the stress, every route on the CPU ---------------------------------

# the wrappers each kernel's route runs through: (module, name)
WRAPPERS = {"suffix_min": (O, "suffix_min"), "dp_scan": (O, "dp_scan"),
            "dp_backtrack": (O, "dp_backtrack"),
            "dp_scan_v1": (O, "dp_scan_v1"),
            "dp_scan_ring": (O, "dp_scan_ring"),
            "chain_select": (PM, "chain_select"),
            "bitpack": (PBP, "pack"), "lz_resolve": (LZ, "resolve")}


@pytest.fixture(scope="module")
def shrunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PM, "_BUCKETS", [1 << 16, 1 << 17])
        mp.setattr(PM, "SEG_BYTES", 1 << 17)
        mp.setattr(O, "SEG_V3", SEG)
        mp.setattr(O, "BUCKETS_V3", [SEG])
        mp.setattr(O, "SEG", SEG)
        mp.setattr(O, "BUCKETS", [SEG])
        mp.setattr(DS, "_BUCKETS", [1 << 16, 1 << 19])
        yield mp


@pytest.fixture(scope="module")
def stress_trials():
    return list(stress.trials(STRESS_SEED, 2 * len(stress.ROUTES),
                              STRESS_SIZES))


def _expected(t):
    """The kernels trial t reaches on its route (their wrappers' plain
    paths on the CPU)."""
    r, q = t.route, t.q
    want = set() if "dictionary" in r else {"lz_resolve"}
    dp = {"suffix_min", "dp_scan", "dp_backtrack"}
    if r == "card_v1":
        return want | {"dp_scan_v1", "dp_backtrack"}
    if r == "card_ring":
        return want | {"suffix_min", "dp_scan_ring", "dp_backtrack"}
    if r in ("card", "compressor_card"):
        return want | dp
    if r in stress.SMALL_ROUTES:
        return want
    return (want | (dp if q >= 10 else {"chain_select"}) |
            ({"bitpack"} if r == "sharded_device" else set()))


def _in_thread(fn):
    """fn() on a thread joined with a timeout: a hang fails the test."""
    res = {}
    th = threading.Thread(target=lambda: res.update(out=fn()), daemon=True)
    th.start()
    th.join(JOIN_S)
    assert not th.is_alive(), "the stress hung"
    return res["out"]


@pytest.mark.parametrize("route", stress.ROUTES)
def test_stress_route_on_cpu(route, shrunk, stress_trials, monkeypatch):
    mine = [t for t in stress_trials if t.route == route]
    assert len(mine) == 2
    reached = set()
    for name, (mod, attr) in WRAPPERS.items():
        def spy(*a, _f=getattr(mod, attr), _name=name, **k):
            reached.add(_name)
            return _f(*a, **k)
        monkeypatch.setattr(mod, attr, spy)
    out = io.StringIO()
    failures = _in_thread(lambda: stress.run(mine, "cpu", out=out))
    assert failures == [], out.getvalue()
    want = set().union(*map(_expected, mine))
    assert want <= reached, (want - reached, out.getvalue())
    if route not in stress.SMALL_ROUTES:  # held at the thresholds
        assert all(len(t.data) == stress._least_size(route, t.q)
                   for t in mine)
    if route == "card":
        assert any(t.q == 11 and len(t.data) == 256 << 10 for t in mine)
    if route == "device":
        assert any(t.q <= 9 and len(t.data) == 64 << 10 for t in mine)


def test_stress_main(capsys):
    assert _in_thread(lambda: stress.main(
        ["--n", "4", "--device", "cpu"])) == 0
    assert "done: 4 trials, 0 failures" in capsys.readouterr().out


# -- (e) the byte routes against brotli_tpu.compress ------------------------

BYTE_ROUTES = ("native", "python", "raw_dictionary")


@pytest.fixture(scope="module")
def byte_trials():
    return [t for t in stress.trials(STRESS_SEED, 6 * len(stress.ROUTES),
                                     STRESS_SIZES)
            if t.route in BYTE_ROUTES]


@pytest.mark.parametrize("route", BYTE_ROUTES)
def test_stress_bytes_match_jax(route, byte_trials, monkeypatch):
    for k in list(os.environ):
        if k.startswith("BROTLI_TPU_"):
            monkeypatch.delenv(k)
    if route == "python":
        monkeypatch.setenv("BROTLI_TPU_ENCODER", "python")
        monkeypatch.setenv("BROTLI_TPU_BACKEND", "numpy")
    mine = [t for t in byte_trials if t.route == route]
    assert len(mine) == 6
    compared = 0
    for t in mine:
        got, dic = stress.encode(t, "cpu")
        want = brotli_tpu.compress(t.data, quality=t.q, lgwin=t.lgwin,
                                   dictionary=dic)
        if dic is not None:
            try:  # the JAX raw-dictionary fault: its stream may not decode
                ok = PN.decode(want, compound=dic) == t.data
            except ValueError:
                ok = False
            if not ok:
                continue
        assert got == want, (t.trial, t.q, t.lgwin, len(t.data))
        compared += 1
    assert compared >= 3
