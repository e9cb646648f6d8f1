"""The CLI-window configuration (configs/q11_w24.json), the `deploys`
traffic of gen/deploys.py, the halo segments (shapes/dp_segment_halo.py)
and their roofline files, the cell's readers on synthetic windows, and
the plain reference on a lgwin 24 stream with copies from more than
8 MiB back. Also the q5 cell on `bulk16m`."""

import io
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import core, reference
from brotli_tpu_torch.utils import trace

DOC = 16_793_600
MIB = 1 << 20
READERS = ("w24.far_copy_share", "w24.far_dp_share", "w24_kernels_roofline")


def _traffic():
    t = core.load_json("traffic", "deploys")
    return core.load_module("gen", t["gen"]), t["params"]


# -- the traffic --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 7])
def test_deploys_are_two_ustar_deploys_of_the_data_files(seed):
    gen, params = _traffic()
    docs = gen.documents(seed, **params)
    assert [len(d) for d in docs] == [DOC] * params["pool"] == [DOC, DOC]
    assert docs[0] != docs[1]
    members = params["members"]
    # the seed rotates the members; the second document starts half way
    # round from the first
    assert docs == gen.documents(seed + len(members), **params) == \
        gen.documents(seed + len(members) // 2, **params)[::-1]
    assert gen.documents(seed + 1, **params)[0] != docs[0]
    for i, doc in enumerate(docs):
        tar = tarfile.open(fileobj=io.BytesIO(doc))
        got = tar.getmembers()
        assert [m.name for m in got if m.isdir()] == ["v1", "v2"]
        files = [m for m in got if m.isfile()]
        # document j's directories both list the members rotated by
        # seed + 7 j
        k = (seed + 7 * i) % len(members)
        order = members[k:] + members[:k]
        assert [m.name for m in files] == \
            [f"{d}/{m[0]}" for d in ("v1", "v2") for m in order]
        for m in files:
            assert (m.mode, m.mtime, m.uid, m.gid, m.uname, m.gname) == \
                (0o644, 0, 0, 0, "", "")
        by = {m.name: m for m in files}
        for name, old, new in members:
            for d, path in (("v1", old), ("v2", new)):
                assert tar.extractfile(by[f"{d}/{name}"]).read() == \
                    (core.HERE / "data" / path).read_bytes()
            far = by[f"v2/{name}"].offset_data - by[f"v1/{name}"].offset_data
            assert 8_078_336 <= far <= 8_710_656 and far > 4 * MIB


def test_the_cli_picks_lgwin_24_for_the_archive():
    """c/tools/brotli.c CompressFiles with no -w: the smallest lgwin from
    BROTLI_MIN_WINDOW_BITS whose BROTLI_MAX_BACKWARD_LIMIT holds the
    file, stopping at DEFAULT_LGWIN 24."""
    def cli_lgwin(size):
        lgwin = 10
        while (1 << lgwin) - 16 < size:
            lgwin += 1
            if lgwin == 24:
                break
        return lgwin
    assert cli_lgwin(DOC) == 24
    assert cli_lgwin((8 << 20) - 16) == 23
    assert cli_lgwin((8 << 20) - 15) == 24
    assert cli_lgwin(1 << 30) == 24
    config = core.load_json("configs", "q11_w24")
    assert config["kwargs"] == {"quality": 11, "lgwin": cli_lgwin(DOC)}
    assert config["guarantee"] == {"format": "RFC 7932", "lossless": True,
                                   "window_bits": 24}
    assert config["warmup_bytes"] == DOC and config["reduced"] == []


def test_the_reference_decodes_copies_from_past_8_mib():
    """A native lgwin 24 stream whose random 64 KiB block comes again
    8,978,432 bytes later, after random 64 KiB chunks repeated: shorter
    than the literals of the three random blocks, so the block's second
    time is a copy from 8.56 MiB back; the frozen reference decodes it
    and reads window 24."""
    from brotli_tpu_torch import native
    rng = np.random.default_rng(0)
    blk = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    chunk = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    doc = blk + chunk * 136 + blk
    stream = native.encode(doc, 5, 24)
    assert len(stream) < 3 << 16
    assert reference.window_bits(stream) == 24
    assert reference.decompress(stream) == doc


# -- the segments and their rooflines -----------------------------------------

def _shape(window=None):
    params = dict(core.load_json("configs", "q11_w24")["shapes"][
        "dp_segment_halo"])
    if window is not None:
        params["window"] = window
    return core.load_module("shapes", "dp_segment_halo").segments(DOC,
                                                                  **params)


def test_halo_segments_cut_the_archive_as_the_program_does():
    segs = _shape()
    assert [s["n"] for s in segs] == [4 * MIB] * 4 + [2 * MIB]
    assert [s["halo"] for s in segs] == [0, 4 * MIB, 8 * MIB, 12 * MIB,
                                         12 * MIB]
    # the last segment's 16 KiB leave most of its bucket's padding to the
    # halo's tail; the rest of the halo is candidate rows
    inside = (2 * MIB - (16 << 10)) // 4096 * 4096
    assert [s["nh"] for s in segs] == [4 * MIB, 8 * MIB, 12 * MIB, 16 * MIB,
                                       2 * MIB + 12 * MIB - inside]
    assert all(s["nslots"] == 29 for s in segs)
    # at lgwin 22's window the segments are dp_segment's
    plain = core.load_module("shapes", "dp_segment").segments(
        DOC, **core.load_json("configs", "q11_w22")["shapes"]["dp_segment"])
    assert [{k: s[k] for k in plain[0]} for s in _shape(4 * MIB)] == plain
    assert all(s["halo"] == 0 and s["nh"] == s["n"] for s in _shape(4 * MIB))


def test_halo_rooflines_count_the_candidate_rows():
    seg = _shape()[3]
    n, nh = seg["n"], seg["nh"]
    keys = core.load_module("rooflines", "edge_keys_halo")
    ranks = core.load_module("rooflines", "edge_ranks_halo")
    assert keys.SHAPE == ranks.SHAPE == "dp_segment_halo"
    assert (keys.KERNEL, ranks.KERNEL) == ("edge_keys_kernel",
                                           "edge_ranks_kernel")
    assert keys.counts(seg) == [(5 * nh, 20 * nh)] * 2
    assert ranks.counts(seg) == [(13 * nh + 4 * r * n, 8 * r * n)
                                 for r in (13, 14)]
    # without a halo they are the plain files' counts
    flat = dict(seg, nh=n)
    for name in ("edge_keys", "edge_ranks"):
        plain = core.load_module("rooflines", name)
        halo = core.load_module("rooflines", name + "_halo")
        assert halo.counts(flat) == plain.counts(flat)


# -- the readers --------------------------------------------------------------

def read(metric, window, counters=None, monkeypatch=None):
    span = trace.Span("request", 0, 1, 1, 1, None, None)
    monkeypatch.setattr(trace, "spans", lambda: [span])
    monkeypatch.setattr(trace, "counters", lambda: dict(counters or {}))
    monkeypatch.setattr(trace, "dropped", lambda: 0)
    return core.load_module("metrics", metric).read(window)


def window(device_ops=(), nreq=2, warned=None):
    ops = list(device_ops)
    return SimpleNamespace(
        config=core.load_json("configs", "q11_w24"),
        request_bytes=[DOC] * nreq, device_ops=ops, stages={},
        busy_s=core.device_intervals_union((a, b) for _, a, b in ops),
        device_kind="NVIDIA H100 80GB HBM3",
        warn=(warned if warned is not None else []).append)


def test_the_far_readers_give_known_values(monkeypatch):
    counts = {"dp.far_bytes": DOC // 2, "dp.far_seed_bytes": DOC // 8}
    assert read("w24.far_copy_share", window(), counts,
                monkeypatch) == pytest.approx(25.0)
    assert read("w24.far_dp_share", window(), counts,
                monkeypatch) == pytest.approx(75.0)


def test_nothing_to_read_without_counters_or_trace(monkeypatch):
    for metric in READERS:
        assert read(metric, window(), {}, monkeypatch) is None
    assert read("w24.far_dp_share", window(),
                {"dp.far_bytes": 0, "dp.far_seed_bytes": 0},
                monkeypatch) is None
    for name in ("spans", "counters", "dropped"):
        monkeypatch.delattr(trace, name)
    for metric in READERS:
        assert core.load_module("metrics", metric).read(window()) is None


def _launches(scale, nreq=2):
    """Each request's DP kernels at the archive's segments, every launch
    `scale` times its bound, with a K12 launch between requests."""
    roof = core.load_module("metrics", "w24_kernels_roofline")
    pk = core.peaks("NVIDIA H100 80GB HBM3")
    ops, t = [], 0.0
    for _ in range(nreq):
        ops.append(("dict_probe_kernel", t, t + 0.5))
        t += 0.5
        for name in roof.KERNELS:
            r = core.load_module("rooflines", name)
            for seg in _shape():
                for nb, nop in r.counts(seg):
                    b = max(nb / pk["bytes_per_s"], nop / pk["ops_per_s"])
                    ops.append((r.KERNEL, t, t + b * scale))
                    t += b * scale
    return ops


def test_the_roofline_is_its_kernels_bound_over_their_own_time(
        monkeypatch):
    halo = {"dp.halo_bytes": 2 * sum(s["halo"] for s in _shape())}
    for slow in (1.0, 2.0, 25.0):
        got = read("w24_kernels_roofline", window(_launches(slow)), halo,
                   monkeypatch)
        assert got == pytest.approx(100.0 / slow) and got <= 100.0 + 1e-9


def test_a_halo_other_than_the_programs_leaves_k9_and_k10_out(monkeypatch):
    """A program that counts no halo (or another one) ran K9 and K10 over
    other rows than the shapes count: their bounds and times are left
    out, and the result line says so."""
    ops = [(n, a, b * 2.0) for n, a, b in _launches(1.0)]
    for counts in ({}, {"dp.halo_bytes": 1}):
        warned = []
        got = read("w24_kernels_roofline", window(ops, warned=warned),
                   counts, monkeypatch)
        assert 0 < got <= 100
        assert any(m.startswith("edge_keys_halo") for m in warned)
        assert any(m.startswith("edge_ranks_halo") for m in warned)


# -- the cells ----------------------------------------------------------------

def test_the_cells_and_their_metrics():
    spec = core.spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["q11_w24.deploys"] == {
        "name": "q11_w24.deploys", "config": "q11_w24",
        "traffic": "deploys", "chips": 1,
        "why": cells["q11_w24.deploys"]["why"]}
    assert (cells["q5_w22.bulk16m"]["config"],
            cells["q5_w22.bulk16m"]["traffic"],
            cells["q5_w22.bulk16m"]["chips"]) == ("q5_w22", "bulk16m", 1)
    w24 = {m["name"] for m in core.cell(spec, "q11_w24.deploys")[
        "per_layer"]}
    # every layer the cell runs: the seed parse, the probe, the DP, the
    # serializer pool, the card
    assert w24 == set(READERS) | {
        "q11_host.seed_ms_per_MiB", "q11_host.dict_probe_ms_per_MiB",
        "q11_probe.hits_per_MiB", "serialize_ms_per_MiB",
        "q11_host.serialize_wait_ms_per_MiB",
        "q11_host.serialize_overlap_share",
        "q11_host.serialize_threaded_share", "device_idle_share",
        "idle_unspanned_share"}
    # and q5's: the matcher's passes, K2, the serializer, the card
    q5 = {m["name"] for m in core.cell(spec, "q5_w22.bulk16m")["per_layer"]}
    assert q5 == {"q5_match.dict_post_ms_per_MiB",
                  "q5_match.caphits_per_MiB", "q5_match.extend_ms_per_MiB",
                  "q5_match.extend_us_per_extension",
                  "serialize_ms_per_MiB", "matcher_kernels_roofline",
                  "device_idle_share", "idle_unspanned_share"}
