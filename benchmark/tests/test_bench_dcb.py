"""The dcb configuration (configs/q11_w22_dcb.json) and its cell's five
readers on synthetic windows: known values, spans of two threads that
overlap, and nothing to read where the trace dropped spans, records
none, or the window's requests never took the dcb route (the parent
program's Python pipeline)."""

from types import SimpleNamespace

import pytest

from benchmark import core
from brotli_tpu_torch.enc import encoder as PE
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.utils import trace

S_NS = 1_000_000_000
MIB = 1 << 20
CELL = "q11_w22_dcb.versions"
READERS = ("dcb.dict_copy_share", "dcb_host.dp_ms_per_MiB",
           "dcb_host.serialize_wait_ms_per_MiB",
           "dcb_device.busy_ms_per_MiB", "dcb_kernels_roofline")
KERNELS = ("suffix_min_kernel", "dp_scan_kernel", "dp_backtrack_kernel",
           "edge_keys_kernel", "edge_ranks_kernel", "edge_rows_kernel",
           "slots_kernel")


def span(name, a, b, thread=1, request=1):
    return trace.Span(name, int(a * S_NS), int(b * S_NS), thread, request,
                      None, None)


def read(metric, window, spans, counters=None, dropped=0,
         monkeypatch=None):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters or {}))
    monkeypatch.setattr(trace, "dropped", lambda: dropped)
    return core.load_module("metrics", metric).read(window)


def window(device_ops=(), nbytes=(3 * MIB // 2, MIB // 2)):
    ops = list(device_ops)
    return SimpleNamespace(
        config=core.load_json("configs", "q11_w22_dcb"),
        request_bytes=list(nbytes), device_ops=ops,
        busy_s=core.device_intervals_union((a, b) for _, a, b in ops),
        device_kind="NVIDIA H100 80GB HBM3", warn=lambda msg: None)


# two requests of 2 MiB in all: the main thread's DP stages, a worker's
# serialize beside them
SPANS = [span("request", 0, 4), span("request", 4.5, 8, request=2),
         span("dcb.seed", 0, 1), span("dp.dict-probe", 1, 1.5),
         span("dp.dispatch", 1.5, 2), span("dcb.lift", 2, 2.25),
         span("serialize.wait", 2.25, 3.5),
         span("serialize", 2, 3.8, thread=2),
         span("dcb.seed", 4.5, 5.5, request=2),
         span("dp.collect", 5.25, 5.75, request=2, thread=3),
         span("dcb.lift", 6, 6.5, request=2),
         span("serialize.wait", 6.5, 7, request=2)]
COUNTS = {"dcb.copy_bytes": MIB, "dcb.far_bytes": 1000, "dcb.refs": 20}
DEVICE = [("dp_scan_kernel", 1.5, 2.0), ("Memcpy HtoD", 6.0, 6.25)]


def test_the_readers_give_known_values(monkeypatch):
    w = window(DEVICE)
    got = {m: read(m, w, SPANS, COUNTS, monkeypatch=monkeypatch)
           for m in READERS[:4]}
    assert got["dcb.dict_copy_share"] == pytest.approx(50.0)
    # the dp.* and dcb.* stages cover 0-2.25 s, 4.5-5.75 s (two threads
    # overlapping) and 6-6.5 s: 4 s over 2 MiB
    assert got["dcb_host.dp_ms_per_MiB"] == pytest.approx(1e3 * 4.0 / 2)
    assert got["dcb_host.serialize_wait_ms_per_MiB"] == \
        pytest.approx(1e3 * 1.75 / 2)
    assert got["dcb_device.busy_ms_per_MiB"] == \
        pytest.approx(1e3 * 0.75 / 2)


def test_the_roofline_counts_the_documents_segments(monkeypatch):
    """Two documents of 1.5 and 0.5 MiB: one segment each in the 2 MiB
    bucket, whatever the dictionary's tail in their padding; the share
    is dp_kernels_roofline's over the same launches."""
    ops = []
    t = 0.0
    for _ in range(2):
        for k, times in zip(KERNELS, (1, 1, 1, 2, 2, 1, 1)):
            for _ in range(times):
                ops.append((k, t, t + 0.001))
                t += 0.002
    warned = []
    w = window(ops)
    w.warn = warned.append
    got = core.load_module("metrics", "dcb_kernels_roofline").read(w)
    assert 0 < got <= 100 and not warned
    assert got == core.load_module("metrics", "dp_kernels_roofline").read(w)


@pytest.mark.parametrize("metric", READERS[:3])
def test_nothing_to_read_when_spans_were_dropped(monkeypatch, metric):
    w = window(DEVICE)
    assert read(metric, w, SPANS, COUNTS, monkeypatch=monkeypatch) \
        is not None
    assert read(metric, w, SPANS, COUNTS, dropped=1,
                monkeypatch=monkeypatch) is None


@pytest.mark.parametrize("metric", READERS)
def test_nothing_to_read_from_a_trace_without_spans(monkeypatch, metric):
    for name in ("spans", "counters", "dropped"):
        monkeypatch.delattr(trace, name)
    got = core.load_module("metrics", metric).read(window())
    assert got is None


@pytest.mark.parametrize("metric", READERS[:3])
def test_nothing_to_read_where_no_request_took_the_dcb_route(monkeypatch,
                                                            metric):
    """The parent's Python pipeline: its dp.* stages, a match-find, no
    dcb.* stage and no dcb counter."""
    sp = [span("request", 0, 4), span("match-find", 0, 3),
          span("dp.dispatch", 1, 2), span("serialize", 3, 4)]
    assert read(metric, window(DEVICE), sp, {"match.extend.caphits": 3},
                monkeypatch=monkeypatch) is None


def test_the_configuration_is_the_route_it_names():
    """q11 -w 22 with encoder="device"; a warm-up of 256 KiB that takes
    the card route with every pair's dictionary; the DP shape the
    program runs, the segments of a document the program's own."""
    spec = core.spec()
    entry = next(c for c in spec["configs"] if c["name"] == "q11_w22_dcb")
    cfg = core.load_json("configs", "q11_w22_dcb")
    assert entry["reduced"] == cfg["reduced"] == []
    assert cfg["entry"] == "brotli_tpu_torch:compress"
    assert cfg["kwargs"] == {"quality": 11, "lgwin": 22,
                             "encoder": "device"}
    assert cfg["guarantee"]["window_bits"] == 22
    assert cfg["guarantee"]["lossless"] is True
    assert cfg["warmup_bytes"] == PE.MIN_DEVICE_INPUT
    shape = cfg["shapes"]["dp_segment"]
    assert shape == core.load_json("configs", "q11_w22")["shapes"][
        "dp_segment"]
    assert shape["seg_bytes"] == O.SEG_V3
    assert shape["buckets"] == O.BUCKETS_V3
    assert shape["levels"] == [[p, len(r)] for p, r in O.LEVELS]
    assert (shape["W"], shape["B"]) == (O.W, O.B)
    cell = core.cell(spec, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "versions"
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    traffic = cell["traffic_file"]
    gen = core.load_module("gen", traffic["gen"])
    seg = core.load_module("shapes", "dp_segment").segments
    for seed in (0, 1, 2):
        docs = gen.documents(seed, **traffic["params"])
        dicts = gen.dictionaries(seed, **traffic["params"])
        assert len(docs[0]) >= cfg["warmup_bytes"]
        for doc, dic in zip(docs, dicts):
            assert len(doc) + len(dic) <= PE.MAX_DCB_BYTES
            want = [O._bucket_v3(min(lo + O.SEG_V3, len(doc)) - lo)
                    for lo in range(0, len(doc), O.SEG_V3)]
            assert [s["n"] for s in seg(len(doc), **shape)] == want
