"""utils/trace on the CPU: nothing recorded with tracing off; spans with
their parent, thread and request, the q11 serializer worker's too;
_extend_capped's counters; spans on the profiler's clock and in
device_profile's Chrome trace; reset, report, the buffer's cap; and the
benchmark's readers of spans and counters in a traced run of each cell,
cut to a size the CPU runs."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from brotli_tpu.enc import matcher as JM
from brotli_tpu_torch import decompress
from brotli_tpu_torch.enc.matcher import _extend_capped
from brotli_tpu_torch.ops import matcher as M
from brotli_tpu_torch.ops import optimal as O
from brotli_tpu_torch.parallel.shard import compress_sharded
from brotli_tpu_torch.utils import trace
from test_torch_matcher import access_log_parse  # noqa: F401

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def clean_trace():
    """Each test starts with tracing off and nothing recorded, and
    leaves it so; torch on one intra-op thread (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()
    torch.set_num_threads(n)


def _shrunk(mp):
    """The program's segments and buckets cut so its plain versions run
    on the CPU in seconds."""
    mp.setattr(O, "SEG_V3", 1 << 16)
    mp.setattr(O, "BUCKETS_V3", [1 << 16])
    mp.setattr(M, "_BUCKETS", [1 << 16, 1 << 17])
    mp.setattr(M, "SEG_BYTES", 1 << 17)


def test_tracing_off_records_nothing_and_allocates_no_span(monkeypatch):
    _shrunk(monkeypatch)
    data = bytes(np.random.default_rng(5).integers(0, 16, 1 << 18,
                                                   dtype=np.uint8))
    assert decompress(compress_sharded(data, quality=5,
                                       device="cpu")) == data
    assert trace.spans() == [] and trace.counters() == {}
    assert trace.report() == {} and trace.dropped() == 0
    # one shared object, whatever the name: nothing allocated a call
    assert trace.stage("a") is trace.stage("b") is \
        trace.request("r", 1) is trace.adopt(trace.carry())
    assert trace.carry() is None
    with trace.request("r", 1) as req:
        req.done(2)
    trace.count("c", 3)
    assert trace.spans() == [] and trace.counters() == {}


def test_reset_clears_spans_and_counters_and_report_keeps_its_shape():
    trace.enable()
    with trace.stage("a"):
        with trace.stage("b"):
            pass
    with trace.stage("a"):
        pass
    trace.count("c")
    trace.count("c", 4)
    rep = trace.report()
    assert set(rep) == {"a", "b"}
    assert rep["a"][0] == 2 and rep["b"][0] == 1
    assert all(isinstance(s, float) and s >= 0 for _, s in rep.values())
    assert trace.counters() == {"c": 5}
    sp = trace.spans()
    assert [s.name for s in sp] == ["a", "b", "a"]
    assert [s.parent for s in sp] == [None, 0, None]
    assert sp[0].start_ns <= sp[1].start_ns <= sp[1].end_ns <= sp[0].end_ns
    trace.reset()
    assert trace.spans() == [] and trace.counters() == {}
    assert trace.report() == {} and trace.dropped() == 0


def test_the_buffer_keeps_its_capacity_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.enable()
    for _ in range(5):
        with trace.stage("s"):
            pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2
    assert trace.report()["s"][0] == 5  # the sums count every span
    trace.reset()
    with trace.stage("s"):
        pass
    assert len(trace.spans()) == 1 and trace.dropped() == 0


def test_requests_nest_and_threads_adopt_them():
    trace.enable()
    got = {}
    with trace.request("outer", 10) as req:
        with trace.request("inner", 3) as inner:  # reuses the open span
            inner.done(1)
        with trace.stage("work"):
            carried = trace.carry()

            def worker():
                got["thread"] = threading.get_native_id()
                with trace.adopt(carried), trace.stage("side"):
                    pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        req.done(7)
    with trace.stage("after"):
        pass
    sp = {s.name: (i, s) for i, s in enumerate(trace.spans())}
    assert set(sp) == {"request", "work", "side", "after"}
    ri, r = sp["request"]
    assert r.args == {"route": "outer", "bytes_in": 10, "bytes_out": 7}
    assert sp["work"][1].parent == ri and sp["work"][1].request == r.request
    side = sp["side"][1]
    assert side.thread == got["thread"] != r.thread
    assert side.request == r.request and side.parent == ri
    assert sp["after"][1].request is None and sp["after"][1].parent is None


def test_threads_lose_no_span_or_count():
    """More threads than cores, switching often, each under its own
    request: every span, count and sum is kept, each span under its own
    thread's parent."""
    import os
    import sys
    n_threads, rounds = 4 * (os.cpu_count() or 1) + 1, 200
    trace.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            with trace.request("r", 1):
                for _ in range(rounds):
                    with trace.stage("outer"), trace.stage("inner"):
                        trace.count("c")
        threads = [threading.Thread(target=worker)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    sp = trace.spans()
    assert trace.counters() == {"c": n_threads * rounds}
    assert trace.report()["inner"][0] == n_threads * rounds
    assert len(sp) == n_threads * (2 * rounds + 1)
    assert len({s.request for s in sp}) == n_threads
    for s in sp:
        if s.name == "inner":
            p = sp[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.request == s.request
        elif s.name == "outer":
            assert sp[s.parent].name == "request"
            assert sp[s.parent].request == s.request


def test_extend_capped_counts_cap_hits_and_extensions(access_log_parse):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, 64, dtype=np.uint8)
    y = rng.integers(0, 256, 64, dtype=np.uint8)
    data = np.concatenate([x, x, x, y, y])  # copies at distance 64
    m = np.array([64, 70, 80, 150, 200, 256, 270], np.int64)
    lens = np.array([16, 16, 16, 5, 4, 16, 20], np.int64)
    dists = np.array([64, 64, 64, 64, 3, 64, 64], np.int64)
    flags = np.array([0, 0, 0, 0, 0, 0, 2020], np.int64)
    trace.enable()
    got = _extend_capped(data, m, lens, dists, flags, 16, 1 << 24)
    # cap hits at 64, 70, 80 and 256 (the dictionary match at 270 is
    # exact); 64 extends to the end of the copy (192) and swallows 70,
    # 80 and 150; 256 extends to the end of the data, swallowing 270
    assert trace.counters() == {"match.extend.caphits": 4,
                                "match.extend.extensions": 2}
    assert got[0].tolist() == [64, 200, 256]
    assert got[1].tolist() == [128, 4, 64]
    _extend_capped(data, m[3:5], lens[3:5], dists[3:5], flags[3:5], 16,
                   1 << 24)  # no cap hit: nothing counted
    _extend_capped(data, m[:1], lens[:1], dists[:1], flags[:1], 16,
                   1 << 24)
    assert trace.counters() == {"match.extend.caphits": 5,
                                "match.extend.extensions": 3}
    # a real parse: the cap hits the reference loop takes in, and the
    # extensions it emits (its outputs at the cap or longer, flag 0)
    data, m, lens, dists, flags = access_log_parse
    ref = JM._extend_capped(data, m, lens, dists, flags, 16, 1 << 24)
    trace.reset()
    _extend_capped(data, m, lens, dists, flags, 16, 1 << 24)
    assert trace.counters() == {
        "match.extend.caphits": int(np.count_nonzero(lens >= 16)),
        "match.extend.extensions": int(np.count_nonzero(
            (ref[1] >= 16) & (ref[3] == 0)))}


def test_spans_lie_on_the_profilers_clock():
    """A span opened inside a record_function lies within that event's
    bounds, within 1 ms: both are stamped from time.time_ns()."""
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer.event"):
            with trace.stage("inner"):
                torch.arange(1 << 12).cumsum(0)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "outer.event"]
    (s,) = trace.spans()
    assert ev.start_ns() - MS <= s.start_ns <= s.end_ns <= \
        ev.start_ns() + ev.duration_ns() + MS


def test_device_profile_writes_the_spans_of_every_thread(tmp_path):
    path = tmp_path / "trace.json"
    got = {}
    with trace.device_profile(str(path)):
        assert trace.enabled()
        with trace.request("compress", 5), record_function("main.event"):
            with trace.stage("main.stage"):
                torch.arange(1 << 12).cumsum(0)
            carried = trace.carry()

            def worker():
                got["thread"] = threading.get_native_id()
                with trace.adopt(carried), trace.stage("worker.stage"):
                    torch.arange(1 << 12).cumsum(0)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert not trace.enabled()  # as it was before the block
    events = json.loads(path.read_text())["traceEvents"]
    by = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert {"request", "main.stage", "worker.stage", "main.event"} <= \
        set(by)
    assert by["worker.stage"]["tid"] == got["thread"]
    assert by["worker.stage"]["args"]["request"] == \
        by["request"]["args"]["request"]
    # on the file's own time base: the stage inside the profiler's
    # event, within 1 ms (ts and dur in microseconds)
    ev, st = by["main.event"], by["main.stage"]
    assert ev["ts"] - 1e3 <= st["ts"] <= st["ts"] + st["dur"] <= \
        ev["ts"] + ev["dur"] + 1e3
    assert any("cumsum" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def traced_cells():
    """One traced CPU run of each benchmark cell at 256 KiB documents
    (q11's smallest input for the card's route), with the spans and
    counters its window left in the trace."""
    from benchmark import core, run
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _shrunk(mp)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for wl in ("q11_w22.bulk16m", "q5_w22.logs16m"):
                cell = core.cell(core.spec(), wl)
                cell["traffic_file"]["params"]["doc_bytes"] = 1 << 18
                cell["config_file"]["warmup_bytes"] = 70_000
                r = run.run(cell, 2 ** 31 + 11, 0.01, True, device="cpu")
                out[wl] = (r, trace.spans(), trace.counters())
        finally:
            trace.reset()
            torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("wl,names", [
    ("q11_w22.bulk16m", {"q11_host.serialize_wait_ms_per_MiB",
                         "idle_unspanned_share"}),
    ("q5_w22.logs16m", {"q5_match.caphits_per_MiB",
                        "q5_match.extend_us_per_extension",
                        "idle_unspanned_share"}),
])
def test_a_traced_cpu_run_reads_the_new_metrics(traced_cells, wl, names):
    r, _, _ = traced_cells[wl]
    assert r["correct"]
    assert names <= set(r["metrics"])
    assert not [w for w in r["warnings"] if w.split(":")[0] in names]
    assert all(r["metrics"][k]["value"] >= 0 for k in names)
    assert r["metrics"]["idle_unspanned_share"]["value"] <= 100


def test_q11_spans_carry_parent_thread_and_request(traced_cells):
    r, sp, _ = traced_cells["q11_w22.bulk16m"]
    reqs = [i for i, s in enumerate(sp) if s.name == "request"]
    assert len(reqs) == r["attempted"] >= 1
    names = {s.name for s in sp}
    assert {"serialize", "serialize.wait", "dp.collect",
            "dp.upload"} <= names
    assert "dp.device" not in names
    for i, s in enumerate(sp):
        assert s.end_ns is not None and s.request is not None
        if s.name == "request":
            assert s.parent is None and s.args["route"] == "compress"
            assert s.args["bytes_in"] == 1 << 18 and s.args["bytes_out"]
            continue
        p = sp[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert s.request == p.request
        if s.name == "serialize":  # on the worker, under the request
            assert p.name == "request" and s.thread != p.thread
        else:
            assert s.thread == p.thread


def test_q5_counts_its_cap_hits(traced_cells):
    r, sp, counts = traced_cells["q5_w22.logs16m"]
    assert counts["match.extend.caphits"] >= \
        counts["match.extend.extensions"] > 0
    served = [s for s in sp if s.name == "serialize"]
    req = {s.request: s for s in sp if s.name == "request"}
    assert served and all(s.request in req for s in served)
    assert all(req[s.request].args["route"] == "compress_sharded"
               for s in served)
