"""The readers of the program's spans and counters (spans.py and its
four metrics) on synthetic windows: known values, spans of two threads
that overlap, request spans that are no stages, and nothing to read
where the trace dropped spans or records none."""

from types import SimpleNamespace

import pytest

from benchmark import core
from benchmark import spans as S
from brotli_tpu_torch.utils import trace

S_NS = 1_000_000_000
MIB = 1 << 20


def span(name, a, b, thread=1, request=1):
    """A trace.Span from a to b seconds."""
    return trace.Span(name, int(a * S_NS), int(b * S_NS), thread, request,
                      None, None)


def read(metric, window, spans, counters=None, dropped=0,
         monkeypatch=None):
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    monkeypatch.setattr(trace, "counters", lambda: dict(counters or {}))
    monkeypatch.setattr(trace, "dropped", lambda: dropped)
    return core.load_module("metrics", metric).read(window)


def window(mib=2, device_ops=()):
    return SimpleNamespace(request_bytes=[mib * MIB // 2] * 2,
                           device_ops=list(device_ops))


# two requests of 4 s: the main thread's stages, a worker's serialize
# overlapping them, and the card busy from 1 to 2 s and 6 to 6.5 s
REQUESTS = [span("request", 0, 4), span("request", 4.5, 8, request=2)]
STAGES = [span("dp.seed", 0, 1), span("dp.dict-probe", 1, 2.5),
          span("serialize.wait", 2.5, 3.5),
          span("serialize", 2, 3.8, thread=2),
          span("dp.seed", 4.5, 6, request=2),
          span("serialize.wait", 6, 7.5, request=2),
          span("serialize", 6.5, 7.9, thread=2, request=2)]
DEVICE = [("dp_scan", 1.0, 2.0), ("memcpy", 6.0, 6.5)]


def test_idle_unspanned_share_counts_idle_time_in_no_stage():
    # window 0-8 s: busy 1.5 s, idle 6.5 s; stages (any thread) and the
    # card cover all but 3.8-4 (the first request's end), 4-4.5 (between
    # requests) and 7.9-8 s: 0.8 s of 6.5
    got = S.idle_unspanned_share(REQUESTS + STAGES, DEVICE)
    assert got == pytest.approx(100 * 0.8 / 6.5)
    # the worker's serialize alone covers 3.5-3.8 and 7.5-7.9 s: without
    # it, 3.5-4.5 and 7.5-8 s are in no stage
    main = [s for s in STAGES if s.thread == 1]
    assert S.idle_unspanned_share(REQUESTS + main, DEVICE) == \
        pytest.approx(100 * 1.5 / 6.5)
    # request spans are no stages: with nothing else, all idle time is
    assert S.idle_unspanned_share(REQUESTS, DEVICE) == pytest.approx(100)
    assert S.idle_unspanned_share(STAGES, DEVICE) is None  # no request
    # device time outside the requests is clipped off
    assert S.idle_unspanned_share(
        REQUESTS + STAGES, DEVICE + [("k", -5, 0.0), ("k", 8, 9)]) == \
        pytest.approx(100 * 0.8 / 6.5)


def test_the_four_readers_give_known_values(monkeypatch):
    w = window(mib=2, device_ops=DEVICE)
    sp = REQUESTS + STAGES + [span("match.extend", 0, 0.5),
                              span("match.extend", 0.2, 0.4, thread=3)]
    counts = {"match.extend.caphits": 100_000,
              "match.extend.extensions": 35_000}
    got = {m: read(m, w, sp, counts, monkeypatch=monkeypatch) for m in
           ("q11_host.serialize_wait_ms_per_MiB", "q5_match.caphits_per_MiB",
            "q5_match.extend_us_per_extension", "idle_unspanned_share")}
    assert got["q11_host.serialize_wait_ms_per_MiB"] == \
        pytest.approx(1e3 * (1.0 + 1.5) / 2)
    assert got["q5_match.caphits_per_MiB"] == pytest.approx(50_000)
    # both threads' spans count, overlapping or not: 0.7 s
    assert got["q5_match.extend_us_per_extension"] == \
        pytest.approx(1e6 * 0.7 / 35_000)
    assert got["idle_unspanned_share"] == pytest.approx(100 * 0.8 / 6.5)


@pytest.mark.parametrize("metric", [
    "q11_host.serialize_wait_ms_per_MiB", "q5_match.caphits_per_MiB",
    "q5_match.extend_us_per_extension", "idle_unspanned_share"])
def test_nothing_to_read_when_spans_were_dropped(monkeypatch, metric):
    counts = {"match.extend.caphits": 10, "match.extend.extensions": 5}
    sp = REQUESTS + STAGES + [span("match.extend", 0, 0.5)]
    w = window(device_ops=DEVICE)
    assert read(metric, w, sp, counts, monkeypatch=monkeypatch) is not None
    assert read(metric, w, sp, counts, dropped=1,
                monkeypatch=monkeypatch) is None


@pytest.mark.parametrize("metric", [
    "q11_host.serialize_wait_ms_per_MiB", "q5_match.caphits_per_MiB",
    "q5_match.extend_us_per_extension", "idle_unspanned_share"])
def test_nothing_to_read_from_a_trace_without_spans(monkeypatch, metric):
    """A program whose trace records no spans or counters (the port
    before it did) gives nothing to read and raises nothing."""
    for name in ("spans", "counters", "dropped"):
        monkeypatch.delattr(trace, name)
    assert core.load_module("metrics", metric).read(
        window(device_ops=DEVICE)) is None


def test_nothing_to_read_where_the_route_left_none(monkeypatch):
    """q5's window has no serialize.wait; q11's counts no cap hits."""
    w = window(device_ops=DEVICE)
    assert read("q11_host.serialize_wait_ms_per_MiB", w, REQUESTS,
                monkeypatch=monkeypatch) is None
    assert read("q5_match.caphits_per_MiB", w, REQUESTS,
                monkeypatch=monkeypatch) is None
    assert read("q5_match.extend_us_per_extension", w, REQUESTS,
                {"match.extend.extensions": 0},
                monkeypatch=monkeypatch) is None
