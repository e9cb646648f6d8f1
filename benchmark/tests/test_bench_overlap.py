"""The reader of the q11 serializer pool's counters
(metrics/q11_host.serialize_overlap_share.py): the share of a window's
spans whose serialization began beside an earlier span's; nothing to
read from a program that counts no spans."""

from types import SimpleNamespace

import pytest

from benchmark import core
from brotli_tpu_torch.utils import trace

METRIC = "q11_host.serialize_overlap_share"


def read(counters, monkeypatch, dropped=0):
    monkeypatch.setattr(trace, "spans", lambda: [])
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    monkeypatch.setattr(trace, "dropped", lambda: dropped)
    window = SimpleNamespace(request_bytes=[16 << 20], device_ops=[])
    return core.load_module("metrics", METRIC).read(window)


@pytest.mark.parametrize("counts,share", [
    # three 16 MiB requests of four spans, every span after the first
    # beside another
    ({"serialize.spans": 12, "serialize.overlapped": 9}, 75),
    # one serializer's order: no span overlapped, so no counter
    ({"serialize.spans": 12}, 0),
    ({"serialize.spans": 8, "serialize.overlapped": 2,
      "serialize.ring_redo": 1}, 25)])
def test_the_share_of_spans_serialized_side_by_side(monkeypatch, counts,
                                                    share):
    assert read(counts, monkeypatch) == pytest.approx(share)


@pytest.mark.parametrize("counts", [
    {}, {"serialize.spans": 0}, {"serialize.overlapped": 3},
    {"dp.dict-probe.bytes": 1 << 20}])
def test_nothing_to_read_without_spans(monkeypatch, counts):
    """The parent's serializer counts no spans; q5 hands none over."""
    assert read(counts, monkeypatch) is None


def test_nothing_to_read_where_the_trace_dropped_spans(monkeypatch):
    counts = {"serialize.spans": 4, "serialize.overlapped": 3}
    assert read(counts, monkeypatch, dropped=2) is None


def test_nothing_to_read_from_a_trace_without_counters(monkeypatch):
    for name in ("spans", "counters", "dropped"):
        monkeypatch.delattr(trace, name)
    window = SimpleNamespace(request_bytes=[1 << 20], device_ops=[])
    assert core.load_module("metrics", METRIC).read(window) is None
