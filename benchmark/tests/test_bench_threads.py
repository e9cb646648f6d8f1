"""The reader of the native serializer's threaded count
(metrics/q11_host.serialize_threaded_share.py): the share of a window's
metablocks whose literal passes ran on more than one thread; nothing to
read from a program that counts no metablocks, or none threaded."""

from types import SimpleNamespace

import pytest

from benchmark import core
from brotli_tpu_torch.utils import trace

METRIC = "q11_host.serialize_threaded_share"


def read(counters, monkeypatch, dropped=0):
    monkeypatch.setattr(trace, "spans", lambda: [])
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    monkeypatch.setattr(trace, "dropped", lambda: dropped)
    window = SimpleNamespace(request_bytes=[1 << 20], device_ops=[])
    return core.load_module("metrics", METRIC).read(window)


@pytest.mark.parametrize("counts,share", [
    # one-span font requests, each metablock's passes side by side
    ({"serialize.metablocks": 80, "serialize.threaded": 80}, 100),
    # four 16 MiB requests: a span's budget was one core for 4 of 16
    ({"serialize.metablocks": 16, "serialize.threaded": 12,
      "serialize.spans": 16}, 75),
    # every metablock on one thread (a one-core host, or q10/q11
    # metablocks too small for the passes)
    ({"serialize.metablocks": 6, "serialize.threaded": 0}, 0)])
def test_the_share_of_metablocks_serialized_on_several_threads(
        monkeypatch, counts, share):
    assert read(counts, monkeypatch) == pytest.approx(share)


@pytest.mark.parametrize("counts", [
    {}, {"serialize.metablocks": 0, "serialize.threaded": 0},
    {"serialize.threaded": 3},
    # a serializer that counts its metablocks but has no thread budget
    {"serialize.metablocks": 8, "serialize.dist_params": 8},
    {"dp.dict-probe.bytes": 1 << 20}])
def test_nothing_to_read_without_threaded_metablocks(monkeypatch, counts):
    assert read(counts, monkeypatch) is None


def test_nothing_to_read_where_the_trace_dropped_spans(monkeypatch):
    counts = {"serialize.metablocks": 4, "serialize.threaded": 4}
    assert read(counts, monkeypatch, dropped=2) is None


def test_nothing_to_read_from_a_trace_without_counters(monkeypatch):
    for name in ("spans", "counters", "dropped"):
        monkeypatch.delattr(trace, name)
    window = SimpleNamespace(request_bytes=[1 << 20], device_ops=[])
    assert core.load_module("metrics", METRIC).read(window) is None
