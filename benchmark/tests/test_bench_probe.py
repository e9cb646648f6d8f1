"""The reader of the q11 dictionary probe's counters
(metrics/q11_probe.hits_per_MiB.py): hits a MiB of the input probed,
where one request probes its first 4 MiB and then all of it; nothing to
read from a program that counts no probed bytes."""

from types import SimpleNamespace

import pytest

from benchmark import core
from brotli_tpu_torch.utils import trace

MIB = 1 << 20
METRIC = "q11_probe.hits_per_MiB"


def read(counters, monkeypatch, dropped=0):
    monkeypatch.setattr(trace, "spans", lambda: [])
    monkeypatch.setattr(trace, "counters", lambda: dict(counters))
    monkeypatch.setattr(trace, "dropped", lambda: dropped)
    window = SimpleNamespace(request_bytes=[16 * MIB], device_ops=[])
    return core.load_module("metrics", METRIC).read(window)


def test_hits_a_mib_of_the_probed_input(monkeypatch):
    # a 16 MiB request: 4 MiB probed early, then 16 MiB; each probe's
    # hits at 80,000 a MiB read 80,000, not 100,000 a MiB of the request
    counts = {"dp.dict-probe.bytes": 20 * MIB,
              "dp.dict-probe.hits": 4 * 80_000 + 16 * 80_000,
              "dp.dict-probe.positions": 19 * MIB,
              "dp.dict-probe.overflows": 0}
    assert read(counts, monkeypatch) == pytest.approx(80_000)
    # a probe dropped by its cap keeps no hits but probed its bytes
    counts = {"dp.dict-probe.bytes": 2 * MIB, "dp.dict-probe.hits": 0,
              "dp.dict-probe.overflows": 1}
    assert read(counts, monkeypatch) == 0


@pytest.mark.parametrize("counts", [
    {}, {"dp.dict-probe.hits": 1000}, {"dp.dict-probe.bytes": 0},
    {"match.extend.caphits": 5}])
def test_nothing_to_read_without_probed_bytes(monkeypatch, counts):
    """The parent's trace counts no probed bytes; q5 never probes."""
    assert read(counts, monkeypatch) is None


def test_nothing_to_read_where_the_trace_dropped_spans(monkeypatch):
    counts = {"dp.dict-probe.bytes": MIB, "dp.dict-probe.hits": 10}
    assert read(counts, monkeypatch, dropped=3) is None


def test_nothing_to_read_from_a_trace_without_counters(monkeypatch):
    for name in ("spans", "counters", "dropped"):
        monkeypatch.delattr(trace, name)
    window = SimpleNamespace(request_bytes=[MIB], device_ops=[])
    assert core.load_module("metrics", METRIC).read(window) is None
