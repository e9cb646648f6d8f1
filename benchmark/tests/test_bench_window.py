"""The closed loop and the end-to-end arithmetic: the window ends with the
last request started inside it, and a stall inside it lowers the rate."""

import time
from types import SimpleNamespace

from benchmark import core, run


def _window(fn, seconds, clients=1):
    docs = [b"a" * 1000, b"b" * 3000]
    records, window_s = run.closed_loop(fn, {}, docs, seconds, clients,
                                        lambda: None)
    return SimpleNamespace(
        window_s=window_s,
        request_bytes=[len(docs[r[0]]) for r in records],
        output_bytes=[len(r[1] or b"") for r in records]), records


def _mbps(w):
    return core.load_module("metrics", "encode_MBps").read(w)


def test_window_ends_with_the_last_request_started_inside_it():
    w, records = _window(lambda d: (time.sleep(0.12), d[:10])[1], 0.3)
    assert len(records) == 3  # started at 0, 0.12, 0.24
    assert 0.36 <= w.window_s < 0.5
    assert [r[0] for r in records] == [0, 1, 0]
    assert abs(_mbps(w) - 5000 / w.window_s / 1e6) < 1e-12


def test_a_stall_inside_the_window_lowers_encode_MBps():
    calls = []

    def steady(d):
        time.sleep(0.02)
        return d[:10]

    def stalls(d):
        calls.append(1)
        time.sleep(0.25 if len(calls) == 3 else 0.02)
        return d[:10]

    w1, _ = _window(steady, 0.5)
    w2, _ = _window(stalls, 0.5)
    assert _mbps(w2) < 0.8 * _mbps(w1)


def test_ratio_is_all_input_over_all_output():
    w, _ = _window(lambda d: d[:100], 0.05)
    ratio = core.load_module("metrics", "ratio").read(w)
    assert ratio == sum(w.request_bytes) / (100 * len(w.request_bytes))


def test_clients_share_one_window():
    w, records = _window(lambda d: (time.sleep(0.05), d[:10])[1], 0.2,
                         clients=4)
    assert len(records) >= 12
    assert w.window_s < 0.35


def test_a_request_that_raises_is_recorded_not_fatal():
    def fails(d):
        raise ValueError("boom")
    _, records = _window(fails, 0.01)
    assert records and all(out is None and "boom" in err
                           for _, out, err, _ in records)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "brotli_tpu_torch_x", sys)
    assert "brotli_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_breakdown_names_gaps_by_what_the_host_did_most():
    dev = [("k1", 0.0, 1.0), ("k2", 5.0, 6.0), ("k1", 6.0, 6.5)]
    # dp.device spans the first gap; inside it the probe runs longest
    host = [("dp.device", 0.5, 5.5), ("dp.dict-probe", 1.5, 3.5),
            ("dp.seed", 3.5, 4.0)]
    b = run.breakdown(dev, host, (0.0, 7.0))
    assert b["device_ops"] == [["k1", 1.5], ["k2", 1.0]]
    assert b["idle_gaps"] == [["dp.dict-probe", 4.0], ["host", 0.5]]


def test_gaps_are_named_by_the_program_spans_of_every_thread():
    """The main thread waits in no stage while a pool thread serializes:
    the gap reads `serialize`; where only a request span is open it
    reads `host` (a request is no stage); open spans name nothing."""
    from benchmark import spans as S
    from brotli_tpu_torch.utils import trace

    def span(name, a, b, thread):
        return trace.Span(name, int(a * 1e9), None if b is None else
                          int(b * 1e9), thread, 1, None, None)

    program = [span("request", 0.0, 10.0, 1),
               span("match.dispatch", 0.0, 1.0, 1),
               span("serialize", 1.5, 4.5, 2),
               span("match.dict-post", 6.0, 7.5, 1),
               span("serialize", 9.0, None, 3)]
    dev = [("k", 0.5, 1.0), ("k", 5.0, 6.0), ("k", 8.0, 8.5)]
    b = run.breakdown(dev, S.stages(program), (0.0, 10.0))
    assert b["idle_gaps"] == [["serialize", 4.0], ["match.dict-post", 2.0],
                              ["host", 1.5], ["match.dispatch", 0.5]]
