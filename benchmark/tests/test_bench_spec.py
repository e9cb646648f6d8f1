"""BENCHMARK.json as the harness reads it: every name found as a file,
and the entries in the shape and limits the benchmark's contract sets."""

import json
import re

import pytest

from benchmark import core

SPEC = core.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert len(json.dumps(SPEC)) < 64 << 10


def test_every_metric_has_a_reader_found_by_name():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read), m


def test_every_cell_finds_its_config_traffic_and_generator():
    for w in SPEC["workloads"]:
        cell = core.cell(SPEC, w["name"])
        cfg, traffic = cell["config_file"], cell["traffic_file"]
        assert cfg["name"] == w["config"]
        assert set(cfg["guarantee"]) == {"format", "lossless", "window_bits"}
        assert cfg["kwargs"]["lgwin"] == cfg["guarantee"]["window_bits"]
        assert callable(core.load_module("gen", traffic["gen"]).documents)
        for shape in cfg.get("shapes", {}):
            assert callable(core.load_module("shapes", shape).segments)
        assert {"setup_s"} < {m["name"] for m in cell["end_to_end"]}
        assert cell["per_layer"]


def test_entries_keep_to_the_contract():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((core.ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    everything = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + \
        SPEC["per_layer"]
    for e in everything:
        assert NAME.match(e["name"]), e["name"]
        assert "unit" not in e or UNIT.match(e["unit"]), e["unit"]
        assert "better" not in e or e["better"] in ("lower", "higher")
        for k in ("why", "source"):
            assert k not in e or 1 <= len(e[k]) <= 200, (e["name"], k)
    names = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]
                                  if m["unit"] == "%"])
def test_shares_are_named_as_shares(name):
    assert name.endswith("_roofline") or name.endswith("_share")
