"""Traffic whose documents carry a raw dictionary (RFC 9842's `dcb`), on
the CPU: the `versions` generator, a run of a cell built here on it at
q11 that passes each request its dictionary and is judged with it, the
faults that such a cell can have, and the cells without dictionaries
calling their entry with the configuration's arguments alone."""

import pytest

from benchmark import check, core, faults, run

# 2**31 + 7 is 0 mod 3: the pool starts with the jQuery pair, the
# smallest, so a short window's one request is the quickest to encode
SEED = 2 ** 31 + 7


def _versions(seed):
    t = core.load_json("traffic", "versions")
    gen = core.load_module("gen", t["gen"])
    return (gen.documents(seed, **t["params"]),
            gen.dictionaries(seed, **t["params"]))


def _adhoc_cell(config="q11_w22", traffic="versions"):
    """A cell of `config` on `traffic` that BENCHMARK.json does not
    hold, assembled as the harness assembles a cell it names."""
    bench = core.spec()
    name = f"{config}.{traffic}"
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test's own cell"})
    cell = core.cell(bench, name)
    cell["config_file"]["warmup_bytes"] = 70_000
    return cell


def _run(cell, fault=None, seconds=0.01, seed=SEED):
    return run.run(cell, seed, seconds, False, fault=fault, device="cpu")


def test_versions_is_deterministic_and_the_seed_only_rotates_it():
    docs, dicts = _versions(5)
    assert (docs, dicts) == _versions(5)
    # 5 mod 3 = 2: the pool starts with the third pair
    assert [len(d) for d in docs] == [2_844_468, 288_580, 572_373]
    assert [len(d) for d in dicts] == [3_459_653, 287_630, 556_073]
    for seed in (0, 1, 2 ** 31 + 12345):
        d2, k2 = _versions(seed)
        assert sorted(map(len, d2)) == sorted(map(len, docs))
        assert sorted(k2) == sorted(dicts)
        i = d2.index(docs[0])
        assert k2[i] == dicts[0]  # a document keeps its dictionary
    assert _versions(SEED)[0][0][:60].startswith(b"/*!\n * jQuery")


def test_a_q11_run_on_versions_is_correct_with_every_dictionary():
    """Three runs whose pools start with each pair in turn: every
    document, with its own dictionary, decodes to itself."""
    for seed in (SEED, SEED + 1, SEED + 2):
        r = _run(_adhoc_cell(), seed=seed)
        assert r["correct"], r["checks"]
        assert r["checks"] == {"wrong_streams": {"value": 0, "limit": 0},
                               "wrong_window": {"value": 0, "limit": 0}}
        assert r["attempted"] >= 1
        # a stream against the release before it is far smaller than
        # the 4 to 6 that q11 reaches without a dictionary
        assert r["metrics"]["ratio"]["value"] > 10


@pytest.mark.parametrize("fault,check_name", [
    ("identity", "wrong_streams"),  # a step returns its input unchanged
    ("half", "wrong_streams"),      # half of the request left out
    ("lossy", "wrong_streams"),     # a byte altered where it is produced
    ("window", "wrong_window"),     # another window declared
    ("swapdict", "wrong_streams"),  # another document's dictionary
])
def test_each_fault_flags_every_request_on_versions(fault, check_name):
    r = _run(_adhoc_cell(), fault=fault)
    assert not r["correct"]
    assert r["attempted"] >= 1
    assert r["checks"][check_name]["value"] == r["attempted"]


def test_a_check_without_the_dictionary_flags_a_sound_stream():
    from brotli_tpu_torch import compress
    docs, dicts = _versions(SEED)
    stream = compress(docs[0], quality=11, lgwin=22, dictionary=dicts[0],
                      device="cpu")
    assert check.judge(docs[0], stream, 22, dicts[0]) == (True, True)
    assert check.judge(docs[0], stream, 22) == (True, False)
    got = check.compare(docs, [(0, stream)], 22, workers=1)
    assert got["wrong_streams"] == 1
    got = check.compare(docs, [(0, stream)], 22, dicts, workers=1)
    assert got["wrong_streams"] == 0


def test_identical_streams_share_a_decode_by_document_and_dictionary(
        monkeypatch):
    """Two requests of one document, one stream and one dictionary are
    judged once; another dictionary for the same stream is judged again."""
    calls = []

    class Pool:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def submit(self, fn, *args):
            calls.append(args)
            out = fn(*args)
            return type("Done", (), {"result": lambda self: out})()

    monkeypatch.setattr(check.cf, "ProcessPoolExecutor", Pool)
    docs = [b"a" * 100, b"a" * 100]
    from brotli_tpu_torch import native
    stream = native.encode(docs[0], 5, 22)
    check.compare(docs, [(0, stream), (0, stream)], 22, [b"x", b"y"])
    assert len(calls) == 1
    calls.clear()
    check.compare(docs, [(0, stream), (1, stream)], 22, [b"x", b"y"])
    assert len(calls) == 2


def test_swapdict_refuses_traffic_without_dictionaries():
    with pytest.raises(ValueError, match="no dictionary keyword"):
        faults.plant("swapdict", lambda data, **kw: data)
    cell = core.cell(core.spec(), "q5_w22.logs16m")
    cell["traffic_file"]["params"]["doc_bytes"] = 10_000
    with pytest.raises(ValueError, match="swapdict"):
        _run(cell, fault="swapdict")


@pytest.mark.parametrize("workload", ["q11_w22.bulk16m", "q5_w22.logs16m"])
def test_cells_without_dictionaries_pass_exactly_their_kwargs(
        monkeypatch, workload):
    """A recording entry in place of the program: the warm-up and every
    request of the window get the configuration's kwargs (and the
    tests' device) and nothing else."""
    from brotli_tpu_torch import native
    seen = []

    def entry(data, **kw):
        seen.append(kw)
        return native.encode(data, 1, kw["lgwin"])

    monkeypatch.setattr(run, "entry_point", lambda config: entry)
    cell = core.cell(core.spec(), workload)
    cell["traffic_file"]["params"]["doc_bytes"] = 100_000
    r = _run(cell, seconds=0.05)
    assert r["correct"] and len(seen) == r["attempted"] + 1
    want = {**cell["config_file"]["kwargs"], "device": "cpu"}
    assert all(kw == want for kw in seen)


def test_each_request_of_a_dictionary_traffic_gets_its_own(monkeypatch):
    from brotli_tpu_torch import native
    seen = []

    def entry(data, dictionary=None, **kw):
        seen.append((data, dictionary, kw))
        return native.encode_with_dict(data, 1, kw["lgwin"], dictionary)

    monkeypatch.setattr(run, "entry_point", lambda config: entry)
    cell = _adhoc_cell()
    r = _run(cell, seconds=0.3)
    docs, dicts = _versions(SEED)
    assert r["correct"] and r["attempted"] >= 3
    warm, *window = seen
    assert warm[0] == docs[0][:70_000] and warm[1] is not None
    assert warm[1] == dicts[0]
    for k, (data, dictionary, kw) in enumerate(window):
        assert data == docs[k % 3] and dictionary == dicts[k % 3]
        assert kw == {**cell["config_file"]["kwargs"], "device": "cpu"}
