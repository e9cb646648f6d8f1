"""The traffic generators: deterministic per seed, exact sizes, and the
frozen corpus byte-identical to the port's corpus at the time it was
frozen."""

import collections
import hashlib
import re

import pytest

from benchmark import core

# tools/corpus.build_corpus() (16 MiB, seed 0) when benchmark/data was
# frozen from the port's C sources
BULK16M_SEED0_SHA256 = (
    "516dd5e4c1133f5d1cabd01ff50cbfe13eccce32653b3cf842509758184b6d85")

LINE = re.compile(
    rb'^\d+\.\d+\.\d+\.\d+ - (-|user\d+) \[\d\d/[A-Z][a-z]{2}/\d{4}:\d\d:\d\d:'
    rb'\d\d \+0000\] "(GET|POST|HEAD) /\S* HTTP/\d\.\d" \d{3} '
    rb'(-|\d+) "[^"]*" "[^"]*"$')
TRAFFIC = ["bulk16m", "logs16m"]


def _gen(traffic):
    """(generator module, its parameters but the document size and
    pool) of a traffic file."""
    t = core.load_json("traffic", traffic)
    params = {k: v for k, v in t["params"].items()
              if k not in ("doc_bytes", "pool")}
    return core.load_module("gen", t["gen"]), params


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_generator_is_deterministic_per_seed(traffic):
    mod, params = _gen(traffic)
    a = mod.documents(7, doc_bytes=200_000, pool=3, **params)
    b = mod.documents(7, doc_bytes=200_000, pool=3, **params)
    c = mod.documents(8, doc_bytes=200_000, pool=3, **params)
    assert a == b
    assert [len(d) for d in a] == [200_000] * 3
    assert len(set(a)) == 3 and not set(a) & set(c)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_generator_takes_large_seeds(traffic):
    mod, params = _gen(traffic)
    docs = mod.documents(2 ** 31 + 12345, doc_bytes=50_000, pool=2,
                         **params)
    assert [len(d) for d in docs] == [50_000, 50_000]


def test_bulk16m_seed0_is_the_frozen_corpus():
    traffic = core.load_json("traffic", "bulk16m")
    gen = core.load_module("gen", traffic["gen"])
    doc = gen.document(traffic["params"]["doc_bytes"], 0)
    assert hashlib.sha256(doc).hexdigest() == BULK16M_SEED0_SHA256


def test_smoke_corpus_matches_the_loop_it_vectorizes():
    """The vectorized join gives the word-by-word join's bytes."""
    import numpy as np
    gen = core.load_module("gen", "smoke_corpus")
    blob, offs, lens, nwords = gen._pieces()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, len(lens), 5000)
    want = b"".join(blob[o:o + n].tobytes()
                    for o, n in zip(offs[ids], lens[ids]))
    assert gen._gather(blob, offs, lens, ids).tobytes() == want
    assert nwords == 13504


def _log_lines(size=300_000, seed=11):
    gen, params = _gen("logs16m")
    doc = gen.document(size, seed, **params)
    return doc.split(b"\n")[:-1]  # the last line is cut


def test_access_log_lines_are_combined_format():
    lines = _log_lines()
    assert len(lines) > 500
    bad = [ln for ln in lines if not LINE.match(ln)]
    assert not bad, bad[:3]
    stamps = [ln.split(b"[")[1][:20] for ln in lines]
    import time
    secs = [time.mktime(time.strptime(s.decode(), "%d/%b/%Y:%H:%M:%S"))
            for s in stamps]
    assert secs == sorted(secs)


def test_access_log_keeps_the_cited_shares():
    """About 88% of requests succeed, and 10% of a document's clients
    make 75% or more of its requests (Arlitt and Williamson, 1997), in a
    document of the cell's size."""
    size = core.load_json("traffic", "logs16m")["params"]["doc_bytes"]
    lines = _log_lines(size, 2 ** 31 + 5)
    ok = sum(ln.split(b'"')[2].split()[0] == b"200" for ln in lines)
    assert abs(ok / len(lines) - 0.88) < 0.01
    per = collections.Counter(ln.split()[0] for ln in lines).most_common()
    top = sum(n for _, n in per[:len(per) // 10])
    assert top / len(lines) >= 0.75


def test_access_log_lines_hang_together_in_sessions():
    """A client keeps its agent; an embedded object refers to a page of
    the site that the same client asked for before it."""
    lines = _log_lines()
    agent, asked, embedded = {}, {}, 0
    for ln in lines:
        q = ln.split(b'"')
        ip, path, referer = ln.split()[0], q[1].split()[1], q[3]
        assert agent.setdefault(ip, q[5]) == q[5]
        if b"/static/" in path and referer.startswith(b"https://www.example"):
            embedded += 1
            assert referer.split(b".com", 1)[1] in asked.get(ip, ())
        asked.setdefault(ip, set()).add(path)
    assert embedded > len(lines) // 4
