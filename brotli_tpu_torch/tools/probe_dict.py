"""K12 (csrc/dict_probe.cu) on the card against native.dict_probe_all.

On the benchmark cells' documents and on an input that overflows the
probe's cap, it holds `ops.optimal._dict_probe_global` with the input on
the card (K12) bit for bit against `native.dict_probe_all`, the host
probe K12 replaces (the port's copy of `btpu_dict_probe_all`, which
tests/test_torch_dict_probe.py holds to the JAX package's copy on the
CPU, as the JAX package does not run on the card), and times both:
  - the four 16 MiB documents of `q11_w22.bulk16m` at --seed, each
    probed as find_matches_optimal probes it: its first SEG_V3 bytes
    after their own seed parse, then the whole document;
  - the three `versions` pairs of `q11_w22_dcb.versions`, each document
    after its dictionary (base the dictionary's size, the window past
    it, the seed parse with the dictionary as history);
  - one 16 MiB `logs16m` document;
  - dictionary words with no seed, which overflow the cap: no hits.
For each it prints the hits, K12's time alone on the card (the median of
5 runs of 10 launches queued behind a spin kernel), the whole probe on
the host clock (gates, their upload, the launch and the fetch; median of
5) and the native probe's (median of 3). With --streams it also
compresses each bulk16m and versions document at q11 twice, with K12 and
with the native probe in its place, checks that the streams are equal
and decode, and counts K12's launches in each request. Ptxas's report of
K12 (registers, shared memory, spills) comes first.

Usage, from the repository root on a machine with a card:
    python3 -m brotli_tpu_torch.tools.probe_dict [--seed N] [--streams]
"""

import argparse
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import api, native
from ..format import constants as C
from ..format.dictionary import (OFFSETS_BY_LENGTH, SIZE_BITS_BY_LENGTH,
                                 dictionary_data)
from ..ops import kernels, optimal as O
from .probe_k78 import _device_ms

MAXD = C.max_backward_distance(22)


def _ptxas() -> str:
    out = kernels._BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    p = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / "libdict_probe_v.so"),
         str(kernels._CSRC / "dict_probe.cu")],
        capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    return "; ".join(line.split(":", 1)[-1].strip()
                     for line in (p.stdout + p.stderr).splitlines()
                     if re.search(r"registers|spill|Compiling entry", line))


def _host_ms(fn, runs):
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _native(arr, seed, base, maxd):
    try:
        return native.dict_probe_all(arr.tobytes(), seed[0], seed[1], base,
                                     maxd)
    except ValueError:
        return None


def check(label, arr, seed, base, maxd, buf):
    """K12 through _dict_probe_global against native.dict_probe_all on
    arr (on the card in `buf`); exits on a difference. Returns the
    line's numbers."""
    want = _native(arr, seed, base, maxd)
    got = O._dict_probe_global(arr, [seed], base, maxd, buf)
    if want is None:
        equal = len(got[0]) == 0
    else:
        equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in zip(want, got[:2]))
    gates = torch.from_numpy(native.probe_gates(seed[0], seed[1]).view(
        np.int32)).to(buf.device)
    image = O.dict_image(buf.device)
    k12 = _device_ms(lambda: kernels.dict_probe(buf, len(arr), gates, base,
                                                maxd, image))
    whole = _host_ms(lambda: O._dict_probe_global(arr, [seed], base, maxd,
                                                  buf), 5)
    host = _host_ms(lambda: _native(arr, seed, base, maxd), 3)
    row = dict(case=label, n=len(arr), hits=len(got[0]),
               overflow=want is None, equal=equal, k12_ms=round(k12, 4),
               probe_ms=round(whole, 3), native_ms=round(host, 1))
    print(json.dumps(row), flush=True)
    if not equal:
        raise SystemExit(f"probe_dict: K12 differs from native on {label}")
    return row


def streams(label, doc, dictionary=None):
    """q11 with K12 and with the native probe in its place: the streams
    must be equal and decode. Returns K12's launches in the request."""
    kw = dict(quality=11, lgwin=22)
    if dictionary is not None:
        kw.update(dictionary=dictionary, encoder="device")
    kernels.reset_launches()
    t = time.perf_counter()
    card = api.compress(doc, **kw)
    t_card = time.perf_counter() - t
    launches = kernels.LAUNCHES["dict_probe"]
    orig = O._dict_probe_global
    O._dict_probe_global = lambda arr, s, b, m, buf=None: orig(arr, s, b, m)
    try:
        t = time.perf_counter()
        host = api.compress(doc, **kw)
        t_host = time.perf_counter() - t
    finally:
        O._dict_probe_global = orig
    back = native.decode(card, compound=dictionary or b"")
    row = dict(case=label, bytes=len(card), equal=card == host,
               decodes=back == doc, k12_launches=launches,
               k12_s=round(t_card, 3), native_probe_s=round(t_host, 3))
    print(json.dumps(row), flush=True)
    if card != host or back != doc:
        raise SystemExit(f"probe_dict: the {label} streams differ or do "
                         f"not decode")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", action="store_true")
    args = ap.parse_args(argv)
    from benchmark import core
    from benchmark.run import card_line
    print(f"K12 {_ptxas()}", flush=True)
    kernels.build()
    print(card_line(), flush=True)
    dev = torch.device("cuda")

    bulk = core.load_json("traffic", "bulk16m")["params"]
    docs = core.load_module("gen", "smoke_corpus").documents(args.seed,
                                                             **bulk)
    for i, doc in enumerate(docs):
        arr = np.frombuffer(doc, np.uint8)
        buf = O.upload_input(arr, len(arr), dev)
        seed1 = O._seed_parse(arr[:O.SEG_V3], MAXD, 0)
        check(f"bulk16m[{i}] first segment", arr[:O.SEG_V3], seed1, 0, MAXD,
              buf)
        check(f"bulk16m[{i}]", arr, O._seed_parse(arr, MAXD, 0), 0, MAXD,
              buf)

    ver = core.load_json("traffic", "versions")["params"]
    gen = core.load_module("gen", "versions")
    pairs = list(zip(gen.documents(args.seed, **ver),
                     gen.dictionaries(args.seed, **ver)))
    for doc, dic in pairs:
        arr = np.frombuffer(doc, np.uint8)
        hist = O.RawDictionary(np.frombuffer(dic + doc, np.uint8), len(dic))
        seed = O._seed_parse_dcb(hist, MAXD, O.DPConfig.seed_q)
        head = O._dict_head(len(arr), hist)
        buf = O.upload_input(arr, len(arr), dev,
                             hist.data[hist.size - head:hist.size])
        check(f"versions {len(dic)} -> {len(doc)}", arr, seed, len(dic),
              MAXD + len(dic), buf[head:])

    logs = core.load_json("traffic", "logs16m")["params"]
    doc = core.load_module("gen", "access_log").documents(args.seed,
                                                          **logs)[0]
    arr = np.frombuffer(doc, np.uint8)
    check("logs16m[0]", arr, O._seed_parse(arr, MAXD, 0), 0, MAXD,
          O.upload_input(arr, len(arr), dev))

    rng = np.random.default_rng(args.seed)
    blob = dictionary_data()
    words = []
    for L in rng.integers(4, 25, 400_000):
        i = int(rng.integers(0, 1 << SIZE_BITS_BY_LENGTH[L]))
        words.append(blob[OFFSETS_BY_LENGTH[L] + i * int(L):][:int(L)])
    arr = np.frombuffer(b" ".join(words), np.uint8)
    z = np.zeros(0, np.int64)
    row = check("dictionary-dense", arr, (z, z), 0, MAXD,
                O.upload_input(arr, len(arr), dev))
    if not row["overflow"]:
        raise SystemExit("probe_dict: the dense input did not overflow")

    if args.streams:
        for i, doc in enumerate(docs):
            streams(f"bulk16m[{i}]", doc)
        for doc, dic in pairs:
            streams(f"versions {len(dic)} -> {len(doc)}", doc, dic)
    print("probe_dict: ok", flush=True)


if __name__ == "__main__":
    main()
