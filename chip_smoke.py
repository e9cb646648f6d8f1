"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases (any failure ends the run with a non-zero exit and no result):
  1. report the card (nvidia-smi name and power limit);
  2. build the port's native library and its CUDA kernels from the
     sources in this checkout;
  3. hold each kernel bit for bit against its plain PyTorch version on
     the card and time both (median of CUDA-event timed runs): K9, K10
     and K11 (the candidate edges and slot tables) on the first 4 MiB DP
     segment's real inputs (every level, the 16-byte one too) and on
     seeded cases (a tail-padded segment, npos 0 and n, all-zero bytes,
     the small window, K10 with a raw dictionary's tail in the bucket
     (base -1 and -2 MiB, the second at the small window), K9 and K10
     with a halo (the 16 MiB corpus as one segment's candidate rows,
     the first 12 MiB history, lgwin 24's window: the q11_w24 cell's
     shape; K10's halo launch timed, row K10h), duplicate
     seed starts and dictionary hits, random candidate words, the v1
     layout), then the card's operations of one
     dp_v3_segment call with the plain edges and with K9-K11 (at most
     100); K12 (the dictionary probe, through the DP's probe with the
     input on the card) against native.dict_probe_all on the first
     SEG_V3 bytes and on the whole 16 MiB, timed on the whole; K1, K3
     and K4 on the real inputs of that segment,
     K1 and K4 also on seeded inputs at the same shapes (K4 also with
     a part-full last CTA and with rows off the 16-byte grid), K2 on the
     real skip vector of the q5 matcher's second 8 MiB segment (once,
     then 100 times in a row, every result the same) and on seeded
     vectors (all 1, all 16, uniform, alternating 16/1; from 0, a chunk
     boundary, a sub-chunk's last offset, n - 1 and n; two at 1 Mi, one
     off the 16-byte grid);
  4. the q11 path: compress the 16 MiB corpus at q11 on the card three
     times: a first run, a timed run (stage trace off; kernel launches
     and peak device memory counted; decoded back exactly) and a traced
     run for the stage breakdown, all with the same bytes; K9 and K10
     twice and K11, K1, K3, K4 once a segment; dp.dispatch of the
     traced run; then lgwin 24 on the q11_w24 cell's shape (the corpus
     and its first 16 KiB again, 16,793,600 B: five segments, the four
     after the first with a halo), a first run and a counted run with
     the same bytes, decoded back: K9 and K10 launched over a halo
     twice a later segment (their launches are row K10h's), dp.halo_bytes
     4 + 8 + 12 + 12 MiB;
  5. the same q11 bytes from the kernels and from the plain versions on
     the CPU, for a 512 KiB prefix;
  6. the q5 path: parallel.shard.compress_sharded(corpus, quality=5),
     the device matcher with K2, run three times as in phase 4;
  7. the same q5 bytes on the card and on the CPU, for a 1 MiB prefix;
  8. q11 with two shards on the card (8 MiB): the second shard's seed
     parse runs the device matcher, so all four kernels launch;
  9. the device serializer: compress_sharded(corpus, quality=5,
     serializer="device") three times as in phase 4 (K6 once per 4 MiB
     metablock, no shard left to the native serializer), K6 against its
     plain version on the real fields of the first metablock (and timed
     there), the plan's device launches, the same bytes on the card and
     on the CPU for a 1 MiB prefix, and q11 with two shards (8 MiB);
 10. the device decoder: decompress(..., decoder="device") of the q11 and
     q5 streams of phases 4 and 6 against the native decoder (K5 once a
     stream), the parse and resolve split, and K5 against its plain
     version on the real parse of the q11 stream (and timed there);
 11. the public surface (api, cli): compress at q1, q5 and q9 on the
     native route (no kernel launched), q11 on a 4 MiB prefix through
     the card (K1, K3, K4 once each) and through encoder="native" side
     by side, Compressor/Decompressor in 1 MiB pieces with
     back-pressure, decompress_concatenated of phases 4 and 6's
     streams, a raw dictionary, a large window, and the CLI at q11 in a
     subprocess (the card's bytes) and back with -d;
 12. the DP variants (ops/optimal.DPConfig): K7 (the v1 wavefront)
     against its plain version on the real first 2 MiB v1 segment (28
     and 38 slots) and on seeded cases (equal sums at different
     distances, empty slots, length stubs, costs at and above 1 << 28
     on live slots, edges to the block end, sums that cross 2**31 mid
     block, a few slots near 2**31 on scattered steps; 28 and 38
     slots), with its count of steps that ran the exact slot loop (0 on
     the real segment, above 0 where sums may wrap), K8 (the path-ring
     scan) on the real first 4 MiB v3 segment with the implicit-cell
     row off and on and on seeded rings (into the previous block, to
     the segment start and beyond it, npos cut mid block, wrapped words
     at the segment end, long literal runs, edges on 30% of the
     columns, rows at column 1), with its count of steps compared on
     the chain (0 on the real segment), K1 at the 39 slots of
     the 16-byte level; compress(dp=v1) on the 16 MiB corpus three
     times as in phase 4 (K7 and K4 once a 2 MiB segment, K1 and K3
     never) and dp=ring_scan once (K8 once a 4 MiB segment, K3 never);
     the same bytes on the card and the CPU for 512 KiB (v1, ring_scan,
     ring_scan + icell); level3, iterations=2, fast_first=False and one
     value of each cost knob on a 6 MiB prefix; v1 with two shards;
 13. several devices and processes, on the one card: q5 on the mesh
     (parallel.shard's mesh route through its internal function, 8
     shards over [cuda:0] * 8, each with its halo; K2 once a shard; the
     matches that reach before their shard) beside the one-card route
     with 8 shards, the card's bytes against the CPU's on a 1 MiB
     prefix; q11 on the mesh (ops.optimal.find_matches_optimal_sharded,
     4 shards over [cuda:0] * 4, default DP and ring scan; K1, K3 or K8
     and K4 once a real segment of a shard (a shard out of segments
     runs none), K2 once a shard after the first; peak
     device memory), the card's bytes against the CPU's on 256 KiB;
     gather="collective" (phase 6's bytes); compress_sharded_mp in 4
     processes on the card through tools/mp_compress (gloo, a file://
     store), every rank's stream equal to the single-process mesh over
     [cuda:0] * 4;
 14. the Python serializer and decoder on the card: compress(corpus,
     quality=5, encoder="device") on the 16 MiB corpus, timed and
     traced (K2 once per matcher segment, 4, and no other kernel; the
     match.* and serialize stages), decoded natively, the card's bytes
     against the CPU's on a 1 MiB prefix; compress(4 MiB, quality=11,
     mode=1, encoder="device") (K1, K3 and K4 once each), decoded, the
     card against the CPU on 512 KiB; compress_sharded(corpus,
     quality=5, serializer="python") (K2's launches; its size beside
     phase 6's native-serializer stream), decoded natively; the Python
     decoder on a 1 MiB q5 stream of that route through decompress
     (decoder="python") and through Decompressor(decoder="python") fed
     64 KiB pieces under a 64 KiB output limit; the deferred parse
     (Decoder.defer_lz) of phase 11's 4 MiB q11 stream, its literals
     and copies equal to native.parse_stream's, resolved by K5 on the
     card to the stream's bytes and K5 held bitwise against its plain
     version on it; the phase's wall;
 15. the host pipeline's routes on the card, each with its
     exact launches, its wall and its stream decoded: Compressor(q11,
     mode=1) on 4 MiB in flushed 1 MiB pieces (K1, K3, K4 once a flush,
     every flushed prefix decoding on its own; cuda = cpu on 512 KiB in
     256 KiB pieces); StreamingEncoder(q5, mode=2) the same (K2 once a
     flush; cuda = cpu on 1 MiB); compress(q5, encoder="device") with a
     64 KiB raw dictionary, in base64 mode on a page of inline images,
     and with a serialized dictionary of a prefix and custom words drawn
     by tools/dictgen (K2 once each; the last decoded by the Python
     decoder); and with backend="numpy" encoder="python" at q11 on
     256 KiB (the host DP), at q5 on 1 MiB and compress_sharded(q5,
     use_device=False) on 1 MiB, no kernel launched;
 16. the last slice: tools/stress on the card (STRESS_TRIALS seeded
     trials, every encoder route in turn -- native, python, the
     Compressor, a raw dictionary, q10/q11 on the card with each DP
     variant, encoder="device", the Compressor at q10/q11 in modes 1-2,
     a serialized dictionary, base64 mode, compress_sharded with each
     serializer -- and every decoder on each stream; zero failures, and
     K1-K11 each launched at least once, per route as printed); the
     dissector and parse replay over the native q5 and q11 streams of
     1 MiB of the corpus (dissect's summary lines; each replay decoded,
     its size beside the stream's); entry.entry() on the card against
     the CPU ((count, packed) equal; K2 once); entry.dryrun_multichip(8)
     over [cuda:0] * 8 (K2 once a block, once a q5 shard and once a q11
     shard after the first; K1, K3, K4 once a 64 KiB DP segment), its
     numbers and streams equal to the same call on the CPU (run in a
     process of its own from the phase's start, beside the card's
     work); the phase's wall;
 17. print the kernels line (launches on each kernel's path, errors,
     times and bounds), the card again, and the final JSON line.

Phase 3 also holds K5 on seeded command lists at 16 Mi outputs (all
literals; one literal then a 16 Mi - 1 byte copy at distance 1, in full
and cut to 0, 1, 12 and 23 rounds; random commands; copies 20,000 to
30,000 back, whose chains cross hundreds of K5's tiles), printing the
positions its tile collapse leaves and the hops of its global jumps,
and K6 on seeded fields at the 4 MiB metablock's 9,437,224 fields
(every marker kind; every field 24 raw bits, which overflows the words;
the words cut to end 60% into the payload, mid-tile; one field of 40
bits), printing the tiles that took its slow path. Phases 9 and 10
print the same on the real metablock and on both streams' parses, and
the card's time for each launch of one K6 and one K5 call.

Run from the repository root: python3 chip_smoke.py
"""

import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# phase 16's stress: seed and trials (every route twice; see
# brotli_tpu_torch/tools/stress.py)
STRESS_SEED = 2026
STRESS_TRIALS = 28
# phase 16's dry run on the CPU, in a process of its own beside the
# stress (~50 s of plain versions; four threads, so the stress keeps
# cores): its numbers and streams into argv[1]
DRYRUN_CPU = """
import json, pathlib, sys, torch
from brotli_tpu_torch import entry
torch.set_num_threads(4)
r = entry.dryrun_multichip(8, "cpu")
d = pathlib.Path(sys.argv[1])
(d / "q5").write_bytes(r["q5"])
(d / "q11").write_bytes(r["q11"])
(d / "numbers.json").write_text(json.dumps([r["matches"], r["hist_total"]]))
"""

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the non-tensor
# 32-bit rate, which int32 compare/select work cannot exceed
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12
# latency of one shared-memory load on Hopper, in SM cycles (published
# microbenchmarks put it near 30): each dependent step of K2's walks
# waits on one
SMEM_LOAD_CYCLES = 30
# ~1 ms at the H100's SM clock: longer than any wrapper's launch gap
SPIN_CYCLES = 2_000_000


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card_line() -> str:
    return smi("name,power.limit")


def cuda_ms(fn, reps, queued=False):
    """Median ms of `reps` runs of fn, each between CUDA events, after
    one warm-up run. One call at a time (the kernels line's `ms`), the
    time holds the host's launch gap (the wrapper's Python) after the
    first event. Queued (its `device_ms`), each run waits behind a ~1 ms
    spin kernel, so the host has enqueued its launches before the first
    event fires and the events time the card's work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def launch_split(fn, reps=5):
    """Median device microseconds of each kernel and copy that one call
    of fn launches (torch.profiler over `reps` calls, after a warm-up),
    as "name us" strings in launch order."""
    from brotli_tpu_torch.utils.trace import device_profile
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(reps):
            fn()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            us.setdefault(name.split("(")[0][:48], []).append(
                e.time_range.elapsed_us())
    return [f"{k} {statistics.median(v):.1f} us"
            + (f" x{len(v) // reps}" if len(v) > reps else "")
            for k, v in us.items()]


def k1_case(nslots, n, seed):
    """Seeded K1 slots at the main path's width, as in
    tests/test_torch_kernels.py: costs from a handful of values (ties
    across slots, values at and above 1 << 28, a negative one), lengths
    over -64..63 (pd with bit 31 set), dictionary lengths 0..127 (64 and
    above wrap), live distances on dead slots."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(-64, 64, (nslots, n), dtype=np.int32)
    ls[nslots - 2] = rng.integers(0, 128, n, dtype=np.int32)
    ds = rng.integers(0, 1 << 25, (nslots, n), dtype=np.int32)
    vals = np.array([-7, 0, 5, 5, 9, (1 << 28) - 1, 1 << 28, (1 << 28) + 1,
                     (1 << 31) - 1], np.int32)
    cs = vals[rng.integers(0, len(vals), (nslots, n), dtype=np.int32)]
    pd = (ls.astype(np.uint32) << 25) | ds.astype(np.uint32)
    copyq = rng.integers(0, 300, 64, dtype=np.int32)
    copyq[:2] = 1 << 28
    return pd.view(np.int32), cs, copyq


def k4_case(fill, nb, B, seed):
    """Seeded K4 payload rows: "ones" (lengths 0 or 1: the walk of B
    positions), "random" (lengths over -64..63: steps that overrun the
    block start into negative positions) or "63" (every length 63)."""
    rng = np.random.default_rng(seed)
    shape = (nb, B + 1)
    if fill == "ones":
        ln = rng.integers(0, 2, shape, dtype=np.int32)
    elif fill == "random":
        ln = rng.integers(-64, 64, shape, dtype=np.int32)
    else:
        ln = np.full(shape, 63, np.int32)
    pay = (ln.astype(np.uint32) << 25) | rng.integers(
        0, 1 << 25, shape, dtype=np.int32).astype(np.uint32)
    return pay.view(np.int32)


def k5_cases(n, seed):
    """Seeded K5 command lists at n outputs: (label, lits, (nlit, ncopy,
    dist), n_steps), n_steps the full ceil(log2 n) but for the "rle"
    cuts (0, 1, full / 2 and full - 1 rounds: K5 resolves with exact
    depths, so every cut must give the doubling's bytes)."""
    rng = np.random.default_rng(seed)
    full = (n - 1).bit_length()
    lits = rng.integers(0, 256, n, dtype=np.uint8)

    def cmds(*cols):
        return tuple(np.array(c, np.int32) for c in cols)

    rle = cmds([1], [n - 1], [1])
    cases = [("literals", lits, cmds([n], [0], [0]), full),
             ("rle", lits[:1], rle, full)]
    cases += [(f"rle cut {k}", lits[:1], rle, k)
              for k in (0, 1, full // 2, full - 1)]

    def commands(nl, nc, dist_of):
        """Cut the commands to n outputs; the distances from
        dist_of(first copy position of each command)."""
        ends = np.cumsum(nl + nc)
        k = int(np.searchsorted(ends, n)) + 1
        nl, nc = nl[:k].copy(), nc[:k].copy()
        rest = n - (int(ends[k - 2]) if k > 1 else 0)
        nl[-1] = min(nl[-1], rest)
        nc[-1] = rest - nl[-1]
        dist = dist_of(np.cumsum(nl + nc) - nc)
        return lits[:int(nl.sum())], cmds(nl, nc, dist)

    # random commands: inserts of 0..11, copies of 0 or 2..39 bytes,
    # half the distances 1..4 (overlapping chains), half anywhere back
    k = n // 16
    nl = rng.integers(0, 12, k)
    nl[0] = max(nl[0], 1)
    nc = rng.integers(0, 40, k)
    nc[nc == 1] = 2
    cases.append(("random", *commands(nl, nc, lambda fc: np.where(
        rng.random(len(fc)) < 0.5, np.minimum(rng.integers(1, 5, len(fc)),
                                              fc),
        rng.integers(1, fc + 1))), full))
    # chains across hundreds of tiles: one literal, then 30 to 60 bytes
    # copied from 20,000 to 30,000 back (K5's tile is 8,192)
    k = n // 30
    nl = np.ones(k, np.int64)
    nl[0] = 30_000
    nc = rng.integers(30, 61, k)
    cases.append(("cross tiles", *commands(nl, nc, lambda fc: np.minimum(
        rng.integers(20_000, 30_001, len(fc)), fc)), full))
    return cases


def k6_case(nfields, seed, kind="seeded"):
    """Seeded K6 fields and code tables: (vals, markers, tables, bit0).
    Six in ten fields raw with 0 bits (the plan's empty slots), one raw
    with 1..24 bits, 1.5 literals, one command and half a distance
    symbol; tables of random codes and lengths 0..15. Kinds: "overflow",
    every field 24 raw bits, past the words' end from the first tile
    on; "wide", one raw field of 40 bits in the middle (its tile takes
    the slow path)."""
    rng = np.random.default_rng(seed)
    kind_of = rng.choice(5, nfields, p=[0.6, 0.1, 0.15, 0.1, 0.05])
    vals = rng.integers(-2 ** 31, 2 ** 31, nfields).astype(np.int32)
    mk = np.zeros(nfields, np.int32)
    for kd, marker, lo, hi in ((1, None, 0, 0), (2, -2, 0, 256),
                               (3, -1, 0, 704), (4, -1, 4096, 4160)):
        sel = kind_of == kd
        if marker is None:
            mk[sel] = rng.integers(1, 25, int(sel.sum()))
        else:
            mk[sel] = marker
            vals[sel] = rng.integers(lo, hi, int(sel.sum()))
    if kind == "overflow":
        mk[:] = 24
    elif kind == "wide":
        mk[nfields // 2 + 1234] = 40
    tables = []
    for size in (256, 704, 64):
        tables += [rng.integers(0, 1 << 15, size).astype(np.int32),
                   rng.integers(0, 16, size).astype(np.int32)]
    # table order: lit code, lit len, cmd code, cmd len, dist code, len
    return vals, mk, tables, int(rng.integers(0, 8))


def v1_case(kind, nslots, nb, seed, B=4096, W=64):
    """Seeded K7 inputs (pd, cs, litq, copyq) over nb DP blocks, as in
    tests/test_torch_dp_variants.py: "ties" (costs from three values and
    distances from eight, so equal sums at different distances abound;
    lengths over -64..63: stubs below 2 and negative pd), "empty" (every
    length 0), "stubs" (lengths -3..1 at cheap costs), "expensive"
    (costs at and above 1 << 28 on live slots, and near 2**31 so sums
    wrap), "block end" (every slot 63 long, cut at each block's end),
    "cost wrap" (literal costs near 2**20 and slot costs near 1.5 *
    2**30: once cost_i passes 2**29 the slots' sums cross 2**31 and
    wrap, inside a block), "mixed" (the ties case, with one slot in 200
    at a cost near 2**31 on scattered steps)."""
    rng = np.random.default_rng(seed)
    n = nb * B
    ls = rng.integers(-64, 64, (nslots, n)).astype(np.int64)
    ds = rng.integers(1, 9, (nslots, n)) * 1000 + rng.integers(0, 2, (
        nslots, n))
    cs = rng.choice([300, 301, 420], (nslots, n))
    if kind == "empty":
        ls[:] = 0
    elif kind == "stubs":
        ls = rng.integers(-3, 2, (nslots, n))
    elif kind == "expensive":
        ls = rng.integers(2, 64, (nslots, n))
        cs = rng.choice([1 << 28, (1 << 28) + 7, (1 << 31) - 5, 500],
                        (nslots, n))
    elif kind == "block end":
        ls[:] = 63
    elif kind == "cost wrap":
        cs = rng.choice([3 << 29, (3 << 29) + 1, (3 << 29) + 300],
                        (nslots, n))
    elif kind == "mixed":
        rare = rng.random((nslots, n)) < 0.005
        cs = np.where(rare, (1 << 31) - rng.integers(1, 400, (nslots, n)),
                      cs)
    ls = np.minimum(ls, B - np.arange(n) % B)
    pd = ((ls << 25) | ds) & 0xFFFFFFFF
    litq = rng.integers(20, 200, n).astype(np.int32)
    if kind == "cost wrap":
        litq = rng.integers((1 << 20) - 500, (1 << 20) + 500, n).astype(
            np.int32)
    copyq = rng.integers(0, 300, W).astype(np.int32)
    copyq[:2] = 1 << 28
    return (pd.astype(np.uint32).view(np.int32), cs.astype(np.int32), litq,
            copyq)


def ring_case(kind, nb, seed, B=4096, W=64):
    """Seeded K8 inputs over nb DP blocks, as in
    tests/test_torch_dp_variants.py: (mp, litq, data, ring_init,
    ring_cost, copyq, icell, npos). Bytes repeat with a period of 2,000
    plus 1% noise; K1's rows offer sparse edges at distances of the
    period, into the previous block and beyond the segment start.
    Kinds: "prev block" (entry rings 4,100..8,000), "to start" (block b
    enters with ring b * B + k, k in -1, 0, 1: src before, at and after
    the segment start), "npos cut" (npos ends half way into the last
    block), "wrap" (the last block repeats the segment's head, so the
    lanes at the end compare wrapped words), "literal run" (edges at
    0.1%: rings inherited across long literal runs), "ring churn" (edges
    at 30%: R set at column 2 on most steps), "column 1" (rows reach
    column 1 below the literal's cost: rings from a row's payload there,
    which K8's look-ahead does not cover)."""
    rng = np.random.default_rng(seed)
    n = nb * B
    period = rng.integers(0, 256, 2000, dtype=np.uint8)
    data = np.resize(period, n)
    noise = rng.random(n) < 0.01
    data[noise] = rng.integers(0, 256, int(noise.sum()))
    if kind == "wrap":
        data[-B:] = data[:B]
    m = np.full((n, W), 1 << 29, np.int32)
    py = np.zeros((n, W), np.int32)
    share = {"literal run": 0.001, "ring churn": 0.3}.get(kind, 0.02)
    live = rng.random((n, W)) < share
    live[:, 0] = False
    if kind != "column 1":
        live[:, 1] = False
    m[live] = rng.integers(200, 900, int(live.sum()))
    if kind == "column 1":
        m[live[:, 1], 1] = rng.integers(10, 40, int(live[:, 1].sum()))
    dist = rng.choice([2000, 4000, 4100, 6000, 9000], (n, W))
    py[live] = ((np.arange(W)[None, :] << 25) | dist)[live]
    mp = np.concatenate([m, py], axis=1)
    litq = rng.integers(40, 120, n).astype(np.int32)
    if kind == "prev block":
        ring_init = rng.integers(4100, 8000, nb)
    elif kind == "to start":
        ring_init = np.arange(nb) * B + rng.integers(-1, 2, nb)
    else:
        ring_init = rng.choice([0, 2000, 4000], nb)
    copyq = rng.integers(30, 200, W).astype(np.int32)
    copyq[:2] = 1 << 28
    icell = rng.integers(20, 300, W).astype(np.int32)
    icell[:2] = 1 << 28
    npos = n - B // 2 if kind == "npos cut" else n - 3
    return (mp, litq, data, ring_init.astype(np.int32), 40, copyq, icell,
            npos)


def edge_case(kind, n, seed):
    """Seeded K11 inputs at the main path's width: "seeds" (two seeds at
    one start, giving the end of one and the distance of the other;
    overlaps; a zero length with a live distance; starts below 0 and
    past n; 40,000 random seeds on repeated starts, none in the upper
    half, whose tiles find the last seed more than 32 tiles back) or
    "dictionary" (two hits at one position; advances of
    100 at block starts, whose << 25 wraps; advances of 1; one that
    overruns its block; payloads with bit 31 set; positions below 0 and
    past n; 20,000 random hits on repeated positions). Returns int64
    (pos, len, dist) or (pos, payload) arrays."""
    rng = np.random.default_rng(seed)
    if kind == "seeds":
        k = np.array([[100, 20, 7], [100, 10, 900], [5000, 40, 3],
                      [5010, 60, 11], [7000, 0, 55], [-5, 30, 2],
                      [n + 9, 70, 4], [n - 2, 5, 6]], np.int64)
        starts = rng.choice(np.arange(0, n, 61), 40_000)
        starts[starts > n // 2] //= 3  # the upper half's tiles stay empty
        r = np.stack([starts, rng.integers(0, 90, 40_000),
                      rng.integers(1, 1 << 22, 40_000)], 1)
        return tuple(np.concatenate([k, r]).T)
    adv = lambda a, wl, off: (a << 22) | (wl << 17) | off
    fixed = []
    for blk in (3, 700, 1023):
        b0 = blk * 4096
        fixed += [(b0, adv(9, 9, 70)), (b0, adv(5, 5, 99_000)),
                  (b0 + 1, adv(100, 24, 5)), (b0 + 7, adv(1, 4, 3)),
                  (b0 + 4086, adv(30, 20, 12)),
                  (b0 + 9, (1 << 31) | adv(9, 9, 1))]
    fixed += [(-4, adv(8, 8, 2)), (n + 100, adv(6, 6, 3)),
              (4096 * 5, adv(100, 24, 5))]
    pos = rng.choice(np.arange(0, n, 37), 20_000)
    pay = adv(rng.integers(0, 64, 20_000), 8,
              rng.integers(0, 1 << 17, 20_000))
    pay[::50] |= 1 << 31
    k = np.array(fixed, np.int64)
    return (np.concatenate([k[:, 0], pos]).astype(np.int64),
            np.concatenate([k[:, 1], pay]).astype(np.uint32).view(np.int32)
            .astype(np.int64))


def edge_kernels(arr, seg, maxd, rows, dev, card):
    """Phase 3's K9, K10 and K11 checks: each kernel bit for bit against
    its plain version on the card, on the first 4 MiB segment's real
    inputs (every level, the 16-byte one too) and on seeded cases: a
    tail-padded segment (3,000,001 live bytes of a 4 MiB bucket), npos
    0 and n, all-zero bytes, the (1 << 10) - 16 window, K10 on a bucket
    that starts in a raw dictionary's tail, duplicate seed
    starts and dictionary hits, random candidate words, the v1 layout;
    then each timed alone and beside its plain version, and the card's
    operations of one dp_v3_segment call with the plain edges and with
    the kernels (at most 100 with the kernels)."""
    from brotli_tpu_torch.ops import kernels, optimal as OPT
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    b = OPT._bucket_v3(len(seg))
    seed = OPT._seed_parse(seg, maxd, 0)
    tables = OPT._cost_tables(seg, seed, lit_table=True,
                              cfg=OPT.DPConfig())
    dict_g = OPT._dict_probe_global(seg, [seed], 0, maxd)
    bits_tab, ctx_tab, copyq, distq = OPT.device_tables(tables, dev)
    npos, spos, slen, sdist, dloc, dval = OPT.segment_inputs(
        arr, [seed], dict_g, 0, len(seg), b, dev)
    data = OPT.upload_input(arr, len(arr), dev)[:b]
    n = data.shape[0]
    levels = OPT.DPConfig(level3=True).levels
    lit1 = t(np.asarray(OPT._cost_tables(
        seg, seed, lit_table=False, cfg=OPT.DPConfig(mode="v1"))[0],
        np.int32).reshape(-1))
    seeds1 = [t(a.astype(np.int64)) for a in OPT._seg_seed_edges(
        [seed], 0, len(seg), OPT.SEG // 32)]
    hi_t = min(3_000_001, n - 12_345)
    data_t = torch.zeros_like(data)
    data_t[:hi_t] = data[:hi_t]
    npos_t, *rest_t = OPT.segment_inputs(arr, [seed], dict_g, 0, hi_t, b,
                                         dev)
    zeros = torch.zeros_like(data)
    errs = {"K9": {}, "K10": {}, "K10b": {}, "K11": {}}

    def cands(label, d, np_, window, lvls, base=0):
        """K9, the sort and K10's level launch per level (`base`: the
        stream position of the bucket's first byte), then K10's row
        pass, on the card, each against its plain version on the same
        inputs; returns the kernels' table."""
        words = torch.empty((len(lvls), n, kernels.MAX_RANKS),
                            dtype=torch.int32, device=dev)
        for lvl, (plen, ranks) in enumerate(lvls):
            lnp = max(np_ - (plen - 4), 0)
            key = kernels.edge_keys(d, lnp, plen)
            errs["K9"][f"{label} {plen}"] = max_abs_err(
                key, OPT.edge_keys_plain(d, lnp, plen))
            key_s, order = torch.sort(key, stable=True)
            kernels.edge_ranks(key_s, order, d, lnp, window, ranks,
                               words[lvl], base)
            want = torch.zeros_like(words[lvl])
            want[:, :len(ranks)] = OPT.edge_ranks_plain(key_s, order, d, lnp,
                                                        window, ranks, base)
            errs["K10"][f"{label} {plen}"] = max_abs_err(words[lvl], want)
        nranks = [len(r) for _, r in lvls]
        cand = kernels.edge_rows(words, nranks)
        errs["K10b"][label] = max_abs_err(
            cand, OPT.edge_rows_plain(words, nranks))
        return cand

    def slots(label, *args, **kw):
        got = kernels.edge_slots(*args, **kw)
        want = OPT.edge_slots_plain(*args, **kw)
        errs["K11"][label] = max(max_abs_err(g, w)
                                 for g, w in zip(got, want))
        return got

    seeds = (spos, slen, sdist)
    v3 = dict(ctx_tab=ctx_tab, dict_pos=dloc, dict_pay=dval, seg_base=0)
    cand39 = cands("real", data, npos, maxd, levels)
    slots("real 39 slots", cand39, data, maxd, distq, *seeds, bits_tab, **v3)
    del cand39
    cand = cands("real", data, npos, maxd, OPT.LEVELS)
    got = slots("real", cand, data, maxd, distq, *seeds, bits_tab, **v3)
    if not (got[0][:-2] >> 25).ge(2).sum() > n // 2:
        sys.exit("chip_smoke: the real segment's candidates are nearly "
                 "empty")
    slots("v1", cand, data, maxd, distq, *seeds1, lit1)
    ss = tuple(t(a) for a in edge_case("seeds", n, 1))
    dd = tuple(t(a) for a in edge_case("dictionary", n, 2))
    slots("duplicate seeds", cand, data, maxd, distq, *ss, bits_tab, **v3)
    slots("duplicate seeds v1", cand, data, maxd, distq, *ss, lit1)
    slots("duplicate dictionary hits", cand, data, maxd, distq, *seeds,
          bits_tab, ctx_tab=ctx_tab, dict_pos=dd[0], dict_pay=dd[1],
          seg_base=3 << 22)
    rng = np.random.default_rng(9)
    rand = t(rng.integers(-(1 << 31), 1 << 31, (n, cand.shape[1]),
                          dtype=np.int64).astype(np.int32))
    slots("random words", rand, data, maxd, distq, *ss, bits_tab,
          ctx_tab=ctx_tab, dict_pos=dd[0], dict_pay=dd[1], seg_base=12_345)
    del rand, got
    small = (1 << 10) - 16
    cw = cands("window", data, npos, small, OPT.LEVELS)
    slots("window", cw, data, small, distq, *seeds, bits_tab, **v3)
    del cw
    # the bucket's first h bytes a raw dictionary's tail before the
    # stream (the dcb route's halo, base -h): its sources are kept past
    # the window, so the small window's table holds distances above it
    for label, h, window in (("halo", 1 << 20, maxd),
                             ("halo window", 2 << 20, small)):
        ch = cands(label, data, npos, window, OPT.LEVELS, base=-h)
        far = int(((ch & ((1 << 25) - 1)) > window).sum())
        print(f"[3] K10 {label} (base -{h}): {far} candidates past the "
              f"window", flush=True)
        if window == small and not far:
            sys.exit("chip_smoke: K10 kept no source in the dictionary "
                     "past the window")
        del ch
    ct = cands("tail", data_t, npos_t, maxd, levels)
    slots("tail", ct, data_t, maxd, distq, *rest_t[:3], bits_tab,
          ctx_tab=ctx_tab, dict_pos=rest_t[3], dict_pay=rest_t[4],
          seg_base=0)
    del ct
    for label, d, np_ in (("npos 0", data, 0), ("npos n", data, n),
                          ("zeros", zeros, n - 3)):
        cands(label, d, np_, maxd, OPT.LEVELS)
    torch.cuda.synchronize()
    for k in ("K9", "K10", "K10b", "K11"):
        print(f"[3] {k}: max_abs_err {errs[k]}", flush=True)

    # timed: the 8-byte level (14 ranks) for K9 and K10's level launch,
    # the default 27 columns for K10's row pass, the default 29 slots for
    # K11, each alone and beside its plain version; the level's stable
    # sort of K9's int32 keys beside the first K9's int64 keys
    # (a library call, timed as a measurement only)
    plen, ranks = OPT.LEVELS[1]
    lnp = npos - (plen - 4)
    key = kernels.edge_keys(data, lnp, plen)
    key_s, order = torch.sort(key, stable=True)
    key64 = key.to(torch.int64) + (1 << 31)
    sort32 = cuda_ms(lambda: torch.sort(key, stable=True), 10, queued=True)
    sort64 = cuda_ms(lambda: torch.sort(key64, stable=True), 10, queued=True)
    print(f"[3] the level's torch.sort(stable=True) of {n} keys alone: "
          f"int32 {sort32:.4f} ms, int64 {sort64:.4f} ms [{card}]",
          flush=True)
    del key64
    ncand = cand.shape[1]
    nslots = ncand + 2
    nranks = [len(r) for _, r in OPT.LEVELS]
    words = torch.empty((len(nranks), n, kernels.MAX_RANKS),
                        dtype=torch.int32, device=dev)
    ln = npos  # the row pass's inputs: the 4-byte level's rows too
    ks, od = torch.sort(kernels.edge_keys(data, ln, 4), stable=True)
    kernels.edge_ranks(ks, od, data, ln, maxd, OPT.LEVELS[0][1], words[0])
    del ks, od
    k11 = lambda: kernels.edge_slots(cand, data, maxd, distq, *seeds,
                                     bits_tab, **v3)
    k11_plain = lambda: OPT.edge_slots_plain(cand, data, maxd, distq,
                                             *seeds, bits_tab, **v3)
    rows["K9"] = dict(
        name="edge_keys", route="cuda",
        source="brotli_tpu_torch/csrc/edge_keys.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:144",
        max_abs_err=max(errs["K9"].values()),
        ms=cuda_ms(lambda: kernels.edge_keys(data, lnp, plen), 10),
        device_ms=cuda_ms(lambda: kernels.edge_keys(data, lnp, plen), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.edge_keys_plain(data, lnp, plen), 3),
        nbytes=n + 4 * n,
        # two words, two multiplies, the key: about 20 operations
        nops=n * 20)
    rows["K10"] = dict(
        name="edge_ranks", route="cuda",
        source="brotli_tpu_torch/csrc/edge_ranks.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:149",
        max_abs_err=max(errs["K10"].values()),
        ms=cuda_ms(lambda: kernels.edge_ranks(key_s, order, data, lnp, maxd,
                                              ranks, words[1]), 10),
        device_ms=cuda_ms(lambda: kernels.edge_ranks(
            key_s, order, data, lnp, maxd, ranks, words[1]), 10,
            queued=True),
        plain_ms=cuda_ms(lambda: OPT.edge_ranks_plain(
            key_s, order, data, lnp, maxd, ranks), 2),
        # the keys, the order, the bytes; the level's words (its rows
        # are padded to 64 bytes, which the bound does not count)
        nbytes=4 * n + 8 * n + n + 4 * len(ranks) * n,
        # the neighbour's key, order and a word compare a rank: about 8
        nops=n * len(ranks) * 8)
    rows["K10b"] = dict(
        name="edge_rows", route="cuda",
        source="brotli_tpu_torch/csrc/edge_ranks.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:174",
        max_abs_err=max(errs["K10b"].values()),
        ms=cuda_ms(lambda: kernels.edge_rows(words, nranks), 10),
        device_ms=cuda_ms(lambda: kernels.edge_rows(words, nranks), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.edge_rows_plain(words, nranks), 3),
        # the one PyTorch call that makes the same table (the port does
        # not call it: a measurement only)
        library_ms=cuda_ms(lambda: torch.cat(
            [words[lvl, :, :nr] for lvl, nr in enumerate(nranks)], 1), 3),
        # the levels' words read, the table written
        nbytes=8 * ncand * n,
        # a copy a word
        nops=n * ncand)
    ns, nd = spos.shape[0], dloc.shape[0]
    rows["K11"] = dict(
        name="edge_slots", route="cuda",
        source="brotli_tpu_torch/csrc/edge_slots.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:210",
        max_abs_err=max(errs["K11"].values()),
        ms=cuda_ms(k11, 10), device_ms=cuda_ms(k11, 10, queued=True),
        plain_ms=cuda_ms(k11_plain, 3),
        nbytes=(4 * ncand * n + n + 24 * ns + 16 * nd +
                4 * (64 + 64 * 256 + 256 * 256) + 8 * nslots * n + 8 * n),
        # a distance cost (about 12 operations) a slot and position
        nops=n * nslots * 12)
    del key, key_s, order, words

    # the card's operations of one segment, with the plain edges (the
    # dispatchers swapped for the plain versions) and with the kernels
    args = (data, npos, maxd, bits_tab, ctx_tab, copyq, distq, *seeds,
            dloc, dval, 0)
    seg_fn = lambda: OPT.dp_v3_segment(*args, capm=b // OPT.CAPM_DIV)
    swap = dict(
        edge_keys=OPT.edge_keys_plain,
        edge_ranks=lambda ks, o, d, np_, w, r, words, base=0, row0=0,
        wide=False: words.copy_(torch.nn.functional.pad(
            OPT.edge_ranks_plain(ks, o, d, np_, w, r, base, row0, wide),
            (0, words.shape[1] - len(r)))),
        edge_rows=OPT.edge_rows_plain,
        edge_slots=OPT.edge_slots_plain)
    keep = {k: getattr(OPT, k) for k in swap}
    for k, f in swap.items():
        setattr(OPT, k, f)
    try:
        ops_plain, kern_plain = device_ops(seg_fn)
        ms_plain = cuda_ms(seg_fn, 2)
        want = seg_fn()
    finally:
        for k, f in keep.items():
            setattr(OPT, k, f)
    ops, kern = device_ops(seg_fn, show=True)
    ms_seg = cuda_ms(seg_fn, 5)
    got = seg_fn()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"[3] one dp_v3_segment ({n} positions): plain edges {ops_plain} "
          f"device operations ({kern_plain} kernels) in {ms_plain:.3f} ms; "
          f"K9-K11 {ops} ({kern} kernels) in {ms_seg:.3f} ms (one call, "
          f"CUDA events) [{card}]; the same result: {same}", flush=True)
    if ops > 100 or not same:
        sys.exit(f"chip_smoke: one dp_v3_segment took {ops} device "
                 f"operations (at most 100), or differs with the plain "
                 f"edges")
    return ops_plain, ops


def edge_ranks_halo(arr, rows, dev, card):
    """Phase 3's K10 with a halo, at the q11_w24 cell's last full
    segment: the 16 MiB corpus as one segment's candidate rows, its
    first 12 MiB history before a 4 MiB bucket (row0), lgwin 24's
    window, on K9's wide keys as the route ranks there. K9 on the 16 Mi
    rows and K10's level launch writing the bucket's rows only, each bit
    for bit against its plain version on the card, both levels; K10's
    rows also against the rows from row0 of its halo-free launch over
    the same rows; then K10's halo launch at the 8-byte level timed
    alone and beside its plain version (row "K10h")."""
    from brotli_tpu_torch.ops import kernels, optimal as OPT
    maxd = (1 << 24) - 16
    data = OPT.upload_input(arr, len(arr), dev)[:len(arr)]
    nh = data.shape[0]
    row0 = nh - OPT.SEG_V3
    errs = {}
    for plen, ranks in OPT.LEVELS:
        lnp = nh - 3 - (plen - 4)
        key = kernels.edge_keys(data, lnp, plen, wide=True)
        errs[f"K9 {plen}"] = max_abs_err(
            key, OPT.edge_keys_plain(data, lnp, plen, wide=True))
        key_s, order = torch.sort(key, stable=True)
        del key
        words = torch.empty((nh - row0, kernels.MAX_RANKS),
                            dtype=torch.int32, device=dev)
        kernels.edge_ranks(key_s, order, data, lnp, maxd, ranks, words, 0,
                           row0, wide=True)
        want = OPT.edge_ranks_plain(key_s, order, data, lnp, maxd, ranks, 0,
                                    row0, wide=True)
        errs[f"K10h {plen}"] = max(
            max_abs_err(words[:, :len(ranks)], want),
            int(words[:, len(ranks):].abs().max()))
        whole = torch.empty((nh, kernels.MAX_RANKS), dtype=torch.int32,
                            device=dev)
        kernels.edge_ranks(key_s, order, data, lnp, maxd, ranks, whole,
                           wide=True)
        errs[f"K10h {plen} halo-free"] = max_abs_err(words, whole[row0:])
        far = int(((want & ((1 << 25) - 1)) > OPT.SEG_V3 - 16).sum())
        print(f"[3] K10 halo, level {plen}: {far} of the bucket's "
              f"candidates reach past SEG_V3 - 16", flush=True)
        del whole, want
    torch.cuda.synchronize()
    print(f"[3] K9/K10 with a halo ({nh} rows, row0 {row0}): max_abs_err "
          f"{errs}", flush=True)
    if any(errs.values()):
        sys.exit("chip_smoke: K9 or K10 with a halo differs from its plain "
                 "version")
    rows["K10h"] = dict(
        name="edge_ranks", counted_as="edge_ranks_halo", route="cuda",
        source="brotli_tpu_torch/csrc/edge_ranks.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:149",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.edge_ranks(key_s, order, data, lnp, maxd,
                                              ranks, words, 0, row0, True),
                   10),
        device_ms=cuda_ms(lambda: kernels.edge_ranks(
            key_s, order, data, lnp, maxd, ranks, words, 0, row0, True), 10,
            queued=True),
        plain_ms=cuda_ms(lambda: OPT.edge_ranks_plain(
            key_s, order, data, lnp, maxd, ranks, 0, row0, True), 2),
        # the keys, the order and the bytes of every row; the bucket's
        # words (rows padded to 64 bytes, which the bound does not count)
        nbytes=4 * nh + 8 * nh + nh + 4 * len(ranks) * (nh - row0),
        # a written row's ranks: about 8 operations each
        nops=(nh - row0) * len(ranks) * 8, n=nh)
    del key_s, order, words, data


def dict_probe_check(arr, maxd, rows, dev, card):
    """Phase 3's K12 check: the DP's dictionary probe with the input on
    the card (ops/optimal._dict_probe_global, which launches K12) bit
    for bit against native.dict_probe_all, the host probe it replaces,
    at the main path's two shapes: the first SEG_V3 bytes after their
    own seed parse (the early first probe) and the whole input (the
    second). Times K12 and the native probe on the whole input."""
    import brotli_tpu_torch.ops.optimal as OPT
    from brotli_tpu_torch import native
    from brotli_tpu_torch.ops import kernels

    def hits(got):
        return (np.zeros(0, np.uint32),) * 2 if got is None else got[:2]

    def err(got, want):
        if len(got[0]) != len(want[0]):
            return abs(len(got[0]) - len(want[0])) << 32
        return max((int(np.abs(g.astype(np.int64) - w).max(initial=0))
                    for g, w in zip(got, want)), default=0)

    errs = {}
    for n in (OPT.SEG_V3, len(arr)):
        part = arr[:n]
        seed = OPT._seed_parse(part, maxd, 0)
        buf = OPT.upload_input(part, n, dev)
        got = OPT._dict_probe_global(part, [seed], 0, maxd, buf)
        t0 = time.perf_counter()
        try:
            want = native.dict_probe_all(part.tobytes(), seed[0], seed[1],
                                         0, maxd)
        except ValueError:
            want = None
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs[n] = err(hits(got), hits(want))
        print(f"[3] K12 dict_probe, n={n}: {len(got[0])} hits, native "
              f"{len(hits(want)[0])} in {plain_ms:.1f} ms; max_abs_err "
              f"{errs[n]} [{card}]", flush=True)
    gates = torch.from_numpy(
        native.probe_gates(seed[0], seed[1]).view(np.int32)).to(dev)
    image = OPT.dict_image(dev)
    k12 = lambda: kernels.dict_probe(buf, n, gates, 0, maxd, image)
    rows["K12"] = dict(
        name="dict_probe", route="cuda",
        source="brotli_tpu_torch/csrc/dict_probe.cu",
        replaces="brotli_tpu/native/btpu_enc.c:5804",
        max_abs_err=max(errs.values()), n=n,
        ms=cuda_ms(k12, 10), device_ms=cuda_ms(k12, 10, queued=True),
        plain_ms=plain_ms,
        # the input and the table image read once
        nbytes=n + image.numel(),
        # a position's gate search, hashes and bucket bounds: about 20
        nops=n * 20)
    del buf, gates


def device_ops(fn, show=False):
    """The card's operations (kernels, copies, memsets) of one call of
    fn after a warm-up (torch.profiler), and how many were kernels; with
    `show`, print them by name."""
    from brotli_tpu_torch.utils.trace import device_profile
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        fn()
    names = [e.name.replace("(anonymous namespace)::", "").split("(")[0][:60]
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [x for x in names if not x.lower().startswith(("memcpy",
                                                          "memset"))]
    if show:
        counts = {}
        for x in names:
            counts[x] = counts.get(x, 0) + 1
        print("    " + "; ".join(f"{k} x{v}" for k, v in counts.items()))
    return len(names), len(kern)


def dp_launches(nseg, scan="dp_scan", nlevels=2, probes=0):
    """The kernel launches of `nseg` v3 DP segments: K9 and K10's level
    launch once a level, K10's row pass, K11, K1, the scan and K4 once a
    segment; and K12 once a dictionary probe (`probes`: one a
    find_matches_optimal call, two when it dispatches its first segment
    early, one a shard on the mesh)."""
    want = {"edge_keys": nlevels * nseg, "edge_ranks": nlevels * nseg,
            "edge_rows": nseg, "edge_slots": nseg, "suffix_min": nseg,
            scan: nseg, "dp_backtrack": nseg}
    if probes:
        want["dict_probe"] = probes
    return want


def bound(nbytes, nops):
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def stage_table(report):
    """A trace.report() as lines, the longest stage first."""
    rows = sorted(report.items(), key=lambda kv: -kv[1][1])
    width = max((len(k) for k, _ in rows), default=4)
    return "\n".join(f"{k.ljust(width)}  {c:6d} calls  {s * 1000:9.1f} ms"
                     for k, (c, s) in rows)


def timed(fn):
    """(result, seconds) of fn() on the host clock, between two
    synchronizes."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def three_runs(fn, trace, kernels, label, corpus, decompress, card,
               first_fn=None):
    """A first run (through `first_fn` when given), a timed run with the
    trace off (kernel launches and peak device memory counted, the
    stream decoded back exactly) and a traced run; all three must give
    the same bytes. Returns the timed run's launches and stream."""
    first, cold = timed(first_fn or fn)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out, wall = timed(fn)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if decompress(out) != corpus:
        sys.exit(f"chip_smoke: the {label} stream does not decode back")
    print(f"    {label}: {len(corpus)} B -> {len(out)} B (ratio "
          f"{len(corpus) / len(out):.4f}) in {wall:.3f} s = "
          f"{len(corpus) / wall / 1e6:.3f} MB/s [{card}]; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    trace.enable()
    trace.reset()
    again, traced = timed(fn)
    trace.enable(False)
    print(f"    first run {cold:.3f} s, traced run {traced:.3f} s; "
          f"stages of the traced run:")
    print(stage_table(trace.report()), flush=True)
    if not first == out == again:
        sys.exit(f"chip_smoke: {label} runs on the same input differ")
    return launches, out


def q11_lgwin24(corpus, trace, kernels, card):
    """Phase 4's lgwin 24 request on the q11_w24 cell's shape: the corpus
    and its first 16 KiB again, compressed twice on the card with the
    same bytes, decoded back; in the second run the launches of K9 and
    K10 over a halo (more rows than a 4 MiB bucket, a first row past 0)
    and dp.halo_bytes are counted. Returns those launches."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch.ops import optimal as OPT
    doc = corpus + corpus[:16 << 10]
    first = bt.compress(doc, quality=11, lgwin=24)
    halo = {"edge_keys": 0, "edge_ranks": 0}
    keys, ranks = kernels.edge_keys, kernels.edge_ranks

    def keys_counted(data, *a):
        halo["edge_keys"] += data.shape[0] > OPT.SEG_V3
        return keys(data, *a)

    def ranks_counted(*a):
        halo["edge_ranks"] += a[8] > 0  # row0
        return ranks(*a)
    kernels.edge_keys, kernels.edge_ranks = keys_counted, ranks_counted
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    trace.enable()
    try:
        out, wall = timed(lambda: bt.compress(doc, quality=11, lgwin=24))
    finally:
        trace.enable(False)
        kernels.edge_keys, kernels.edge_ranks = keys, ranks
    got = trace.counters().get("dp.halo_bytes", 0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    q11 lgwin 24: {len(doc)} B -> {len(out)} B (ratio "
          f"{len(doc) / len(out):.4f}) in {wall:.3f} s (traced) [{card}]; "
          f"peak device memory {peak:.2f} GiB; launches over a halo "
          f"{halo}; dp.halo_bytes {got}", flush=True)
    if out != first or bt.decompress(out) != doc:
        sys.exit("chip_smoke: the lgwin 24 stream differs between runs or "
                 "does not decode back")
    want = 2 * (-(-len(doc) // OPT.SEG_V3) - 1)
    if halo != {"edge_keys": want, "edge_ranks": want} or \
            got != (4 + 8 + 12 + 12) << 20:
        sys.exit(f"chip_smoke: lgwin 24 launched {halo} over a halo, not "
                 f"{want} each, with dp.halo_bytes {got}")
    return halo


def seeded_k5_k6(dev, n5=1 << 24, b6=1 << 22):
    """Phase 3's K5 and K6 checks on seeded inputs: K5 at n5 outputs,
    K6 at the field count of a b6-byte metablock. Returns the errors
    (and K6's total bits) by case."""
    from brotli_tpu_torch.ops import bitpack as BP, kernels
    from brotli_tpu_torch.ops import lz_resolve as LZ

    # K5 on seeded command lists at 16 Mi outputs, K6 on seeded fields at
    # the 4 MiB metablock's count; both are timed on the main path's real
    # inputs in phases 9 and 10. Every comparison is bitwise
    seeded = {"K5": {}, "K6": {}}
    k5_stats = {}
    for label, lits, cmds, steps in k5_cases(n5, 7):
        la = torch.from_numpy(lits).to(dev)
        ct = [torch.from_numpy(c).to(dev) for c in cmds]
        got, flag, st = kernels.lz_resolve(la, *ct, n5, steps, stats=True)
        want = LZ.resolve_plain(la, *ct, n5, steps)
        seeded["K5"][label] = max_abs_err(got, want) + int(flag.item())
        k5_stats[label] = st.tolist()
    # a copy from before the output sets K5's error flag
    _, flag = kernels.lz_resolve(la[:1], *(torch.tensor(
        [v], dtype=torch.int32, device=dev) for v in (1, n5 - 1, 2)), n5,
        24)
    if int(flag.item()) == 0:
        sys.exit("chip_smoke: K5 took a copy from before the output")
    print(f"[3] K5 lz_resolve at n_out={n5}: [positions left after the "
          f"tile collapse, hops, most hops of one position] {k5_stats}",
          flush=True)
    del la, ct, got, want
    nf6, cw6 = 5 * (b6 // 4 + 8) + b6, b6 // 2 + 64
    k6_slow = {}
    for label, kind in (("seeded", "seeded"), ("overflow", "overflow"),
                        ("overflow mid-tile", "seeded"), ("wide", "wide")):
        v6, m6, t6, bit0 = k6_case(nf6, 11, kind)
        v6, m6 = torch.from_numpy(v6).to(dev), torch.from_numpy(m6).to(dev)
        t6 = [torch.from_numpy(t).to(dev) for t in t6]
        cap = cw6
        if label == "overflow mid-tile":  # the words end 60% in
            cap = int(seeded["K6"]["seeded bits"] * 0.6) // 32
        words, total, slow = kernels.bitpack(v6, m6, t6, bit0, cap,
                                             stats=True)
        pw, pt = BP.pack_plain(v6, m6, *t6, bit0, cap)
        seeded["K6"][label] = max(max_abs_err(words, pw),
                                  abs(int(total) - int(pt)))
        seeded["K6"][label + " bits"] = int(pt)
        k6_slow[label] = int(slow)
    print(f"[3] K5 lz_resolve at n_out={n5}, K6 bitpack at {nf6} fields "
          f"(cap {32 * cw6} bits): max_abs_err, total bits {seeded}; K6 "
          f"slow-path tiles {k6_slow} of {-(-nf6 // kernels.PACK_TILE)}",
          flush=True)
    if any(v for k in ("K5", "K6") for lb, v in seeded[k].items()
           if not lb.endswith("bits")):
        sys.exit(f"chip_smoke: K5 or K6 disagree with their plain "
                 f"versions: {seeded}")
    # 24 bits a field: the tiles whose span reaches the last word
    ends6 = 24 * np.minimum(np.arange(1, -(-nf6 // kernels.PACK_TILE) + 1)
                            * kernels.PACK_TILE, nf6)
    over = int(((seeded["K6"]["overflow bits"] - 24 * nf6 + ends6 - 1)
                >> 5 >= cw6 - 1).sum())
    if k6_slow["seeded"] or k6_slow["wide"] != 1 or \
            k6_slow["overflow"] != over or not k6_slow["overflow mid-tile"]:
        sys.exit(f"chip_smoke: K6's slow path took the wrong tiles: "
                 f"{k6_slow}")
    del v6, m6, t6, words, pw
    torch.cuda.empty_cache()
    return seeded


def device_serializer(corpus, part, q5_out, out2, rows, seeded, card):
    """Phase 9: the q5 path through the device serializer (K6), K6 on
    the first metablock's real fields (its kernels-line row), the
    plan's launches, cuda against cpu, and q11 with two shards.
    Returns the main path's launches."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch.ops import bitpack as BP, kernels
    from brotli_tpu_torch.parallel import device_serialize as DS
    from brotli_tpu_torch.parallel.shard import compress_sharded
    from brotli_tpu_torch.utils import trace

    print("[9] q5, compress_sharded(serializer='device')", flush=True)
    first_args = {}

    def capturing(name, fn):
        def wrapped(*args):
            first_args.setdefault(name, args)
            return fn(*args)
        return wrapped

    def first_run():
        """The first run, recording the plan's and K6's inputs of the
        first metablock."""
        plan, pack = BP.plan, BP.pack
        BP.plan, BP.pack = capturing("plan", plan), capturing("pack", pack)
        try:
            return compress_sharded(corpus, quality=5, serializer="device")
        finally:
            BP.plan, BP.pack = plan, pack

    DS.HOST_SHARDS = 0
    launches_ds, ds_out = three_runs(
        lambda: compress_sharded(corpus, quality=5, serializer="device"),
        trace, kernels, "q5 device serializer", corpus, bt.decompress, card,
        first_fn=first_run)
    print(f"    native serializer {len(q5_out)} B, device serializer "
          f"{len(ds_out)} B ({len(ds_out) / len(q5_out) - 1:+.4%}); "
          f"shards left to the native serializer {DS.HOST_SHARDS}",
          flush=True)
    if DS.HOST_SHARDS or launches_ds["bitpack"] != 4:
        sys.exit(f"chip_smoke: the device serializer left "
                 f"{DS.HOST_SHARDS} shards to the host and launched K6 "
                 f"{launches_ds['bitpack']} times, not 4")
    pk = first_args["pack"]
    words, total = BP.pack(*pk)
    pw, pt = BP.pack_plain(*pk)
    err6 = max(max_abs_err(words, pw), abs(int(total) - int(pt)))
    vals6, mk6, tabs6, cw6 = pk[0], pk[1], pk[2:8], pk[9]
    rows["K6"] = dict(
        name="bitpack", route="cuda",
        source="brotli_tpu_torch/csrc/bitpack.cu",
        replaces="brotli_tpu/ops/bitpack.py:277",
        max_abs_err=max([err6] + [v for lb, v in seeded["K6"].items()
                                  if not lb.endswith("bits")]),
        ms=cuda_ms(lambda: BP.pack(*pk), 10),
        device_ms=cuda_ms(lambda: BP.pack(*pk), 10, queued=True),
        plain_ms=cuda_ms(lambda: BP.pack_plain(*pk), 3),
        # the fields read once, the tables, the words written once
        nbytes=(vals6.numel() + mk6.numel() + sum(t.numel() for t in tabs6)
                + cw6) * 4,
        nops=vals6.numel() * 16)
    slow6 = int(kernels.bitpack(pk[0], pk[1], pk[2:8], pk[8], pk[9],
                                stats=True)[2])
    print(f"    K6 on the first metablock's {vals6.numel()} fields: "
          f"max_abs_err {err6}, total bits {int(pt)}, slow-path tiles "
          f"{slow6}", flush=True)
    print("    K6's launches on the card (torch.profiler): " + "; ".join(
        launch_split(lambda: kernels.bitpack(pk[0], pk[1], pk[2:8], pk[8],
                                             pk[9]))), flush=True)
    with trace.device_profile() as prof:
        BP.plan(*first_args["plan"])
    plan_launches = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"    the plan of one metablock: {plan_launches} device kernels "
          f"and copies", flush=True)
    del first_args, pk, words, pw, vals6, mk6, tabs6
    torch.cuda.empty_cache()

    prefix = corpus[:1 << 20]
    on_card = compress_sharded(prefix, quality=5, serializer="device")
    t0 = time.perf_counter()
    on_cpu = compress_sharded(prefix, quality=5, serializer="device",
                              device="cpu")
    print(f"    1 MiB prefix: cuda {len(on_card)} B, cpu {len(on_cpu)} B "
          f"(cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: device-serializer cuda and cpu streams differ")
    out3, wall3 = timed(lambda: compress_sharded(
        part, quality=11, n_shards=2, serializer="device"))
    print(f"    q11, two shards, device serializer: {len(part)} B -> "
          f"{len(out3)} B (native serializer {len(out2)} B) in {wall3:.3f} "
          f"s [{card}]; shards left to the native serializer "
          f"{DS.HOST_SHARDS}", flush=True)
    if bt.decompress(out3) != part or DS.HOST_SHARDS:
        sys.exit("chip_smoke: the two-shard device-serialized q11 stream "
                 "does not decode, or a shard went to the host")
    return launches_ds


def device_decoder(corpus, streams, rows, seeded, dev, card):
    """Phase 10: the device decoder on each (label, stream) of the
    corpus against the native decoder, its parse and resolve split,
    and K5 on the real parse of the first stream (its kernels-line
    row). Returns the main path's launches."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch import native
    from brotli_tpu_torch.ops import kernels, lz_resolve as LZ
    from brotli_tpu_torch.utils import trace

    print("[10] decompress(decoder='device')", flush=True)
    kernels.reset_launches()
    for label, stream in streams:
        if bt.decompress(stream, decoder="device") != corpus:
            sys.exit(f"chip_smoke: the device decoder got the {label} "
                     f"stream wrong")
    launches_dec = dict(kernels.LAUNCHES)
    if launches_dec["lz_resolve"] != len(streams):
        sys.exit(f"chip_smoke: the device decoder launched K5 "
                 f"{launches_dec['lz_resolve']} times, not {len(streams)}")
    for label, stream in streams:
        _, wall_nat = timed(lambda: bt.decompress(stream))
        _, wall_dev = timed(lambda: bt.decompress(stream, decoder="device"))
        trace.enable()
        trace.reset()
        timed(lambda: bt.decompress(stream, decoder="device"))
        trace.enable(False)
        split = {k: round(v[1] * 1e3, 3) for k, v in trace.report().items()}
        lits, cn, cc, cd, depth = native.parse_stream(stream)
        n_out = int(cn.sum(dtype=np.int64) + cc.sum(dtype=np.int64))
        steps = LZ.n_steps_for(n_out, depth)
        print(f"    {label}: {len(stream)} B -> {n_out} B; native decoder "
              f"{wall_nat:.3f} s, device decoder {wall_dev:.3f} s "
              f"[{card}]; traced ms {split}; {len(cn)} commands, "
              f"{len(lits)} literals, chain depth {depth}, {steps} rounds",
              flush=True)
        args5 = (torch.from_numpy(np.frombuffer(lits, np.uint8).copy())
                 .to(dev), *(torch.from_numpy(c.astype(np.int32)).to(dev)
                             for c in (cn, cc, cd)), n_out, steps)
        left, hops, most = kernels.lz_resolve(*args5, stats=True)[2].tolist()
        print(f"    K5 on the {label} stream's parse: {left} positions "
              f"({left / n_out:.4f}) left after the tile collapse, {hops} "
              f"hops of the global jumps ({hops / max(left, 1):.3f} a "
              f"position left), at most {most} for one position",
              flush=True)
        if label == streams[0][0]:
            real5 = args5
    got, flag = kernels.lz_resolve(*real5)
    err5 = max_abs_err(got, LZ.resolve_plain(*real5)) + int(flag.item())
    print(f"    K5 on the {streams[0][0]} stream's parse: max_abs_err {err5}",
          flush=True)
    print("    K5's launches on the card (torch.profiler): " + "; ".join(
        launch_split(lambda: kernels.lz_resolve(*real5))), flush=True)
    la5, nl5, n5 = real5[0], real5[1], real5[4]
    rows["K5"] = dict(
        name="lz_resolve", route="cuda",
        source="brotli_tpu_torch/csrc/lz_resolve.cu",
        replaces="brotli_tpu/ops/lz_resolve.py:29",
        max_abs_err=max([err5] + list(seeded["K5"].values())),
        ms=cuda_ms(lambda: kernels.lz_resolve(*real5), 10),
        device_ms=cuda_ms(lambda: kernels.lz_resolve(*real5), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: LZ.resolve_plain(*real5), 3),
        # the literals and the three command arrays read once, the
        # output written once
        nbytes=la5.numel() + 3 * nl5.numel() * 4 + n5,
        nops=n5)
    for k in ("K5", "K6"):
        r = rows[k]
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("nops"))
        print(f"    {k} {r['name']}: kernel {r['ms']:.3f} ms one call "
              f"(the card alone {r['device_ms']:.3f} ms), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]")
    print(f"    K5 lz_resolve: the floor of its design, the states' round "
          f"trip (8 B a position written, 8 read) and the bytes out: "
          f"{17 * n5 / PEAK_BYTES * 1e3:.3f} ms at {n5} positions")
    bad = [k for k in ("K5", "K6") if rows[k]["max_abs_err"] != 0]
    if bad:
        sys.exit(f"chip_smoke: kernels disagree with their plain "
                 f"versions: {bad}")
    return launches_dec


def public_surface(corpus, q11_out, q5_out, card):
    """Phase 11: the public API and the CLI over the native runtime and
    the card. Every item prints its bytes, wall and MB/s. Returns the
    card's q11 stream of the 4 MiB prefix."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch.ops import kernels

    def item(label, fn, n_in):
        out, wall = timed(fn)
        print(f"    {label}: {n_in} B -> {len(out)} B in {wall:.3f} s = "
              f"{n_in / wall / 1e6:.3f} MB/s [{card}]", flush=True)
        return out

    print("[11] the public surface: api and cli", flush=True)
    for q in (1, 5, 9):
        kernels.reset_launches()
        out = item(f"compress q{q} (native)",
                   lambda: bt.compress(corpus, quality=q), len(corpus))
        if any(kernels.LAUNCHES.values()):
            sys.exit(f"chip_smoke: the native q{q} route launched "
                     f"{kernels.LAUNCHES}")
        if bt.decompress(out) != corpus:
            sys.exit(f"chip_smoke: the native q{q} stream does not decode")

    part = corpus[:4 << 20]
    kernels.reset_launches()
    on_card = item("compress q11, 4 MiB, the card (default)",
                   lambda: bt.compress(part, quality=11), len(part))
    launches = dict(kernels.LAUNCHES)
    print(f"    launches {launches}", flush=True)
    native_q11 = item("compress q11, 4 MiB, encoder='native'",
                      lambda: bt.compress(part, quality=11,
                                          encoder="native"), len(part))
    if any(launches[k] != v for k, v in dp_launches(1, probes=1).items()):
        sys.exit(f"chip_smoke: the card's q11 route launched {launches}, "
                 f"not {dp_launches(1, probes=1)}")
    if on_card == native_q11:
        sys.exit("chip_smoke: the card's and the native q11 streams agree")
    if bt.decompress(on_card) != part or bt.decompress(native_q11) != part:
        sys.exit("chip_smoke: a q11 stream of the 4 MiB prefix does not "
                 "decode")
    print(f"    q11 on 4 MiB: native - card = "
          f"{len(native_q11) - len(on_card)} B", flush=True)

    def stream_both_ways():
        c = bt.Compressor(quality=5)
        pieces = []
        for i in range(0, len(corpus), 1 << 20):
            pieces += [c.process(corpus[i:i + (1 << 20)]), c.flush()]
        pieces.append(c.finish())
        comp = b"".join(pieces)
        d = bt.Decompressor()
        back, pos, calls = [], 0, 0
        while not d.is_finished():
            piece = b""
            if d.can_accept_more_data():
                if pos == len(comp):
                    sys.exit("chip_smoke: Decompressor did not finish")
                piece = comp[pos:pos + (1 << 20)]
                pos += len(piece)
            back.append(d.process(piece, output_buffer_limit=1 << 20))
            calls += 1
            if len(back[-1]) > 1 << 20:
                sys.exit("chip_smoke: Decompressor exceeded its limit")
        return comp, b"".join(back), calls

    (comp, back, calls), wall = timed(stream_both_ways)
    print(f"    Compressor q5 (1 MiB pieces, a flush each) {len(comp)} B, "
          f"Decompressor at a 1 MiB limit ({calls} calls), both in "
          f"{wall:.3f} s = {len(corpus) / wall / 1e6:.3f} MB/s [{card}]",
          flush=True)
    if back != corpus:
        sys.exit("chip_smoke: the streaming round trip differs")

    both = item("decompress_concatenated(q11 + q5 streams)",
                lambda: bt.decompress_concatenated(q11_out + q5_out),
                len(q11_out) + len(q5_out))
    if both != corpus + corpus:
        sys.exit("chip_smoke: decompress_concatenated differs")

    dic, target = corpus[:1 << 20], corpus[1 << 20:5 << 20]
    with_dict = item("compress q5, 4 MiB, the 1 MiB before as a raw "
                     "dictionary",
                     lambda: bt.compress(target, quality=5, dictionary=dic),
                     len(target))
    if bt.decompress(with_dict, dictionary=dic) != target:
        sys.exit("chip_smoke: the raw-dictionary stream does not decode")
    large = item("compress q5, lgwin 26, large_window",
                 lambda: bt.compress(corpus, quality=5, lgwin=26,
                                     large_window=True), len(corpus))
    if bt.decompress(large, large_window=True) != corpus:
        sys.exit("chip_smoke: the large-window stream does not decode")

    prefix = corpus[:1 << 20]
    in_process = bt.compress(prefix, quality=11)
    native_prefix = bt.compress(prefix, quality=11, encoder="native")
    here = pathlib.Path(__file__).resolve().parent
    cli = [sys.executable, "-m", "brotli_tpu_torch.cli"]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "prefix.bin")
        with open(src, "wb") as f:
            f.write(prefix)
        t0 = time.perf_counter()
        r = subprocess.run(cli + ["-q", "11", "-c", src], cwd=here,
                           capture_output=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            sys.exit(f"chip_smoke: the CLI failed: {r.stderr.decode()}")
        print(f"    cli -q 11 -c, 1 MiB: {len(r.stdout)} B in {wall:.3f} s "
              f"(a new process) [{card}]; in process, the card "
              f"{len(in_process)} B, native {len(native_prefix)} B",
              flush=True)
        if r.stdout != in_process or r.stdout == native_prefix:
            sys.exit("chip_smoke: the CLI's q11 bytes are not the card's")
        with open(os.path.join(tmp, "back.bin.br"), "wb") as f:
            f.write(r.stdout)
        r = subprocess.run(cli + ["-d", os.path.join(tmp, "back.bin.br")],
                           cwd=here, capture_output=True, timeout=600)
        if r.returncode != 0:
            sys.exit(f"chip_smoke: cli -d failed: {r.stderr.decode()}")
        with open(os.path.join(tmp, "back.bin"), "rb") as f:
            if f.read() != prefix:
                sys.exit("chip_smoke: cli -d did not give the file back")
    return on_card


def dp_variants(corpus, rows, dev, card):
    """Phase 12: the DP variants (ops/optimal.DPConfig). K7 and K8
    against their plain versions on the real first v1 and v3 segments
    and on seeded extremes, K1 at 39 slots; v1 and the ring scan at full
    width; cuda against cpu; the other variants on a prefix; v1 with
    two shards. Returns the v1 and ring paths' launches."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch.format import constants as C
    from brotli_tpu_torch.ops import kernels, optimal as OPT
    from brotli_tpu_torch.parallel.shard import compress_sharded
    from brotli_tpu_torch.utils import trace

    DP = OPT.DPConfig
    B, W = OPT.B, OPT.W
    arr = np.frombuffer(corpus, np.uint8)
    maxd = C.max_backward_distance(22)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    print("[12] the DP variants", flush=True)

    # -- K7 on the v1 path's first segment (the whole input's seed and
    # cost tables, as find_matches_optimal builds them), 28 and 38 slots
    seed = OPT._seed_parse(arr, maxd, 0)
    lit, copyq1, distq1 = (t(np.asarray(a, np.int32).reshape(-1)) for a in
                           OPT._cost_tables(arr, seed, lit_table=False,
                                            cfg=DP(mode="v1")))
    seg_seeds = [t(a.astype(np.int64)) for a in OPT._seg_seed_edges(
        [seed], 0, OPT.SEG, OPT.SEG // 32)]
    data1 = t(arr[:OPT.SEG])
    errs, slow7 = {}, {}

    def k7_vs_plain(label, *args):
        got = kernels.dp_scan_v1(*args)
        slow7[label] = int(kernels.SLOW["dp_scan_v1"])
        errs[label] = max_abs_err(got, OPT.dp_scan_v1_plain(*args))

    for label, levels in (("real", OPT.LEVELS),
                          ("real 38 slots", DP(level3=True).levels)):
        pd, cs, litq = OPT.edges_v1(data1, OPT.SEG - 3, maxd, lit, distq1,
                                    *seg_seeds, levels=levels)
        k7_vs_plain(label, pd, cs, litq, copyq1)
    n1, nb1 = OPT.SEG, OPT.SEG // B
    for kind, ns, sd in (("ties", 28, 1), ("ties", 38, 2), ("empty", 28, 3),
                         ("stubs", 28, 6), ("expensive", 28, 4),
                         ("block end", 38, 5), ("cost wrap", 28, 7),
                         ("mixed", 38, 8)):
        k7_vs_plain(f"{kind} {ns}", *(t(a) for a in v1_case(kind, ns, nb1,
                                                              sd)))
    pd, cs, litq = OPT.edges_v1(data1, OPT.SEG - 3, maxd, lit, distq1,
                                *seg_seeds)
    pay1 = kernels.dp_scan_v1(pd, cs, litq, copyq1)
    rows["K7"] = dict(
        name="dp_scan_v1", route="cuda",
        source="brotli_tpu_torch/csrc/dp_scan_v1.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:304",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.dp_scan_v1(pd, cs, litq, copyq1), 10),
        device_ms=cuda_ms(lambda: kernels.dp_scan_v1(pd, cs, litq, copyq1),
                          10, queued=True),
        plain_ms=cuda_ms(lambda: OPT.dp_scan_v1_plain(pd, cs, litq, copyq1),
                         1),
        # slots and literal costs read once, paymat written once; the
        # work this data needs: a sum and a compare-select for each
        # column a slot reaches, and the merge of every column
        nbytes=(pd.numel() + cs.numel() + litq.numel() + copyq1.numel()
                + pay1.numel()) * 4,
        nops=2 * int(((pd >> 25) - 1).clamp(min=0).sum()) + n1 * W * 2)
    print(f"[12] K7 dp_scan_v1 at n={n1}, {pd.shape[0]} slots: max_abs_err "
          f"{errs}; exact-path steps {slow7}", flush=True)
    if slow7["real"] or slow7["real 38 slots"] or \
            not slow7["expensive 28"] or not slow7["cost wrap 28"]:
        sys.exit(f"chip_smoke: K7's exact-path steps {slow7}: not 0 on the "
                 f"real segments, or 0 on expensive or cost wrap")
    del pd, cs, litq, pay1, data1, seg_seeds, lit
    torch.cuda.empty_cache()

    # -- K8 on the v3 path's first segment (its fast-first seed and
    # tables), the implicit-cell row off and on; K1 at 39 slots
    seg = arr[:OPT.SEG_V3]
    b = OPT._bucket_v3(len(seg))
    seed1 = OPT._seed_parse(seg, maxd, 0)
    tables = OPT._cost_tables(seg, seed1, lit_table=True, cfg=DP())
    dict_g = OPT._dict_probe_global(seg, [seed1], 0, maxd)
    bits_tab, ctx_tab, copyq, distq = OPT.device_tables(tables, dev)
    icell = t(tables[4].astype(np.int32))
    npos, *rest = OPT.segment_inputs(arr, [seed1], dict_g, 0, len(seg), b,
                                     dev)
    data = OPT.upload_input(arr, len(arr), dev)[:b]
    errs1 = {}
    pd, cs, _, _ = OPT.segment_tables(data, npos, maxd, bits_tab, ctx_tab,
                                      distq, *rest, 0,
                                      DP(level3=True).levels)
    errs1["real 39"] = max_abs_err(kernels.suffix_min(pd, cs, copyq),
                                   OPT.suffix_min_plain(pd, cs, copyq))
    del pd, cs
    spd, scs, scq = (t(a) for a in k1_case(39, b, 39))
    errs1["seeded 39"] = max_abs_err(kernels.suffix_min(spd, scs, scq),
                                     OPT.suffix_min_plain(spd, scs, scq))
    del spd, scs, scq
    pd, cs, litq, dist_fill = OPT.segment_tables(
        data, npos, maxd, bits_tab, ctx_tab, distq, *rest, 0)
    mp = kernels.suffix_min(pd, cs, copyq)
    del pd, cs
    ring_init = dist_fill.view(-1, B)[:, 0].contiguous()
    args8 = (mp, litq, data, ring_init, distq[:1], copyq)
    errs, slow8 = {}, {}

    def k8_vs_plain(label, *args):
        got = kernels.dp_scan_ring(*args)
        slow8[label] = int(kernels.SLOW["dp_scan_ring"])
        errs[label] = max_abs_err(got, OPT.dp_scan_ring_plain(*args))

    for label, ic in (("real", None), ("real icell", icell)):
        k8_vs_plain(label, *args8, ic, npos)
    nb3 = b // B
    for kind, use_icell in (("prev block", False), ("to start", True),
                            ("to start", False), ("npos cut", True),
                            ("wrap", False), ("literal run", False),
                            ("ring churn", True), ("column 1", False)):
        mp_s, lq_s, d_s, ri_s, rc_s, cq_s, ic_s, np_s = ring_case(kind, nb3, 7)
        k8_vs_plain(f"{kind}{' icell' if use_icell else ''}", t(mp_s),
                    t(lq_s), t(d_s), t(ri_s),
                    torch.tensor([rc_s], dtype=torch.int32, device=dev),
                    t(cq_s), t(ic_s) if use_icell else None, np_s)
        del mp_s
    pay8 = kernels.dp_scan_ring(*args8, None, npos)
    rows["K8"] = dict(
        name="dp_scan_ring", route="cuda",
        source="brotli_tpu_torch/csrc/dp_scan_ring.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:414",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.dp_scan_ring(*args8, None, npos), 10),
        device_ms=cuda_ms(lambda: kernels.dp_scan_ring(*args8, None, npos),
                          10, queued=True),
        plain_ms=cuda_ms(lambda: OPT.dp_scan_ring_plain(*args8, None, npos),
                         1),
        # K1's rows, the literal costs, the segment's bytes and the entry
        # rings read once, paymat written once; K3's merge per column
        # plus the ring edge's 16-byte compare a position
        nbytes=(mp.numel() + litq.numel() + ring_init.numel() + W
                + pay8.numel()) * 4 + data.numel(),
        nops=b * W * 4 + b * 16 * 2)
    rows["K1"]["max_abs_err"] = max(rows["K1"]["max_abs_err"],
                                    *errs1.values())
    print(f"[12] K1 suffix_min at 39 slots: max_abs_err {errs1}; K8 "
          f"dp_scan_ring at n={b}: max_abs_err {errs}; steps compared on "
          f"the chain {slow8}", flush=True)
    if slow8["real"] or slow8["real icell"] or not slow8["column 1"]:
        sys.exit(f"chip_smoke: K8's chain compares {slow8}: not 0 on the "
                 f"real segment, or 0 where column 1 takes rows")
    del mp, litq, data, args8, pay8, ring_init, icell
    torch.cuda.empty_cache()
    for k in ("K7", "K8"):
        r = rows[k]
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("nops"))
        print(f"    {k} {r['name']}: kernel {r['ms']:.3f} ms one call (the "
              f"card alone {r['device_ms']:.3f} ms), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]", flush=True)
    bad = [k for k in ("K1", "K7", "K8") if rows[k]["max_abs_err"] != 0]
    if bad:
        sys.exit(f"chip_smoke: kernels disagree with their plain versions: "
                 f"{bad}")

    # -- v1 and the ring scan at full width
    print("[12] q11, api.compress(dp=DPConfig(mode='v1'))", flush=True)
    v1 = DP(mode="v1")
    launches_v1, _ = three_runs(
        lambda: bt.compress(corpus, quality=11, dp=v1), trace, kernels,
        "q11 v1", corpus, bt.decompress, card)
    nseg1 = -(-len(corpus) // OPT.SEG)
    want1 = dict(dp_launches(nseg1, "dp_scan_v1"), suffix_min=0, dp_scan=0)
    if any(launches_v1[k] != v for k, v in want1.items()):
        sys.exit(f"chip_smoke: the v1 path launched {launches_v1}, not "
                 f"{want1}")
    ring = DP(ring_scan=True)
    kernels.reset_launches()
    out, wall = timed(lambda: bt.compress(corpus, quality=11, dp=ring))
    launches_ring = dict(kernels.LAUNCHES)
    print(f"[12] q11 ring_scan: {len(corpus)} B -> {len(out)} B in {wall:.3f} "
          f"s = {len(corpus) / wall / 1e6:.3f} MB/s [{card}]; launches "
          f"{launches_ring}", flush=True)
    nseg3 = -(-len(corpus) // OPT.SEG_V3)
    if launches_ring["dp_scan_ring"] != nseg3 or launches_ring["dp_scan"]:
        sys.exit(f"chip_smoke: the ring path launched {launches_ring}, not "
                 f"K8 {nseg3} times and K3 never")
    if bt.decompress(out) != corpus:
        sys.exit("chip_smoke: the ring_scan stream does not decode back")

    # -- the same bytes on the card and on the CPU
    prefix = corpus[:512 << 10]
    for label, cfg in (("v1", v1), ("ring_scan", ring),
                       ("ring_scan + icell", DP(ring_scan=True, icell=True))):
        on_card = bt.compress(prefix, quality=11, dp=cfg)
        t0 = time.perf_counter()
        on_cpu = bt.compress(prefix, quality=11, dp=cfg, device="cpu")
        print(f"[12] {label}, 512 KiB prefix: cuda {len(on_card)} B, cpu "
              f"{len(on_cpu)} B (cpu path {time.perf_counter() - t0:.1f} s)",
              flush=True)
        if on_card != on_cpu or bt.decompress(on_card) != prefix:
            sys.exit(f"chip_smoke: {label} cuda and cpu streams differ")

    # -- the other variants on a prefix of two v3 segments (fast_first
    # acts only beyond one)
    part = corpus[:OPT.SEG_V3 + (OPT.SEG_V3 >> 1)]
    for label, cfg in (("default", DP()), ("level3", DP(level3=True)),
                       ("iterations=2", DP(iterations=2)),
                       ("fast_first=False", DP(fast_first=False)),
                       ("cost_sample=1 MiB", DP(cost_sample=1 << 20)),
                       ("lit_surcharge=1.3", DP(lit_surcharge=1.3)),
                       ("ins_scale=0.7", DP(ins_scale=0.7)),
                       ("cmd_extra=1.5", DP(cmd_extra=1.5)),
                       ("seed_q=7", DP(seed_q=7))):
        kernels.reset_launches()
        out, wall = timed(lambda: bt.compress(part, quality=11, dp=cfg))
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        print(f"    {label}: {len(part)} B -> {len(out)} B in {wall:.3f} s "
              f"[{card}]; launches {launched}", flush=True)
        if bt.decompress(out) != part:
            sys.exit(f"chip_smoke: the {label} stream does not decode back")

    # -- v1 with two shards: the second shard's seed runs K2
    part = corpus[:8 << 20]
    kernels.reset_launches()
    out, wall = timed(lambda: compress_sharded(part, quality=11, n_shards=2,
                                               dp=v1))
    launched = dict(kernels.LAUNCHES)
    print(f"[12] q11 v1, two shards: {len(part)} B -> {len(out)} B in "
          f"{wall:.3f} s [{card}]; launches {launched}", flush=True)
    if bt.decompress(out) != part or not launched["chain_select"] or \
            not launched["dp_scan_v1"]:
        sys.exit("chip_smoke: the two-shard v1 stream does not decode, or "
                 "K2 or K7 did not launch")
    return launches_v1, launches_ring


def seam_matches(shard_matches):
    """Matches (not dictionary words) whose source lies before the start
    of their shard: the halo's work."""
    return sum(int(((m < d) & (f < 2)).sum())
               for m, _, d, f in shard_matches[1:])


def mesh_and_processes(corpus, q5_out, card, dev=torch.device("cuda")):
    """Phase 13: the mesh's code on one card (a device list naming it
    once per shard), the collective gather, and the multi-process
    encoder in four processes on the card. Returns nothing; exits on
    any failure."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch.format import constants as C
    from brotli_tpu_torch.ops import kernels, optimal as OPT
    from brotli_tpu_torch.ops import matcher as PM
    from brotli_tpu_torch.parallel import shard as PS
    from brotli_tpu_torch.tools import mp_compress
    from brotli_tpu_torch.utils import trace

    maxd = C.max_backward_distance(22)
    cpu = torch.device("cpu")
    n = len(corpus)
    arr = np.frombuffer(corpus, np.uint8)

    # -- q5 on the mesh, 8 shards (as bench.py:140-146 shards)
    print("[13] q5 on the mesh: 8 shards over [cuda:0] * 8", flush=True)
    bounds = np.linspace(0, n, 9).astype(np.int64)
    kernels.reset_launches()
    mesh5, wall = timed(lambda: PS._compress_sharded(corpus, 5, 22, 8, dev,
                                                     [dev] * 8))
    k2 = kernels.LAUNCHES["chain_select"]
    seams = seam_matches(PS._find_matches_mesh(arr, bounds, maxd, 5,
                                               [dev] * 8))
    print(f"    mesh: {n} B -> {len(mesh5)} B (ratio {n / len(mesh5):.4f}) "
          f"in {wall:.3f} s = {n / wall / 1e6:.3f} MB/s [{card}]; K2 "
          f"launches {k2}; matches reaching before their shard {seams}",
          flush=True)
    if bt.decompress(mesh5) != corpus or k2 != 8 or seams <= 0:
        sys.exit("chip_smoke: the q5 mesh stream does not decode, K2 did "
                 "not launch once a shard, or no match crossed a seam")
    kernels.reset_launches()
    one5, wall = timed(lambda: PS.compress_sharded(corpus, quality=5,
                                                   n_shards=8))
    k2 = kernels.LAUNCHES["chain_select"]
    seams = seam_matches(PS._find_matches_sharded(arr, bounds, maxd, 5,
                                                  dev))
    print(f"    one card, n_shards=8: {n} B -> {len(one5)} B (ratio "
          f"{n / len(one5):.4f}) in {wall:.3f} s = {n / wall / 1e6:.3f} "
          f"MB/s [{card}]; K2 launches {k2}; matches reaching before "
          f"their shard {seams} (each shard starts from its own first "
          f"byte)", flush=True)
    if bt.decompress(one5) != corpus or seams:
        sys.exit("chip_smoke: the one-card 8-shard stream does not decode, "
                 "or a match reached before its shard")
    prefix = corpus[:1 << 20]
    on_card = PS._compress_sharded(prefix, 5, 22, 8, dev, [dev] * 8)
    t0 = time.perf_counter()
    on_cpu = PS._compress_sharded(prefix, 5, 22, 8, cpu, [cpu] * 8)
    print(f"    1 MiB prefix, 8 shards: cuda {len(on_card)} B, cpu "
          f"{len(on_cpu)} B (cpu path {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: q5 mesh cuda and cpu streams differ")

    # -- q11 on the mesh, 4 shards, the default DP and the ring scan
    bounds = np.linspace(0, n, 5).astype(np.int64)
    bufs = [int(bounds[i + 1] - bounds[i]) +
            min(maxd, int(bounds[i]), OPT.SEG_V3) for i in range(4)]
    rounds = max(-(-b // OPT.SEG_V3) for b in bufs)
    # a shard out of segments runs none (the JAX mesh runs a zero one)
    nseg = sum(-(-b // OPT.SEG_V3) for b in bufs)
    adv = [PM.SEG_BYTES // 2 if b > PM.SEG_BYTES else PM.SEG_BYTES
           for b in bufs]
    want_k2 = sum(-(-b // a) for b, a in zip(bufs[1:], adv[1:]))
    for label, cfg, scan in (("default", OPT.DPConfig(), "dp_scan"),
                             ("ring_scan", OPT.DPConfig(ring_scan=True),
                              "dp_scan_ring")):
        print(f"[13] q11 on the mesh ({label}): 4 shards over [cuda:0] * 4",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        # the default run is traced: its stages (summed over the shards'
        # threads) say where the wall goes
        trace.enable(label == "default")
        trace.reset()
        out, wall = timed(lambda: PS._compress_sharded(
            corpus, 11, 22, 4, dev, [dev] * 4, dp=cfg))
        trace.enable(False)
        launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        print(f"    {n} B -> {len(out)} B (ratio {n / len(out):.4f}) in "
              f"{wall:.3f} s = {n / wall / 1e6:.3f} MB/s [{card}]; peak "
              f"device memory {peak / 2**30:.2f} GiB; launches {launched} "
              f"({rounds} rounds of 4 shards, {nseg} segments; K2 "
              f"expected {want_k2})",
              flush=True)
        if label == "default":
            print("    stages of this (traced) run:")
            print(stage_table(trace.report()), flush=True)
        if bt.decompress(out) != corpus:
            sys.exit(f"chip_smoke: the q11 mesh ({label}) stream does not "
                     f"decode")
        if launched != dict(dp_launches(nseg, scan, probes=4),
                            chain_select=want_k2):
            sys.exit(f"chip_smoke: the q11 mesh ({label}) launched "
                     f"{launched}")
    # the card against the CPU, on 256 KiB in 4 shards with 128 KiB DP
    # segments in both (the real 2 MiB bucket would take minutes on the
    # host): the last two shards' halos reach the segment cap, so there
    # are two rounds, the second with segments of those two shards only
    prefix = corpus[:256 << 10]
    for label, cfg in (("default", OPT.DPConfig()),
                       ("ring_scan", OPT.DPConfig(ring_scan=True))):
        on_card = PS._compress_sharded(prefix, 11, 22, 4, dev, [dev] * 4,
                                       dp=cfg, seg=1 << 17)
        t0 = time.perf_counter()
        on_cpu = PS._compress_sharded(prefix, 11, 22, 4, cpu, [cpu] * 4,
                                      dp=cfg, seg=1 << 17)
        print(f"    {label}, 256 KiB prefix, 4 shards, 128 KiB "
              f"segments: cuda {len(on_card)} B, cpu {len(on_cpu)} B "
              f"(cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
        if on_card != on_cpu or bt.decompress(on_card) != prefix:
            sys.exit(f"chip_smoke: q11 mesh ({label}) cuda and cpu "
                     f"streams differ")

    # -- the collective gather: one card, so phase 6's bytes
    coll = PS.compress_sharded(corpus, quality=5, gather="collective")
    print(f"[13] gather='collective': {len(coll)} B, phase 6 "
          f"{len(q5_out)} B", flush=True)
    if coll != q5_out:
        sys.exit("chip_smoke: the collective gather changed the stream")
    # one card has no mesh to gather over, so the route above joins; the
    # gather's tensor copies themselves, on the card, over the q5 mesh
    # stream cut into 8 payloads of unequal length
    cuts = np.sort(np.random.default_rng(13).choice(
        np.arange(1, len(mesh5)), 7, replace=False))
    parts = [mesh5[a:b] for a, b in zip([0, *cuts], [*cuts, len(mesh5)])]
    gathered = PS._all_gather_join(parts, [dev] * 8)
    print(f"    the gather's copies on the card, 8 payloads of "
          f"{min(map(len, parts))}-{max(map(len, parts))} B: "
          f"{'equal to' if gathered == mesh5 else 'NOT'} their join",
          flush=True)
    if gathered != mesh5:
        sys.exit("chip_smoke: the gather's copies changed the payloads")

    # -- four processes on the card, one shard each
    print("[13] compress_sharded_mp: 4 processes, devices=[cuda:0] each",
          flush=True)
    ref = PS._compress_sharded(corpus, 5, 22, 4, dev, [dev] * 4)
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "corpus"
        src.write_bytes(corpus)
        t0 = time.perf_counter()
        mp_out = mp_compress.run(4, ["cuda:0"], src, pathlib.Path(tmp) / "out",
                                 timeout=300)
        wall = time.perf_counter() - t0
    print(f"    {n} B -> {len(mp_out)} B in {wall:.3f} s (process start "
          f"included) [{card}]; every rank the same stream; the "
          f"single-process mesh over [cuda:0] * 4: {len(ref)} B", flush=True)
    if mp_out != ref or bt.decompress(mp_out) != corpus:
        sys.exit("chip_smoke: the four processes' stream differs from the "
                 "single-process mesh, or does not decode")


def segments(n, seg, adv):
    """The segments a finder cuts `n` bytes into: `adv` apart once `n`
    exceeds `seg` (the matcher's window history), else one."""
    return len(range(0, n, adv if n > seg else seg))


def launched(label, fn, want):
    """(result, seconds, launches) of fn(), exiting unless its kernel
    launches are exactly `want` (kernels launched no time left out)."""
    from brotli_tpu_torch.ops import kernels
    kernels.reset_launches()
    out, wall = timed(fn)
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if got != want:
        sys.exit(f"chip_smoke: {label} launched {got}, not {want}")
    return out, wall, got


def python_serializer_and_decoder(corpus, q5_out, q11_4mib, card,
                                  dev=torch.device("cuda")):
    """Phase 14: the routes of the Python serializer (encoder="device"
    at q5 and at q11 in mode 1, compress_sharded(serializer="python"))
    and of the Python decoder (decoder="python", Decompressor, the
    deferred parse resolved by K5) on `dev`."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch import native
    from brotli_tpu_torch.dec.decoder import Decoder
    from brotli_tpu_torch.ops import kernels, lz_resolve as LZ
    from brotli_tpu_torch.ops import matcher as PM, optimal as OPT
    from brotli_tpu_torch.parallel.shard import compress_sharded
    from brotli_tpu_torch.utils import trace

    t_phase = time.perf_counter()
    print("[14] the Python serializer and decoder", flush=True)

    # q5 through the device matcher and the Python serializer: K2 once
    # per matcher segment (4 on the 16 MiB corpus)
    def q5_dev():
        return bt.compress(corpus, quality=5, encoder="device", device=dev)

    k2 = {"chain_select": segments(len(corpus), PM.SEG_BYTES,
                                   PM.SEG_BYTES // 2)}
    out, wall, got = launched("compress(q5, encoder='device')", q5_dev, k2)
    print(f"    compress q5, encoder='device': {len(corpus)} B -> "
          f"{len(out)} B in {wall:.3f} s = {len(corpus) / wall / 1e6:.3f} "
          f"MB/s [{card}]; launches {got}", flush=True)
    trace.enable()
    trace.reset()
    again, traced = timed(q5_dev)
    trace.enable(False)
    print(f"    traced run {traced:.3f} s; its match.* and serialize "
          f"stages:", flush=True)
    for k, (calls, sec) in sorted(trace.report().items()):
        if k.startswith("match") or k == "serialize":
            print(f"      {k}: {calls} calls, {sec * 1e3:.1f} ms")
    if again != out or bt.decompress(out) != corpus:
        sys.exit("chip_smoke: the q5 encoder='device' stream differs "
                 "between runs or does not decode")
    prefix = corpus[:1 << 20]
    on_card = bt.compress(prefix, quality=5, encoder="device", device=dev)
    on_cpu = bt.compress(prefix, quality=5, encoder="device", device="cpu")
    print(f"    q5 encoder='device', 1 MiB prefix: {dev.type} "
          f"{len(on_card)} B, cpu {len(on_cpu)} B", flush=True)
    if on_card != on_cpu:
        sys.exit("chip_smoke: q5 encoder='device' differs on the CPU")

    # q11 in mode 1 through the device DP and the Python serializer: K1,
    # K3 and K4 once per DP segment (one 4 MiB segment)
    part = corpus[:4 << 20]
    nseg = segments(len(part), OPT.SEG_V3, OPT.SEG_V3)
    out11, wall, got = launched(
        "compress(q11, mode 1, encoder='device')",
        lambda: bt.compress(part, mode=1, quality=11, encoder="device",
                            device=dev),
        dp_launches(nseg, probes=1))
    print(f"    compress q11 mode 1, encoder='device', 4 MiB: {len(part)} "
          f"B -> {len(out11)} B in {wall:.3f} s = "
          f"{len(part) / wall / 1e6:.3f} MB/s [{card}]; launches {got}; "
          f"mode 0 on the card (phase 11) {len(q11_4mib)} B", flush=True)
    if bt.decompress(out11) != part:
        sys.exit("chip_smoke: the q11 mode-1 stream does not decode")
    prefix = corpus[:512 << 10]
    on_card = bt.compress(prefix, mode=1, quality=11, encoder="device",
                          device=dev)
    on_cpu = bt.compress(prefix, mode=1, quality=11, encoder="device",
                         device="cpu")
    print(f"    q11 mode 1, 512 KiB prefix: {dev.type} {len(on_card)} B, "
          f"cpu {len(on_cpu)} B", flush=True)
    if on_card != on_cpu:
        sys.exit("chip_smoke: q11 mode 1 differs on the CPU")

    # compress_sharded through the Python serializer
    sh, wall, got = launched(
        "compress_sharded(q5, serializer='python')",
        lambda: compress_sharded(corpus, quality=5, serializer="python",
                                 device=dev), k2)
    print(f"    compress_sharded q5, serializer='python': {len(sh)} B in "
          f"{wall:.3f} s [{card}]; launches {got}; the native serializer "
          f"(phase 6) {len(q5_out)} B", flush=True)
    if bt.decompress(sh) != corpus:
        sys.exit("chip_smoke: the serializer='python' stream does not "
                 "decode")
    # one shard, the same parse split at the same 4 MiB metablocks, the
    # same serializer: encoder="device"'s bytes
    if sh != out:
        sys.exit("chip_smoke: one shard through the Python serializer "
                 "differs from encoder='device'")

    # the Python decoder on a 1 MiB q5 stream of the device route
    one = corpus[:1 << 20]
    s5 = bt.compress(one, quality=5, encoder="device", device=dev)
    back, wall_py = timed(lambda: bt.decompress(s5, decoder="python"))
    _, wall_nat = timed(lambda: bt.decompress(s5))
    if back != one or back != bt.decompress(s5):
        sys.exit("chip_smoke: the Python decoder differs from the native")

    def stream_in_pieces():
        # the Python core decodes on a worker thread: with all input fed,
        # process(b"") waits for it, and returns nothing only when the
        # stream ends short
        d = bt.Decompressor(decoder="python")
        got, pos, calls = [], 0, 0
        while not d.is_finished():
            piece = b""
            if d.can_accept_more_data() and pos < len(s5):
                piece = s5[pos:pos + (64 << 10)]
                pos += len(piece)
            got.append(d.process(piece, output_buffer_limit=64 << 10))
            calls += 1
            if len(got[-1]) > 64 << 10:
                sys.exit("chip_smoke: Decompressor exceeded its limit")
            if (pos == len(s5) and not piece and not got[-1]
                    and not d.is_finished()):
                sys.exit("chip_smoke: Decompressor did not finish")
        return b"".join(got), calls

    (streamed, calls), wall_st = timed(stream_in_pieces)
    print(f"    Python decoder, 1 MiB q5 stream ({len(s5)} B): decompress "
          f"{wall_py:.3f} s, Decompressor in 64 KiB pieces at a 64 KiB "
          f"limit {wall_st:.3f} s ({calls} calls), native {wall_nat:.3f} s",
          flush=True)
    if streamed != one:
        sys.exit("chip_smoke: Decompressor(decoder='python') differs")

    # the deferred parse of phase 11's 4 MiB q11 stream, resolved by K5
    def deferred():
        d = Decoder()
        d.defer_lz = {"lits": bytearray(), "nlit": [], "ncopy": [],
                      "dist": []}
        d.decompress(q11_4mib)
        return d.defer_lz

    g, wall_dz = timed(deferred)
    lits, cn, cc, cd, _ = native.parse_stream(q11_4mib)
    if (bytes(g["lits"]) != lits
            or not np.array_equal(LZ.copy_list(g["nlit"], g["ncopy"],
                                               g["dist"]),
                                  LZ.copy_list(cn, cc, cd))):
        sys.exit("chip_smoke: the deferred parse's graph is not the "
                 "native parse's")
    resolved, _, got = launched(
        "the resolve of the deferred parse",
        lambda: LZ.resolve(bytes(g["lits"]), g["nlit"], g["ncopy"],
                           g["dist"], device=dev), {"lz_resolve": 1})
    if resolved != part:
        sys.exit("chip_smoke: K5 resolved the deferred parse wrong")
    nl, nc, nd = (torch.tensor(g[k], dtype=torch.int32, device=dev)
                  for k in ("nlit", "ncopy", "dist"))
    la = torch.from_numpy(np.frombuffer(bytes(g["lits"]), np.uint8)
                          .copy()).to(dev)
    n_out = len(part)
    steps = LZ.n_steps_for(n_out)
    k5, flag = kernels.lz_resolve(la, nl, nc, nd, n_out, steps)
    err5 = max_abs_err(k5, LZ.resolve_plain(la, nl, nc, nd, n_out, steps)) \
        + int(flag.item())
    print(f"    deferred parse of the q11 4 MiB stream: {len(g['nlit'])} "
          f"commands ({len(cn)} native), {len(lits)} literals, "
          f"{wall_dz:.3f} s; K5 launches {got}, max_abs_err against its "
          f"plain version {err5}", flush=True)
    if err5:
        sys.exit("chip_smoke: K5 disagrees with its plain version on the "
                 "deferred parse")
    print(f"    phase 14 wall: {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def fed(enc, data, piece):
    """`data` through a streaming encoder in `piece`-byte pieces, each
    flushed: (stream, [(flushed prefix, the input it holds)])."""
    out, prefixes = b"", []
    for lo in range(0, len(data), piece):
        out += enc.process(data[lo:lo + piece]) + enc.flush()
        prefixes.append((out, data[:lo + piece]))
    return out + enc.finish(), prefixes


def host_pipeline_routes(corpus, card, dev=torch.device("cuda"),
                         mib=1 << 20):
    """Phase 15: the routes of the Python pipeline on `dev` (the host
    matchers, the host DP, base64 mode, serialized dictionaries):
    Compressor in modes 1 and 2, a raw dictionary, base64 mode, a
    serialized dictionary with custom words, and backend="numpy"; each
    with its exact launches, its wall and its stream decoded. `mib`
    scales every size (a smaller one rehearses the phase on the CPU);
    the corpus holds at least 8 of them."""
    import brotli_tpu_torch as bt
    from brotli_tpu_torch.enc.encoder import StreamingEncoder
    from brotli_tpu_torch.format import shared_dictionary as shd
    from brotli_tpu_torch.ops import matcher as PM, optimal as OPT
    from brotli_tpu_torch.parallel.shard import compress_sharded
    from brotli_tpu_torch.tools.corpus import base64_page, custom_dictionary

    t_phase = time.perf_counter()
    print("[15] the host pipeline's routes on the card", flush=True)
    part = corpus[:4 * mib]

    def check_flushed(label, got, data):
        out, prefixes = got
        for prefix, held in prefixes:  # each flushed prefix on its own
            if bt.decompress(prefix + b"\x03") != held:
                sys.exit(f"chip_smoke: a flushed prefix of {label} does "
                         f"not decode")
        if bt.decompress(out) != data:
            sys.exit(f"chip_smoke: {label} does not decode")

    # Compressor at q11 in mode 1, 1 MiB pieces: each flush runs the
    # device DP over the window's history and the buffer (1, 2, 3, 4 MiB,
    # one v3 segment each), then the Python serializer on the new MiB
    nseg = sum(segments(k * mib, OPT.SEG_V3, OPT.SEG_V3)
               for k in (1, 2, 3, 4))
    got, wall, launches = launched(
        "Compressor(q11, mode 1)",
        lambda: fed(bt.Compressor(quality=11, mode=1, device=dev), part,
                    mib),
        dp_launches(nseg, probes=4))
    check_flushed("Compressor(q11, mode 1)", got, part)
    print(f"    Compressor q11 mode 1, {len(part)} B in {mib} B pieces, "
          f"flushed: "
          f"{len(got[0])} B in {wall:.3f} s [{card}]; launches {launches}",
          flush=True)
    prefix = corpus[:mib // 2]
    small = [fed(bt.Compressor(quality=11, mode=1, device=d), prefix,
                 mib // 4)[0] for d in (dev, "cpu")]
    print(f"    the same on {mib // 2} B in {mib // 4} B pieces: "
          f"{dev.type} {len(small[0])} B, cpu {len(small[1])} B", flush=True)
    if small[0] != small[1] or bt.decompress(small[0]) != prefix:
        sys.exit("chip_smoke: Compressor(q11, mode 1) differs on the CPU")

    # StreamingEncoder at q5 in mode 2: the device matcher (K2 once a
    # flush: each buffer is one matcher segment)
    def matcher_segments(n):
        return segments(n, PM.SEG_BYTES, PM.SEG_BYTES // 2)

    k2 = sum(matcher_segments(k * mib) for k in (1, 2, 3, 4))
    got, wall, launches = launched(
        "StreamingEncoder(q5, mode 2)",
        lambda: fed(StreamingEncoder(quality=5, mode=2, device=dev), part,
                    mib), {"chain_select": k2})
    check_flushed("StreamingEncoder(q5, mode 2)", got, part)
    print(f"    StreamingEncoder q5 mode 2, {len(part)} B in {mib} B "
          f"pieces: {len(got[0])} B in {wall:.3f} s [{card}]; launches "
          f"{launches}", flush=True)
    prefix = corpus[:mib]
    small = [fed(StreamingEncoder(quality=5, mode=2, device=d), prefix,
                 mib // 2)[0] for d in (dev, "cpu")]
    print(f"    the same on {mib} B in {mib // 2} B pieces: {dev.type} "
          f"{len(small[0])} B, cpu {len(small[1])} B", flush=True)
    if small[0] != small[1]:
        sys.exit("chip_smoke: StreamingEncoder(q5, mode 2) differs on the "
                 "CPU")

    # a raw 64 KiB dictionary through encoder="device": the device
    # matcher over the dictionary and the input, the lift into compound
    # references
    data = corpus[4 * mib:5 * mib]
    raw = corpus[:mib // 16]
    out, wall, launches = launched(
        "compress(q5, encoder='device', dictionary)",
        lambda: bt.compress(data, quality=5, encoder="device",
                            dictionary=raw, device=dev),
        {"chain_select": matcher_segments(len(raw) + len(data))})
    if bt.decompress(out, dictionary=raw) != data:
        sys.exit("chip_smoke: the raw-dictionary stream does not decode")
    print(f"    compress q5 encoder='device', {len(data)} B with a "
          f"{len(raw)} B raw dictionary: {len(out)} B in {wall:.3f} s "
          f"[{card}]; launches {launches}", flush=True)

    # base64 mode on a page of inline images made from the corpus
    page = base64_page(corpus, mib + (mib >> 2))
    out, wall, launches = launched(
        "compress(q5, base64_mode)",
        lambda: bt.compress(page, quality=5, base64_mode=True,
                            encoder="device", device=dev),
        {"chain_select": matcher_segments(len(page))})
    if bt.decompress(out) != page:
        sys.exit("chip_smoke: the base64-mode stream does not decode")
    print(f"    compress q5 base64_mode, {len(page)} B page with "
          f"{page.count(b';base64,')} inline images: {len(out)} B in "
          f"{wall:.3f} s [{card}]; launches {launches}", flush=True)

    # a serialized shared dictionary: a prefix and a custom word list
    # that tools/dictgen draws from the corpus
    blob = custom_dictionary(corpus[6 * mib:6 * mib + (64 << 10)])
    sd = shd.parse(blob)
    data = corpus[5 * mib:6 * mib]
    out, wall, launches = launched(
        "compress(q5, serialized dictionary)",
        lambda: bt.compress(data, quality=5, dictionary=blob, device=dev),
        {"chain_select": matcher_segments(len(sd.prefixes[0]) + len(data))})
    back, wall_dec = timed(lambda: bt.decompress(out, dictionary=blob))
    try:  # with the prefix alone, the custom words decode to other bytes
        other = bt.decompress(out, dictionary=sd.prefixes[0])
    except bt.error:
        other = None
    if back != data or other == data:
        sys.exit("chip_smoke: the serialized-dictionary stream does not "
                 "decode, or used no custom word")
    print(f"    compress q5, {len(data)} B with a serialized dictionary "
          f"({len(sd.prefixes[0])} B prefix, "
          f"{len(sd.word_lists[0].data) // 8} custom words): {len(out)} B "
          f"in {wall:.3f} s, the Python decoder {wall_dec:.3f} s [{card}]; "
          f"launches {launches}", flush=True)

    # backend="numpy": the host matchers and the host DP, no kernel
    host = corpus[7 * mib:8 * mib]
    for label, fn, data in (
            ("encoder='python' q11 (the host DP)",
             lambda: bt.compress(host[:mib // 4], quality=11,
                                 encoder="python", backend="numpy"),
             host[:mib // 4]),
            ("encoder='python' q5 (the host vectorized matcher)",
             lambda: bt.compress(host[:mib], quality=5, encoder="python",
                                 backend="numpy"), host[:mib]),
            ("compress_sharded(q5, use_device=False)",
             lambda: compress_sharded(host[:mib], quality=5,
                                      use_device=False), host[:mib])):
        out, wall, _ = launched(label, fn, {})
        if bt.decompress(out) != data:
            sys.exit(f"chip_smoke: {label} does not decode")
        print(f"    backend='numpy', {label}: {len(data)} B -> {len(out)} "
              f"B in {wall:.3f} s [{card}]; no launch", flush=True)
    print(f"    phase 15 wall: {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def last_slice(corpus, card, dev=torch.device("cuda"), trials=STRESS_TRIALS):
    """Phase 16: the stress fuzzer over every route on `dev`, the
    dissector and parse replay on 1 MiB, and the entry module with its
    dry run held against the CPU (run in a process of its own, started
    first and stopped on any exit). Returns nothing; exits on any
    failure."""
    t_phase = time.perf_counter()
    # the dry run's CPU side, in its own process while the card works
    with tempfile.TemporaryDirectory() as tmp:
        cpu_run = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CPU, tmp],
            cwd=pathlib.Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            _last_slice(corpus, card, dev, trials, cpu_run, tmp)
        finally:
            if cpu_run.poll() is None:
                cpu_run.kill()
            cpu_run.wait()
    print(f"    phase 16 wall: {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def _last_slice(corpus, card, dev, trials, cpu_run, tmp):
    from brotli_tpu_torch import entry, native
    from brotli_tpu_torch.ops import kernels
    from brotli_tpu_torch.tools import dissect, replay, stress

    print(f"[16] the last slice: tools/stress, {trials} trials from seed "
          f"{STRESS_SEED}; the dry run's CPU side started in pid "
          f"{cpu_run.pid}", flush=True)
    kernels.reset_launches()
    failures, wall = timed(lambda: stress.run(
        stress.trials(STRESS_SEED, trials), dev))
    launches = dict(kernels.LAUNCHES)
    print(f"    stress: {trials} trials in {wall:.3f} s [{card}]; "
          f"{len(failures)} failures; launches {launches}", flush=True)
    if failures:
        sys.exit(f"chip_smoke: the stress failed {len(failures)} trials")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        sys.exit(f"chip_smoke: the stress launched no {missing}")

    # the dissector and parse replay over 1 MiB of the corpus's text
    part = corpus[1 << 20:2 << 20]
    for q in (5, 11):
        blob, wall_enc = timed(lambda: native.encode(part, q, 22))
        text = io.StringIO()
        back, wall_dis = timed(lambda: dissect.dissect(blob, out=text))
        if back != part:
            sys.exit(f"chip_smoke: dissect of the q{q} stream decoded other "
                     f"bytes")
        print(f"    dissect, native q{q} stream ({wall_enc:.3f} s to encode, "
              f"{wall_dis:.3f} s to dissect):", flush=True)
        for line in text.getvalue().splitlines():
            print(f"      {line}")
        rb, wall_rep = timed(lambda: replay.replay(part, blob, q, 22))
        if native.decode(rb) != part:
            sys.exit(f"chip_smoke: the q{q} replay does not decode")
        print(f"    replay q{q}: stream {len(blob)} B, replay (its parse, "
              f"the native serializer) {len(rb)} B in {wall_rep:.3f} s",
              flush=True)

    # the entry: match_block on the JAX entry's block, card and CPU
    fn, args = entry.entry(dev)
    kernels.reset_launches()
    (count, packed, err), _ = timed(lambda: fn(*args))
    k2 = kernels.LAUNCHES["chain_select"]
    cfn, cargs = entry.entry("cpu")
    ccount, cpacked, cerr = cfn(*cargs)
    same = (int(count) == int(ccount) and int(err) == int(cerr) == 0
            and torch.equal(packed.cpu(), cpacked))
    print(f"    entry: {int(count)} matches, packed {tuple(packed.shape)}; "
          f"K2 launches {k2}; cuda {'=' if same else '!='} cpu", flush=True)
    if not same or k2 != 1:
        sys.exit("chip_smoke: the entry differs from the CPU, or K2 did "
                 "not launch once")

    # the dry run over [cuda:0] * 8, then on the CPU
    n = 8
    n11 = n * entry.BLOCK + (1 << 14)
    bounds = np.linspace(0, n11, n + 1).astype(np.int64)
    nseg = sum(-(-(int(bounds[i + 1] - bounds[i]) +
                   min(int(bounds[i]), entry.BLOCK)) // entry.BLOCK)
               for i in range(n))
    # K2: a block a device, a q5 shard, a q11 seed after the first shard
    # (each buffer one matcher segment)
    want = dict(dp_launches(nseg, probes=n), chain_select=3 * n - 1)
    print(f"[16] entry.dryrun_multichip({n}) over [cuda:0] * {n}",
          flush=True)
    kernels.reset_launches()
    on_card, wall = timed(lambda: entry.dryrun_multichip(n, dev))
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    log, _ = cpu_run.communicate(timeout=600)
    print(f"    the CPU side (pid {cpu_run.pid}, exit {cpu_run.returncode}"
          f", waited {time.perf_counter() - t0:.1f} s more):", flush=True)
    for line in log.splitlines():
        print(f"      {line}")
    if cpu_run.returncode != 0:
        sys.exit("chip_smoke: the dry run failed on the CPU")
    d = pathlib.Path(tmp)
    matches, hist_total = json.loads((d / "numbers.json").read_text())
    on_cpu = {"matches": matches, "hist_total": hist_total,
              "q5": (d / "q5").read_bytes(), "q11": (d / "q11").read_bytes()}
    print(f"    card {wall:.3f} s [{card}], launches {got}; matches "
          f"{on_card['matches']} / {on_cpu['matches']}, hist total "
          f"{on_card['hist_total']} / {on_cpu['hist_total']}, q5 "
          f"{len(on_card['q5'])} / {len(on_cpu['q5'])} B, q11 "
          f"{len(on_card['q11'])} / {len(on_cpu['q11'])} B (card / cpu)",
          flush=True)
    if on_card != on_cpu:
        sys.exit("chip_smoke: the dry run on the card differs from the CPU")
    if got != want:
        sys.exit(f"chip_smoke: the dry run launched {got}, not {want}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    import brotli_tpu_torch as bt
    from brotli_tpu_torch import native
    from brotli_tpu_torch.format import constants as C
    from brotli_tpu_torch.ops import chain, kernels, optimal as OPT
    from brotli_tpu_torch.ops import matcher as PM
    from brotli_tpu_torch.parallel.shard import compress_sharded
    from brotli_tpu_torch.tools.corpus import build_corpus
    from brotli_tpu_torch.utils import trace

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    native_err = []

    def build_native():
        try:
            native.build()
        except BaseException as e:  # re-raised below
            native_err.append(e)
    th = threading.Thread(target=build_native)
    th.start()
    logs = kernels.build(extra_flags=["-Xptxas", "-v"])
    th.join()
    if native_err:
        raise native_err[0]
    print(f"[2] build: kernels + native library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    # -- 3. kernels against their plain versions, first 4 MiB segment ---
    corpus = build_corpus()
    arr = np.frombuffer(corpus, np.uint8)
    maxd = C.max_backward_distance(22)
    seg = arr[:OPT.SEG_V3]
    b = OPT._bucket_v3(len(seg))
    rows = {}
    seg_ops = edge_kernels(arr, seg, maxd, rows, dev, card)
    torch.cuda.empty_cache()
    edge_ranks_halo(arr, rows, dev, card)
    torch.cuda.empty_cache()
    dict_probe_check(arr, maxd, rows, dev, card)
    seed = OPT._seed_parse(seg, maxd, 0)
    tables = OPT._cost_tables(seg, seed, lit_table=True, cfg=OPT.DPConfig())
    dict_g = OPT._dict_probe_global(seg, [seed], 0, maxd)
    bits_tab, ctx_tab, copyq, distq = OPT.device_tables(tables, dev)
    npos, spos, slen, sdist, dloc, dval = OPT.segment_inputs(
        arr, [seed], dict_g, 0, len(seg), b, dev)
    data = OPT.upload_input(arr, len(arr), dev)[:b]
    pd, cs, litq, _ = OPT.segment_tables(data, npos, maxd, bits_tab,
                                         ctx_tab, distq, spos, slen, sdist,
                                         dloc, dval, 0)
    n = pd.shape[1]
    nb = n // OPT.B
    nslots = pd.shape[0]

    # K1 on seeded slots at the segment's width first (each case's rows
    # are freed before the next), then on the real segment; every
    # comparison is bitwise
    errs = {}
    for label, ns, sd in (("ties29", 29, 1), ("slots2", 2, 2),
                          ("slots32", 32, 3)):
        spd, scs, scq = (torch.from_numpy(a).to(dev)
                         for a in k1_case(ns, n, sd))
        got = kernels.suffix_min(spd, scs, scq)
        errs[label] = max_abs_err(got, OPT.suffix_min_plain(spd, scs, scq))
        del spd, scs, scq, got
        torch.cuda.empty_cache()
    mp = kernels.suffix_min(pd, cs, copyq)
    mp_plain = OPT.suffix_min_plain(pd, cs, copyq)
    torch.cuda.synchronize()
    errs["real"] = max_abs_err(mp, mp_plain)
    del mp_plain
    rows["K1"] = dict(
        name="suffix_min", route="cuda",
        source="brotli_tpu_torch/csrc/suffix_min.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:625",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.suffix_min(pd, cs, copyq), 10),
        device_ms=cuda_ms(lambda: kernels.suffix_min(pd, cs, copyq), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.suffix_min_plain(pd, cs, copyq), 3),
        nbytes=(pd.numel() + cs.numel() + copyq.numel() + mp.numel()) * 4,
        # the scatter's nslots and the suffix-min's W steps a position,
        # about 8 operations each
        nops=n * (nslots + OPT.W) * 8)
    print(f"[3] K1 suffix_min: max_abs_err {errs}", flush=True)

    pay = kernels.dp_scan(mp, litq)
    pay_plain = OPT.dp_scan_plain(mp, litq)
    torch.cuda.synchronize()
    err = max_abs_err(pay, pay_plain)
    rows["K3"] = dict(
        name="dp_scan", route="cuda",
        source="brotli_tpu_torch/csrc/dp_scan.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:365",
        max_abs_err=err,
        ms=cuda_ms(lambda: kernels.dp_scan(mp, litq), 10),
        device_ms=cuda_ms(lambda: kernels.dp_scan(mp, litq), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.dp_scan_plain(mp, litq), 2),
        nbytes=(mp.numel() + litq.numel() + pay.numel()) * 4,
        nops=n * OPT.W * 4)
    print(f"[3] K3 dp_scan: max_abs_err {err}", flush=True)
    del mp

    # K4 on seeded rows at the segment's width; then on a count of
    # blocks that leaves the last CTA part-full, and on rows that start
    # off the 16-byte grid (a slice from row 1: the scalar staging)
    errs = {}
    k4_cases = [(label, k4_case(label, nb, OPT.B, sd))
                for label, sd in (("ones", 1), ("random", 2), ("63", 3))]
    k4_cases += [("partial", k4_case("random", nb - 3, OPT.B, 4)),
                 ("unaligned", k4_case("random", nb + 1, OPT.B, 5))]
    for label, rows_np in k4_cases:
        spay = torch.from_numpy(rows_np).to(dev)
        if label == "unaligned":
            spay = spay[1:]
        got = kernels.dp_backtrack(spay)
        want = OPT.dp_backtrack_plain(spay)
        errs[label] = max(max_abs_err(got[0], want[0]),
                          max_abs_err(got[1], want[1]))
    g, v = kernels.dp_backtrack(pay)
    g_plain, v_plain = OPT.dp_backtrack_plain(pay)
    torch.cuda.synchronize()
    errs["real"] = max(max_abs_err(g, g_plain), max_abs_err(v, v_plain))
    rows["K4"] = dict(
        name="dp_backtrack", route="cuda",
        source="brotli_tpu_torch/csrc/dp_backtrack.cu",
        replaces="brotli_tpu/ops/optimal_jax.py:494",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.dp_backtrack(pay), 10),
        device_ms=cuda_ms(lambda: kernels.dp_backtrack(pay), 10,
                          queued=True),
        plain_ms=cuda_ms(lambda: OPT.dp_backtrack_plain(pay), 2),
        nbytes=(pay.numel() + g.numel() + v.numel()) * 4,
        nops=nb * OPT.B * 8)
    print(f"[3] K4 dp_backtrack: max_abs_err {errs}", flush=True)
    del pd, cs, litq, pay, g, v, g_plain, v_plain, pay_plain, spay, got
    del want, k4_cases
    torch.cuda.empty_cache()

    # K2 on the real skip vector of the q5 matcher's second segment of
    # the 16 MiB corpus (buffer [0, 8 MiB), start 4 Mi), then on seeded
    # vectors from the start offsets that the numpy model of its design
    # in tests/test_torch_matcher.py covers (a chunk boundary, a
    # sub-chunk's last offset, n - 1, n), and on one at 1 Mi; every
    # comparison is bitwise
    nk = PM._bucket(PM.SEG_BYTES)
    buf = torch.from_numpy(arr[:nk].copy()).to(dev)
    _, _, skip = PM.match_skip(buf, nk - 3, maxd, 4)
    skip = skip.to(torch.int32)
    del buf
    start_real = PM.SEG_BYTES // 2
    cl, cs_ = kernels.CHAIN_L, kernels.CHAIN_S
    edges = (0, 12345, 100 * cl, 100 * cl + 5 * cs_ + cs_ - 1, nk - 1, nk)
    rng = np.random.default_rng(0)
    cases = [("real", skip, start_real)]
    for fill in ("1", "16", "uniform", "alternating"):
        if fill == "uniform":
            vec = rng.integers(1, 17, nk)
        elif fill == "alternating":
            vec = np.where(np.arange(nk) % 2 == 0, 16, 1)
        else:
            vec = np.full(nk, int(fill))
        vec = torch.from_numpy(vec.astype(np.int32)).to(dev)
        # the all-1 walk visits every position: its plain walk is slow
        starts = (0, 12345, nk - 1, nk) if fill == "1" else edges
        cases += [(f"{fill}@{st}", vec, st) for st in starts]
    # 1 Mi, and the same length off the 16-byte grid (the scalar staging)
    vec = torch.from_numpy(rng.integers(1, 17, (1 << 20) + 1)
                           .astype(np.int32)).to(dev)
    cases += [(f"uniform1Mi@{st}", vec[:1 << 20], st)
              for st in (0, 7 * cl + 3 * cs_ + cs_ - 1)]
    cases += [("unaligned1Mi@12345", vec[1:], 12345)]
    errs, taken = {}, {}
    for label, vec, st in cases:
        got, flag = kernels.chain_select_launch(vec, vec.shape[0], st)
        want = chain.chain_select_plain(vec, vec.shape[0], st)
        errs[label] = max_abs_err(got, want) + int(flag.item())
        taken[label] = int(want.sum())
    # the real case 100 times in a row: a race in the look-back would
    # show as a result that differs
    want = chain.chain_select_plain(skip, nk, start_real)
    errs["real x100"] = 0
    for _ in range(100):
        got, flag = kernels.chain_select_launch(skip, nk, start_real)
        errs["real x100"] = max(errs["real x100"], max_abs_err(got, want),
                                int(flag.item()))
    print(f"[3] K2 chain_select: max_abs_err {errs}; matches taken "
          f"{taken}", flush=True)
    # a skip outside [1, 16] sets the kernel's error flag
    bad_skip = skip.clone()
    bad_skip[nk // 3] = 0
    _, flag = kernels.chain_select_launch(bad_skip, nk, 0)
    if int(flag.item()) == 0:
        sys.exit("chip_smoke: K2 took a skip outside [1, 16]")
    rows["K2"] = dict(
        name="chain_select", route="cuda",
        source="brotli_tpu_torch/csrc/chain_select.cu",
        replaces="brotli_tpu/ops/chain_pallas.py:59",
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: kernels.chain_select_launch(skip, nk,
                                                       start_real), 10),
        device_ms=cuda_ms(lambda: kernels.chain_select_launch(
            skip, nk, start_real), 10, queued=True),
        plain_ms=cuda_ms(lambda: chain.chain_select_plain(skip, nk,
                                                          start_real), 1),
        nbytes=2 * nk * 4,  # skip read once, sel written once
        nops=nk)
    del cases, vec, got, want, bad_skip

    for k, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r.pop("nops"))
        lib = (f", library {r['library_ms']:.3f} ms"
               if "library_ms" in r else "")
        print(f"    {k} {r['name']}: kernel {r['ms']:.3f} ms one call "
              f"(the card alone {r['device_ms']:.3f} ms), plain "
              f"{r['plain_ms']:.3f} ms{lib}, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) at n="
              f"{nk if k == 'K2' else r.pop('n', n)} [{card}]")
    mhz = float(smi("clocks.max.sm").split()[0])
    print(f"    K4 dp_backtrack: bound by bytes "
          f"({rows['K4']['bound_ms']:.3f} ms); its dependent steps: 5 "
          f"doubling rounds, a chain of at most {OPT.B // 32} checkpoints "
          f"32 steps apart, then 32 steps from each checkpoint")
    steps = kernels.CHAIN_S + 2 * 16
    print(f"    K2 chain_select: bound by bytes "
          f"({rows['K2']['bound_ms']:.3f} ms); the dependent chain of one "
          f"chunk: {steps} shared-memory loads ({kernels.CHAIN_S} in the "
          f"sub-chunk walk, 16 for the chunk map, 16 for the entries), "
          f"{steps * SMEM_LOAD_CYCLES / mhz * 1e-3:.4f} ms at "
          f"{SMEM_LOAD_CYCLES} cycles each and {mhz:.0f} MHz, plus one L2 "
          f"round trip for each look-back round of 32 predecessors; "
          f"chunks overlap")
    bad = [k for k, r in rows.items() if r["max_abs_err"] != 0]
    if bad:
        sys.exit(f"chip_smoke: kernels disagree with their plain "
                 f"versions: {bad}")
    del skip
    torch.cuda.empty_cache()

    seeded = seeded_k5_k6(dev)

    # -- 4. the q11 path ------------------------------------------------
    print("[4] q11, api.compress", flush=True)
    launches, q11_out = three_runs(
        lambda: bt.compress(corpus, quality=11), trace, kernels, "q11",
        corpus, bt.decompress, card)
    nseg4 = launches["suffix_min"]
    want4 = dp_launches(nseg4, probes=2)
    if nseg4 == 0 or any(launches[k] != v for k, v in want4.items()):
        sys.exit(f"chip_smoke: the q11 path launched {launches}, not "
                 f"{want4}")
    calls, secs = trace.report()["dp.dispatch"]
    print(f"    dp.dispatch of the traced run: {secs * 1e3:.1f} ms over "
          f"{calls} segments (host clock); device operations per "
          f"dp_v3_segment {seg_ops[1]} (plain edges {seg_ops[0]}) [{card}]",
          flush=True)
    halo_launches = q11_lgwin24(corpus, trace, kernels, card)

    # -- 5. kernels and plain versions give the same stream ---------------
    prefix = corpus[:512 << 10]
    on_card = bt.compress(prefix, quality=11)
    t0 = time.perf_counter()
    on_cpu = bt.compress(prefix, quality=11, device="cpu")
    print(f"[5] 512 KiB prefix: cuda {len(on_card)} B, cpu {len(on_cpu)} "
          f"B (cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: cuda and cpu streams differ")

    # -- 6. the q5 path --------------------------------------------------
    print("[6] q5, parallel.shard.compress_sharded", flush=True)
    launches_q5, q5_out = three_runs(
        lambda: compress_sharded(corpus, quality=5), trace, kernels, "q5",
        corpus, bt.decompress, card)
    if launches_q5["chain_select"] != 4:
        sys.exit(f"chip_smoke: the q5 path launched chain_select "
                 f"{launches_q5['chain_select']} times, not 4")

    # -- 7. q5 on the card and on the CPU --------------------------------
    prefix = corpus[:1 << 20]
    on_card = compress_sharded(prefix, quality=5)
    t0 = time.perf_counter()
    on_cpu = compress_sharded(prefix, quality=5, device="cpu")
    print(f"[7] q5 1 MiB prefix: cuda {len(on_card)} B, cpu {len(on_cpu)} "
          f"B (cpu path {time.perf_counter() - t0:.1f} s)", flush=True)
    if on_card != on_cpu or bt.decompress(on_card) != prefix:
        sys.exit("chip_smoke: q5 cuda and cpu streams differ")

    # -- 8. q11 with two shards ------------------------------------------
    part = corpus[:8 << 20]
    kernels.reset_launches()
    out2, wall2 = timed(lambda: compress_sharded(part, quality=11,
                                                 n_shards=2))
    launches_sh = dict(kernels.LAUNCHES)
    print(f"[8] q11, two shards: {len(part)} B -> {len(out2)} B (ratio "
          f"{len(part) / len(out2):.4f}) in {wall2:.3f} s [{card}]; "
          f"launches {launches_sh}", flush=True)
    if bt.decompress(out2) != part:
        sys.exit("chip_smoke: the two-shard q11 stream does not decode")
    missing = [k for k in ("suffix_min", "dp_scan", "dp_backtrack",
                           "chain_select") if launches_sh[k] == 0]
    if missing:
        sys.exit(f"chip_smoke: the two-shard q11 path launched no {missing}")

    # -- 9. the device serializer ----------------------------------------
    launches_ds = device_serializer(corpus, part, q5_out, out2, rows,
                                    seeded, card)

    # -- 10. the device decoder -----------------------------------------
    launches_dec = device_decoder(
        corpus, (("q11", q11_out), ("q5", q5_out)), rows, seeded, dev,
        card)

    # -- 11. the public surface -----------------------------------------
    q11_4mib = public_surface(corpus, q11_out, q5_out, card)

    # -- 12. the DP variants ----------------------------------------------
    launches_v1, launches_ring = dp_variants(corpus, rows, dev, card)

    # -- 13. several devices and processes ------------------------------
    mesh_and_processes(corpus, q5_out, card, dev)

    # -- 14. the Python serializer and decoder ----------------------------
    python_serializer_and_decoder(corpus, q5_out, q11_4mib, card, dev)

    # -- 15. the host pipeline's routes ----------------------------------
    host_pipeline_routes(corpus, card, dev)

    # -- 16. the last slice ----------------------------------------------
    last_slice(corpus, card, dev)

    # -- 17. report ------------------------------------------------------
    path_launches = dict(launches, chain_select=launches_q5["chain_select"],
                         bitpack=launches_ds["bitpack"],
                         lz_resolve=launches_dec["lz_resolve"],
                         dp_scan_v1=launches_v1["dp_scan_v1"],
                         dp_scan_ring=launches_ring["dp_scan_ring"],
                         edge_ranks_halo=halo_launches["edge_ranks"])
    kern = []
    for key in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9",
                "K10", "K10h", "K10b", "K11", "K12"):
        r = rows[key]
        kern.append(dict(name=r["name"], route=r["route"],
                         source=r["source"], replaces=r["replaces"],
                         launches=path_launches[r.get("counted_as",
                                                      r["name"])],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         device_ms=r["device_ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": kern}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
