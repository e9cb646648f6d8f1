"""Cross-route stress fuzzer (counterpart of brotli_tpu.tools.stress):
each trial encodes one input through one encoder route of the port,
the routes taken in turn, and decodes the stream through every decoder
the route allows (role parity: c/fuzz/ and the reference's roundtrip
rig, across every engine at once).

Inputs (`trials`): the JAX stress's five kinds -- 0 random bytes, 1 a
slice of a source, 2 a splice of two sources, 3 a repeat of a
source's head, 4 sparse mutations -- drawn from random.Random(seed) in
its order, its sources being 1 MiB pieces of tools/corpus.build_corpus
(4 MiB); and kind 5, a page of inline base64 images (tools/corpus.
base64_page), the base64 route's input. The routes marked "small" take
the JAX stress's sizes, 1 to 60,000 B; the others draw 64 KiB to 1 MiB,
their quality first, and start at the size where their device path
runs: 256 KiB at q10/q11 (enc/encoder.MIN_DEVICE_INPUT), else 64 KiB
(the device matcher's threshold; 128 KiB for the two shards).

Encoder routes (ROUTES), one per trial in turn:
  native          compress at the JAX stress's qualities (small)
  python          compress(encoder="python", backend="numpy") (small)
  compressor      Compressor in modes 0-2 (q10/q11: mode 0) under the
                  JAX stress's random process/flush pieces (small)
  raw_dictionary  compress with a raw dictionary of 1 B to 64 KiB cut
                  from a source (small)
  card, card_v1, card_ring
                  q10/q11 in mode 0 on the card: the default DP (K1, K3,
                  K4), DPConfig(mode="v1") (K7, K4),
                  DPConfig(ring_scan=True) (K1, K8, K4)
  device          encoder="device": q<=9 in modes 0-2 (K2), q10/q11 in
                  modes 1-2 (K1, K3, K4)
  compressor_card Compressor at q10/q11 in modes 1-2, lgwin 18 or more,
                  flushed only once 256 KiB are in, so every flush's DP
                  runs on the card
  serialized_dictionary
                  a prefix and custom words (tools/corpus.
                  custom_dictionary) through the Python pipeline
  base64          base64 mode on a base64_page
  sharded_native, sharded_device, sharded_python
                  parallel.shard.compress_sharded in two shards with
                  each serializer (the device one K6)

Decoders, for every stream: native.decode (not for custom words, which
only the Python decoder takes); dec.decoder.Decoder().decompress;
dec.stream.StreamDecoder fed random chunks of 1-96 B; Decompressor(
decoder="python") fed random pieces of 1 B to 16 KiB; and
decompress(decoder="device") (K5) for every stream without a
dictionary (the api sends a dictionary stream to the Python decoder).
The three Python decoders take ~1 s a MiB, so on a large trial they run
on one trial in PY_SHARE, drawn; a custom-word stream always runs the
whole-buffer one.

Usage: python -m brotli_tpu_torch.tools.stress [--n N] [--seed S]
           [--device cpu]
"""

import argparse
import collections
import functools
import random
import sys
import time

SMALL = (1, 60_000)          # sizes [lo, hi) of the small routes
LARGE = (64 << 10, 1 << 20)  # and of the others
QUALITIES = (0, 1, 2, 4, 5, 7, 9, 10, 11)  # the JAX stress's
LGWINS = (16, 18, 22)
KINDS = ("random", "slice", "splice", "repeat", "mutations", "page")
ROUTES = ("native", "python", "compressor", "raw_dictionary",
          "card", "card_v1", "card_ring", "device", "compressor_card",
          "serialized_dictionary", "base64",
          "sharded_native", "sharded_device", "sharded_python")
SMALL_ROUTES = frozenset(ROUTES[:4])
CARD_ROUTES = frozenset(("card", "card_v1", "card_ring",
                         "compressor_card"))  # q10/q11 only
N_SHARDS = 2
PY_SHARE = 3
MAX_FAILURES = 5

Trial = collections.namedtuple(
    "Trial", "trial kind data q lgwin route chunking")


@functools.cache
def _corpus() -> bytes:
    from .corpus import build_corpus
    return build_corpus(4 << 20)


def _sources():
    c = _corpus()
    return [c[i << 20:(i + 1) << 20] for i in range(4)]


@functools.cache
def _shared_dictionary() -> bytes:
    """The serialized dictionary of every serialized_dictionary trial."""
    from .corpus import custom_dictionary
    return custom_dictionary(_corpus()[2 << 20:(2 << 20) + (64 << 10)])


def _least_size(route, q):
    """The size at which `route` takes its device path at quality q."""
    from ..enc.encoder import MIN_DEVICE_INPUT
    if q >= 10:
        return MIN_DEVICE_INPUT
    return N_SHARDS << 16 if route.startswith("sharded") else 1 << 16


def trials(seed: int = 2026, n: int = 400, sizes=(SMALL, LARGE)):
    """Yield Trial(trial, kind, data, q, lgwin, route, chunking) for
    trial 0..n-1 (an empty input is skipped, as in the JAX stress).
    `sizes`: the [lo, hi) ranges of the small and the large routes.
    `chunking` ("seed:trial") seeds the trial's own draws of modes,
    pieces, flushes and decoder chunks."""
    from .corpus import base64_page
    sources = _sources()
    rng = random.Random(seed)
    for trial in range(n):
        route = ROUTES[trial % len(ROUTES)]
        kind = trial % 5
        small = route in SMALL_ROUTES
        if not small:  # the quality picks the device path's size
            q = rng.choice((10, 11) if route in CARD_ROUTES else QUALITIES)
            lgwin = rng.choice(LGWINS)
        lo, hi = sizes[0] if small else sizes[1]
        size = rng.randrange(lo, hi)
        if not small:
            size = max(size, _least_size(route, q))
        src = rng.choice(sources)
        if route == "base64":
            kind = 5
            data = base64_page(_corpus(), size, seed=rng.getrandbits(32))
        elif kind == 0:
            data = (bytes(rng.randrange(256) for _ in range(min(size, 3000)))
                    if small else rng.randbytes(size))
        elif kind == 1:
            off = rng.randrange(max(len(src) - size, 1))
            data = src[off:off + size]
        elif kind == 2:  # splice two sources
            a, b = rng.choice(sources), rng.choice(sources)
            data = a[:size // 2] + b[:size // 2]
        elif kind == 3:  # repetitive
            pat = src[:rng.randrange(1, 200) + 1]
            data = (pat * (size // max(len(pat), 1) + 1))[:size]
        else:  # sparse mutations of text
            buf = bytearray(src[:size])
            for _ in range(rng.randrange(1, 20)):
                if buf:
                    buf[rng.randrange(len(buf))] = rng.randrange(256)
            data = bytes(buf)
        if small:
            q = rng.choice(QUALITIES)
            lgwin = rng.choice(LGWINS)
        if route == "compressor_card":  # a window that holds 256 KiB
            lgwin = max(lgwin, 18)
        if data:
            yield Trial(trial, kind, data, q, lgwin, route,
                        f"{seed}:{trial}")


def _fed(enc, data, rng, piece, flush_from=0, p_flush=0.3):
    """`data` through a streaming compressor in random pieces of
    [1, piece) bytes, each flushed with probability p_flush once
    flush_from bytes are in."""
    out = bytearray()
    j = 0
    while j < len(data):
        step = rng.randrange(1, piece)
        out += enc.process(data[j:j + step])
        j += step
        if j >= flush_from and rng.random() < p_flush:
            out += enc.flush()
    return bytes(out + enc.finish())


def encode(t: Trial, device=None):
    """(stream, dictionary) of trial `t` through its route on `device`
    (None = "cuda"; the native routes touch no device): the dictionary
    is the one the stream needs to decode, else None."""
    from .. import api
    from ..enc.encoder import MIN_DEVICE_INPUT
    from ..ops.optimal import DPConfig
    from ..parallel.shard import compress_sharded

    rng = random.Random(f"{t.chunking}:encode")
    r, data, q, w = t.route, t.data, t.q, t.lgwin
    if r == "native":
        return api.compress(data, quality=q, lgwin=w, device=device), None
    if r == "python":
        return api.compress(data, quality=q, lgwin=w, encoder="python",
                            backend="numpy"), None
    if r == "raw_dictionary":
        src = rng.choice(_sources())
        size = rng.randrange(1, 64 << 10)
        off = rng.randrange(len(src) - size)
        dic = src[off:off + size]
        return api.compress(data, quality=q, lgwin=w, dictionary=dic,
                            device=device), dic
    if r in ("card", "card_v1", "card_ring"):
        dp = {"card": None, "card_v1": DPConfig(mode="v1"),
              "card_ring": DPConfig(ring_scan=True)}[r]
        return api.compress(data, quality=q, lgwin=w, device=device,
                            dp=dp), None
    if r == "device":
        mode = rng.choice((1, 2) if q >= 10 else (0, 1, 2))
        return api.compress(data, mode=mode, quality=q, lgwin=w,
                            encoder="device", device=device), None
    if r == "compressor":
        mode = rng.choice((0, 1, 2)) if q <= 9 else 0
        c = api.Compressor(mode=mode, quality=q, lgwin=w, device=device)
        return _fed(c, data, rng, 9000), None
    if r == "compressor_card":
        c = api.Compressor(mode=rng.choice((1, 2)), quality=q, lgwin=w,
                           device=device)
        return _fed(c, data, rng, 1 << 18, flush_from=MIN_DEVICE_INPUT,
                    p_flush=0.5), None
    if r == "serialized_dictionary":
        blob = _shared_dictionary()
        return api.compress(data, quality=q, lgwin=w, dictionary=blob,
                            device=device), blob
    if r == "base64":
        return api.compress(data, quality=q, lgwin=w, base64_mode=True,
                            device=device), None
    return compress_sharded(data, quality=q, lgwin=w, n_shards=N_SHARDS,
                            serializer=r.partition("_")[2],
                            device=device), None


class Mismatch(Exception):
    """A decoder gave other bytes than the trial's input."""


def decode_all(t: Trial, stream: bytes, dictionary, device=None):
    """Decode `stream` through every decoder its route allows (see the
    module docstring); raises on any error or mismatch. Returns the
    names of the decoders run."""
    from .. import api, native
    from ..dec.decoder import Decoder
    from ..dec.stream import StreamDecoder

    rng = random.Random(f"{t.chunking}:decode")
    raw, shared = api._split_dictionary(dictionary)
    custom = api._needs_python_decoder(shared)
    large = t.route not in SMALL_ROUTES
    py = not large or rng.randrange(PY_SHARE) == 0
    ran = []

    def check(name, out):
        if bytes(out) != t.data:
            raise Mismatch(f"{name} decoder mismatch")
        ran.append(name)

    if not custom:
        check("native", native.decode(
            stream, compound=api._compound(raw, shared)))
    if py or custom:
        check("python", Decoder(dictionary=raw,
                                shared=shared).decompress(stream))
    if py:
        sd = StreamDecoder(dictionary=raw, shared=shared)
        out = bytearray()
        try:
            i = 0
            while i < len(stream):
                step = rng.randrange(1, 97)
                out += sd.feed(stream[i:i + step])
                i += step
            out += sd.finish()
        finally:
            sd.close()
        check("stream", out)
        d = api.Decompressor(dictionary, decoder="python")
        out = bytearray()
        i = 0
        while i < len(stream):
            step = rng.randrange(1, 1 << 14)
            out += d.process(stream[i:i + step])
            i += step
        if not d.is_finished():
            raise Mismatch("Decompressor(decoder='python') did not finish")
        check("decompressor", out)
    if dictionary is None:
        check("device", api.decompress(stream, decoder="device",
                                       device=device))
    return ran


def run(trials, device=None, out=None):
    """Encode and decode every trial of `trials` on `device` (None =
    the card). Prints to `out` (None: sys.stdout) each failure (trial,
    kind, route, q, lgwin, size, seed), stops after MAX_FAILURES, then
    prints one line per route: trials, bytes in and out, seconds, the
    decoders run and the kernel launches (ops.kernels.LAUNCHES; none on
    the CPU). Returns the failures as (Trial, error) pairs."""
    from ..ops import kernels

    if out is None:
        out = sys.stdout

    failures = []
    stats = collections.defaultdict(lambda: {
        "trials": 0, "in": 0, "out": 0, "s": 0.0,
        "decoders": collections.Counter(), "launches": collections.Counter()})
    for t in trials:
        st = stats[t.route]
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        try:
            stream, dictionary = encode(t, device)
            st["decoders"].update(decode_all(t, stream, dictionary, device))
        except Exception as e:
            failures.append((t, e))
            print(f"FAIL trial {t.trial} kind {KINDS[t.kind]} route "
                  f"{t.route} q {t.q} lgwin {t.lgwin} n {len(t.data)} seed "
                  f"{t.chunking.partition(':')[0]}: {type(e).__name__} {e}",
                  file=out, flush=True)
            if len(failures) >= MAX_FAILURES:
                break
            continue
        st["s"] += time.perf_counter() - t0
        st["trials"] += 1
        st["in"] += len(t.data)
        st["out"] += len(stream)
        st["launches"].update({k: v - before[k]
                               for k, v in kernels.LAUNCHES.items()
                               if v > before[k]})
    for route in ROUTES:
        if route in stats:
            st = stats[route]
            print(f"  {route}: {st['trials']} trials, {st['in']} B -> "
                  f"{st['out']} B in {st['s']:.3f} s; decoders "
                  f"{dict(st['decoders'])}; launches {dict(st['launches'])}",
                  file=out, flush=True)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="brotli_tpu_torch.tools.stress")
    ap.add_argument("--n", type=int, default=len(ROUTES) * 10,
                    help="trials (default: ten of each route)")
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    failures = run(trials(args.seed, args.n), args.device)
    print(f"done: {args.n} trials, {len(failures)} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
