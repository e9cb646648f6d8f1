"""Decoder fuzzer (copy of brotli_tpu.tools.fuzz over the port's own
decoders; role parity: c/fuzz/decode_fuzzer.c + test_fuzzer.sh + the
replayed seed corpus java/org/brotli/integration/fuzz_data.zip).

Feeds mutated/truncated/random streams to both of the port's decoders
(Python spec-driven and native C), in one shot AND in data-derived
chunk sizes
(the reference fuzzer's `addend = data[size-1] & 7` trick), asserting
they never crash, never disagree, and respect output caps.

Persistence (the libFuzzer corpus role):
  * every input with a NEW behavior signature (outcome, error code,
    output-size class, consumed-size class) is saved to the corpus
    directory -- interesting inputs accumulate across runs;
  * any crash/disagreement artifact is written to <corpus>/crashes/
    BEFORE the exception propagates, so the failing input survives;
  * --replay re-runs every saved corpus + crash file (the CI job).

Usage:
  python -m brotli_tpu_torch.tools.fuzz [--iters N] [--seed S]
      [--corpus DIR] [--save DIR] [--replay]

--replay is the corpus mode: every file of tests/fuzz_corpus/ (and its
crashes/) through both decoders. --corpus DIR adds DIR's
*.compressed* streams to the mutation seeds.
"""

import argparse
import hashlib
import pathlib
import sys

import numpy as np

# in-repo persistent corpus (committed; replayed by CI and the suite)
DEFAULT_SAVE = pathlib.Path(__file__).resolve().parents[2] / \
    "tests" / "fuzz_corpus"


def _chunk_sizes(blob: bytes):
    """Data-derived chunk schedule (the reference decode_fuzzer's
    `addend = data[size-1] & 7`: exponential chunks + small addend)."""
    addend = (blob[-1] & 7) if blob else 0
    sizes = []
    step = 1
    total = 0
    while total < len(blob):
        s = step + addend
        sizes.append(s)
        total += s
        step = min(step * 2, 4096)
    return sizes


def _decode_chunked(blob: bytes, max_out: int):
    """Native chunked decode with an output cap per call; returns
    (ok, out_bytes, err_code)."""
    from .. import native
    sd = native.StreamDecoder()
    sd.set_output_limit(1 << 20)
    out = bytearray()
    try:
        pos = 0
        for s in _chunk_sizes(blob):
            out += sd.feed(blob[pos:pos + s])
            pos += s
            while sd.pending_output:
                out += sd.feed(b"")
                if len(out) > max_out:
                    return False, b"", "cap"
        out += sd.feed(b"", final=True)
        while sd.pending_output:
            out += sd.feed(b"")
        if not sd.finished:
            return False, b"", "truncated"
        return True, bytes(out), None
    except ValueError as e:
        return False, b"", getattr(e, "code", -99)


def _one_case(blob: bytes, native_decode, py_decode, max_out):
    """Run one input through all decode paths; returns (tag, signature)."""
    py_ok, py_out = True, b""
    try:
        py_out = py_decode(blob)
    except Exception:
        py_ok = False
    nat_ok, nat_out, nat_code = True, b"", None
    try:
        nat_out = native_decode(blob)
    except ValueError as e:
        nat_ok, nat_code = False, getattr(e, "code", -99)
    if py_ok != nat_ok:
        raise AssertionError(
            f"decoder disagreement: python={'ok' if py_ok else 'err'} "
            f"native={'ok' if nat_ok else 'err'} on {blob[:40].hex()}...")
    if py_ok and py_out != nat_out:
        raise AssertionError("output mismatch between decoders")
    # chunked-feeding differential (streaming oracle): an ACCEPTED
    # one-shot stream must decode identically through the chunked
    # decoder; a rejected one must not be accepted whole
    ch_ok, ch_out, ch_code = _decode_chunked(blob, max_out)
    if nat_ok and (not ch_ok or ch_out != nat_out):
        raise AssertionError(
            f"chunked decode mismatch (code {ch_code}) on "
            f"{blob[:40].hex()}...")
    if not nat_ok and ch_ok:
        raise AssertionError(
            f"chunked decoder ACCEPTED a rejected stream "
            f"{blob[:40].hex()}...")
    tag = "accept" if py_ok else "reject"
    sig = (tag, nat_code, ch_code,
           min(len(py_out).bit_length(), 24) if py_ok else -1)
    return tag, sig


def _save_blob(d: pathlib.Path, blob: bytes) -> pathlib.Path:
    d.mkdir(parents=True, exist_ok=True)
    p = d / (hashlib.sha1(blob).hexdigest()[:16] + ".bin")
    if not p.exists():
        p.write_bytes(blob)
    return p


def run(iters: int = 2000, seed: int = 0, corpus: pathlib.Path = None,
        max_out: int = 64 << 20, save: pathlib.Path = None,
        verbose: bool = False) -> dict:
    from ..dec.decoder import Decoder
    from ..native import decode as native_decode
    from .. import compress

    def py_decode(b):
        out = Decoder().decompress(b)
        if len(out) > max_out:
            raise AssertionError("output cap exceeded")
        return out

    rng = np.random.default_rng(seed)
    seeds = []
    if corpus:
        for f in sorted(corpus.glob("*.compressed*"))[:40]:
            seeds.append(f.read_bytes())
    if save and save.exists():  # prior interesting inputs re-seed
        for f in sorted(save.glob("*.bin"))[:200]:
            seeds.append(f.read_bytes())
    for q in (1, 5):
        seeds.append(compress(b"fuzz seed data " * 200, quality=q))
    stats = {"accept": 0, "reject": 0, "new": 0}
    seen_sigs = set()
    for i in range(iters):
        kind = i % 4
        if kind == 0:  # pure random
            blob = rng.bytes(int(rng.integers(1, 512)))
        else:  # mutate a valid stream
            base = bytearray(seeds[int(rng.integers(len(seeds)))])
            nmut = int(rng.integers(1, 8))
            for _ in range(nmut):
                p = int(rng.integers(len(base)))
                base[p] = int(rng.integers(256))
            if kind == 2 and len(base) > 4:  # truncate
                base = base[:int(rng.integers(1, len(base)))]
            blob = bytes(base)
        try:
            tag, sig = _one_case(blob, native_decode, py_decode, max_out)
        except Exception:
            if save:
                p = _save_blob(save / "crashes", blob)
                print(f"crash artifact: {p}", file=sys.stderr)
            raise
        stats[tag] += 1
        if save and sig not in seen_sigs and len(blob) < (1 << 16):
            seen_sigs.add(sig)
            _save_blob(save, blob)
            stats["new"] += 1
    return stats


def replay(save: pathlib.Path, max_out: int = 64 << 20) -> dict:
    """Re-run every persisted corpus + crash input (the CI regression
    job; role of the reference's fuzz_data.zip replay)."""
    from ..dec.decoder import Decoder
    from ..native import decode as native_decode

    def py_decode(b):
        out = Decoder().decompress(b)
        if len(out) > max_out:
            raise AssertionError("output cap exceeded")
        return out

    files = sorted(save.glob("*.bin")) + \
        sorted((save / "crashes").glob("*.bin")) if save.exists() else []
    stats = {"accept": 0, "reject": 0, "new": 0, "files": len(files)}
    for f in files:
        tag, _sig = _one_case(f.read_bytes(), native_decode, py_decode,
                              max_out)
        stats[tag] += 1
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="brotli_tpu_torch.tools.fuzz")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", type=pathlib.Path, default=None,
                    help="directory of *.compressed* seed streams")
    ap.add_argument("--save", default=str(DEFAULT_SAVE),
                    help="persistent corpus dir (crash artifacts go to "
                         "SAVE/crashes); pass '' to disable")
    ap.add_argument("--replay", action="store_true",
                    help="re-run every saved corpus/crash input and "
                         "exit (CI regression mode)")
    args = ap.parse_args(argv)
    # '' disables saving (a Path of '' would be the working directory)
    save = pathlib.Path(args.save) if args.save else None
    if args.replay:
        stats = replay(save or DEFAULT_SAVE)
        print(f"fuzz replay: {stats['files']} files, {stats['accept']} "
              f"accepted, {stats['reject']} rejected, no "
              f"crashes/disagreements")
        return 0
    stats = run(args.iters, args.seed,
                args.corpus if args.corpus and args.corpus.exists()
                else None,
                save=save)
    print(f"fuzz: {stats['accept']} accepted, {stats['reject']} "
          f"rejected, {stats['new']} new corpus entries, no "
          f"crashes/disagreements")
    return 0


if __name__ == "__main__":
    sys.exit(main())
