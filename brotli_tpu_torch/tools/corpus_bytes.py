"""The stream sizes of chip_smoke.py's encodes (phases 4, 6, 8 and 9) on
a corpus whose head is the C sources in another directory.

The corpus of tools/corpus.py starts with the port's own C sources, so
a change to them changes every stream of the smoke. Run with the C
sources of an earlier commit, this gives the bytes that commit's smoke
printed if the encoders are unchanged.

Usage, from the repository root on a machine with a card, after
`git show REV:brotli_tpu_torch/native/btpu_enc.c > DIR/btpu_enc.c` and
the same for btpu_dec.c:
    python3 -m brotli_tpu_torch.tools.corpus_bytes DIR
"""

import argparse
import subprocess

from .. import compress
from ..ops import kernels
from ..parallel.shard import compress_sharded
from .corpus import build_corpus

ENCODES = {
    "q11": lambda c: compress(c, quality=11),
    "q5": lambda c: compress_sharded(c, quality=5),
    "q11 two shards": lambda c: compress_sharded(c[:8 << 20], quality=11,
                                                 n_shards=2),
    "q11 two shards, device serializer": lambda c: compress_sharded(
        c[:8 << 20], quality=11, n_shards=2, serializer="device"),
    "q5, device serializer": lambda c: compress_sharded(
        c, quality=5, serializer="device"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", help="directory of btpu_enc.c, btpu_dec.c")
    args = ap.parse_args()
    kernels.build()
    corpus = build_corpus(sources=args.sources)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    for label, fn in ENCODES.items():
        print(f"{label}: {len(fn(corpus))} B", flush=True)


if __name__ == "__main__":
    main()
