"""Peak device memory of the q11 DP on the card, for the package under
--root (this tree by default), so that two commits can be compared in
one call on one card, each in a process of its own.

On the 16 MiB corpus of tools/corpus.py it prints, from
torch.cuda.max_memory_allocated:
  - `ops.optimal._candidates` (K9, the sorts and K10) on the first 4 MiB
    DP segment, at the default two levels and with level 3: the peak
    above what was allocated before the call, and the size of the table
    it returns;
  - q11 `compress` of the whole corpus;
  - q11 on the mesh, 4 shards over [cuda:0] * 4 with the default DP, as
    phase 13 of chip_smoke.py runs it, --mesh-runs times.

Usage, on a machine with a card (run by path, so that the package is
imported from --root; `git archive REV | tar -x -C DIR` makes another
commit's tree):
    python3 brotli_tpu_torch/tools/peak_memory.py [--root DIR]
        [--mesh-runs N]
"""

import argparse
import pathlib
import sys
import time

GIB = 2 ** 30


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2])
    ap.add_argument("--mesh-runs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    import brotli_tpu_torch as bt
    from brotli_tpu_torch.format import constants as C
    from brotli_tpu_torch.ops import kernels, optimal as O
    from brotli_tpu_torch.parallel import shard as PS
    from brotli_tpu_torch.tools.corpus import build_corpus

    print(f"package: {pathlib.Path(bt.__file__).resolve().parent}",
          flush=True)
    kernels.build()
    dev = torch.device("cuda")
    corpus = build_corpus()
    arr = np.frombuffer(corpus, np.uint8)
    maxd = C.max_backward_distance(22)

    def peak(fn):
        """fn's result and its peak above what was allocated before."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    data = O.upload_input(arr, len(arr), dev)[:O.SEG_V3]
    for label, levels in (("two levels", O.LEVELS),
                          ("level 3", O.LEVELS + (O.LEVEL3,))):
        cand, p = peak(lambda: O._candidates(data, O.SEG_V3 - 3, maxd,
                                             levels))
        print(f"_candidates, {label}: peak {p / GIB:.4f} GiB above the "
              f"call's start; the table {cand.numel() * 4 / GIB:.4f} GiB",
              flush=True)
        del cand
    del data
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out, p = peak(lambda: bt.compress(corpus, quality=11))
    print(f"q11 compress: {len(out)} B in {time.perf_counter() - t0:.3f} s,"
          f" peak {p / GIB:.4f} GiB", flush=True)
    for run in range(args.mesh_runs):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out, p = peak(lambda: PS._compress_sharded(
            corpus, 11, 22, 4, dev, [dev] * 4, dp=O.DPConfig()))
        print(f"q11 mesh, 4 shards, run {run + 1}: {len(out)} B in "
              f"{time.perf_counter() - t0:.3f} s, peak {p / GIB:.4f} GiB",
              flush=True)


if __name__ == "__main__":
    main()
