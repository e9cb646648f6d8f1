"""Entry points of the port: a one-device run of the device matcher and
a dry run of the sharded encode over several devices (counterpart of
the JAX package's __graft_entry__.py, on the port's own modules and its
mesh, parallel/shard).

`entry(device)` returns (fn, args): fn(*args) runs ops.matcher.
match_block (K2 on the card) over the JAX entry's 64 KiB block.
`dryrun_multichip(n_devices, device)` match-finds one 64 KiB block a
device, sums the literal histograms of the match starts onto the first
device (the JAX dry run's psum), then runs the production sharded
encode on the same devices: q5 with the collective gather, and q11
with the JAX dry run's 64 KiB DP segment on every device. With fewer
than n_devices cards, the one device is named n_devices times (its
shards queue there). Both streams are decoded by the reference CLI at
build/ref/brotli when it exists, else by the port's native decoder.

Usage: python -m brotli_tpu_torch.entry [--device cpu] [--n N]
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

REF_CLI = pathlib.Path(__file__).resolve().parents[1] / \
    "build" / "ref" / "brotli"
BLOCK = 1 << 16        # one match_block call; the dry run's DP segment
MAX_DISTANCE = (1 << 16) - 16


def entry(device=None):
    """(fn, args): fn(*args) is ops.matcher.match_block over the JAX
    entry's 64 KiB block (numpy's default_rng(0), as
    __graft_entry__.entry draws it) on `device` (None = "cuda", raising
    without it), returning match_block's (count, packed, err)."""
    from .ops.matcher import match_block
    from .utils.device import resolve

    rng = np.random.default_rng(0)
    block = (rng.integers(0, 64, size=BLOCK) +
             rng.integers(0, 4, size=BLOCK) * 3) % 251
    data = torch.from_numpy(block.astype(np.uint8)).to(resolve(device))
    return match_block, (data, BLOCK - 3, MAX_DISTANCE)


def _decodes(stream: bytes, data: bytes) -> str:
    """The oracle that decoded `stream` to `data`; raises otherwise."""
    if REF_CLI.exists():
        r = subprocess.run([str(REF_CLI), "-d", "-c"], input=stream,
                           capture_output=True)
        if r.returncode != 0 or r.stdout != data:
            raise RuntimeError("the reference decoder rejected a sharded "
                               "stream")
        return "reference CLI"
    from .api import decompress
    if decompress(stream) != data:
        raise RuntimeError("a sharded stream does not decode")
    return "in-repo decoder"


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX dry run (__graft_entry__.dryrun_multichip) over
    `n_devices` devices: cuda:0 .. cuda:n-1 where that many cards are
    visible, else `device` (None = "cuda") named n_devices times.
    Prints and returns its numbers: {"matches", "hist_total", "q5",
    "q11"}, the last two the sharded streams."""
    from .ops.matcher import match_block
    from .parallel import shard as PS
    from .utils.device import resolve

    dev = resolve(device)
    devices = PS._mesh_devices(dev, n_devices) or [dev] * n_devices
    rng = np.random.default_rng(0)
    data = rng.integers(0, 16, size=BLOCK * n_devices).astype(np.uint8)

    counts, hists = [], []
    for i, d in enumerate(devices):
        chunk = torch.from_numpy(data[i * BLOCK:(i + 1) * BLOCK]).to(d)
        count, packed, err = match_block(chunk, BLOCK - 3, MAX_DISTANCE)
        if int(err):
            raise RuntimeError(f"the chain walk failed on shard {i}")
        # the literal histogram of the match starts, per shard
        valid = torch.arange(packed.shape[1], device=d) < count
        starts = torch.where(valid, packed[0], 0)
        hists.append(torch.zeros(256, dtype=torch.int64, device=d)
                     .index_add_(0, chunk[starts].long(), valid.long()))
        counts.append(count)
    # the psum: every shard's histogram copied onto the first device
    hist = torch.stack([h.to(devices[0]) for h in hists]).sum(0)
    total = sum(int(c) for c in counts)
    print(f"dryrun_multichip ok on {n_devices} devices: {total} matches, "
          f"hist total {int(hist.sum())}")

    # the production sharded encode on the same devices; the stitched
    # streams must decode
    words = [b"information ", b"the quick brown fox ", b"shard ",
             b"device mesh pipeline ", b"entropy coding "]
    rng2 = np.random.default_rng(1)
    payload = b"".join(words[i] for i in
                       rng2.integers(0, len(words), 80_000))
    comp = PS._compress_sharded(payload, 5, 22, n_devices, dev, devices,
                                gather="collective")
    oracle = _decodes(comp, payload)
    print(f"production compress_sharded ok on the mesh: {len(payload)} -> "
          f"{len(comp)} bytes, validated by {oracle}")

    # the DP on every device, at the JAX dry run's 64 KiB segment: the
    # 4 MiB production segment only changes the padding
    payload11 = (payload * 8)[:n_devices * BLOCK + (1 << 14)]
    comp11 = PS._compress_sharded(payload11, 11, 22, n_devices, dev,
                                  devices, seg=BLOCK)
    _decodes(comp11, payload11)
    print(f"mesh q11 (sharded optimal-parse DP) ok: {len(payload11)} -> "
          f"{len(comp11)} bytes on {n_devices} devices")
    return {"matches": total, "hist_total": int(hist.sum()), "q5": comp,
            "q11": comp11}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="brotli_tpu_torch.entry")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--n", type=int, default=8,
                    help="devices of the dry run (default 8)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
