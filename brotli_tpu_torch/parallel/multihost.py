"""Multi-process sharded compression (counterpart of
brotli_tpu.parallel.multihost).

Every process calls compress_sharded_mp with the same input after
torch.distributed.init_process_group. The shards are global, ordered by
rank and then by each process's devices. Each process match-finds and
serializes only its own shards (parallel.shard's mesh matcher, each
shard with its halo); the 4-slot distance-ring chain crosses process
boundaries through a 5-entry push summary per shard; the payloads are
all-gathered, so every process returns the same single RFC 7932 stream.

The gathers move host arrays, as the JAX package's process_allgather
does, over a gloo group: the default group when it runs gloo, else one
made for the call (NCCL gathers device tensors only, and refuses two
ranks on one card).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..enc import bitstream
from ..format import constants as C
from ..utils.device import resolve
from . import serialize_shard_native
from .shard import _find_matches_mesh, _split_at_metablocks

TAIL = 5  # push-summary length that keeps the ring chain exact


def compress_sharded_mp(data: bytes, quality: int = 5, lgwin: int = 22,
                        *, devices=None) -> bytes:
    """Multi-process sharded compress. Call from every process of the
    default process group with the same arguments; returns the same
    stream on every process. `devices`: this process's devices, one
    shard each (None = every CUDA device the process sees; raises
    without CUDA). As in the JAX package, every quality, q11 included,
    runs the greedy device matcher. Raises ValueError for an input under
    64 KiB a shard."""
    if devices is None:
        resolve(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve(d) for d in devices]
    own_group = "gloo" not in dist.get_backend()
    group = dist.new_group(backend="gloo") if own_group else None
    try:
        return _compress_mp(bytes(data), quality, lgwin, devices, group)
    finally:
        if own_group:
            dist.destroy_process_group(group)


def _compress_mp(raw, quality, lgwin, devices, group):
    arr = np.frombuffer(raw, dtype=np.uint8)
    n = len(arr)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    counts = _allgather_rows(np.array([len(devices)], np.int64),
                             [1] * world, group)
    n_shards = int(counts.sum())
    first = int(counts[:rank].sum())
    local = range(first, first + len(devices))
    if n < n_shards * (1 << 16):
        raise ValueError("input too small for the multi-process path")
    bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
    max_distance = C.max_backward_distance(lgwin)

    # local match finding and post-pass, then the split at metablock
    # bounds before the rings (the chain must see the serialized set)
    matches = _split_at_metablocks(
        _find_matches_mesh(arr, bounds, max_distance, quality, devices,
                           local), bounds, local)

    # ring chain across processes: tiny per-shard push summaries
    lsum = np.array([bitstream.ring_push_summary(d, f, TAIL)
                     for _, _, d, f in matches], np.int64).reshape(-1, TAIL)
    gsum = _allgather_rows(lsum, counts, group)
    entry = {0: None}
    ring = bitstream.initial_ring()
    for si in range(n_shards - 1):
        ring = bitstream.ring_apply_summary(ring, gsum[si])
        entry[si + 1] = ring

    # serialize the local shards, byte-aligned (a trailing empty
    # metadata block on every shard but the last)
    payloads = []
    for si, mt in zip(local, matches):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        payloads.append(serialize_shard_native(
            raw, lo, hi, mt, quality, lgwin, entry[si], si == 0,
            si == n_shards - 1))

    # ordered payload all-gather (sizes first, then padded bytes)
    gsz = _allgather_rows(np.array([len(p) for p in payloads], np.int64),
                          counts, group)
    lpad = np.zeros((len(payloads), int(gsz.max())), np.uint8)
    for r, p in enumerate(payloads):
        lpad[r, :len(p)] = np.frombuffer(p, np.uint8)
    gpad = _allgather_rows(lpad, counts, group)
    return b"".join(gpad[si, :int(gsz[si])].tobytes()
                    for si in range(n_shards))


def _allgather_rows(x, counts, group):
    """Every rank's rows of x, (counts[rank], ...) on each, in rank
    order: all_gather takes equal shapes, so each rank pads its rows to
    max(counts) and the padding is dropped after."""
    pad = np.zeros((max(counts),) + x.shape[1:], x.dtype)
    pad[:len(x)] = x
    t = torch.from_numpy(pad)
    out = [torch.empty_like(t) for _ in counts]
    dist.all_gather(out, t, group=group)
    return np.concatenate([o.numpy()[:c] for o, c in zip(out, counts)])
