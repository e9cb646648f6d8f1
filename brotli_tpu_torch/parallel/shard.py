"""Sharded compression on one card (counterpart of
brotli_tpu.parallel.shard).

The input splits into shards; the card match-finds them one after
another (the device matcher at q<=9, the optimal-parse DP at q>=10,
each with the shard's absolute offset as its base), and each shard is
serialized as whole byte-aligned metablock sequences that concatenate
into ONE valid stream (non-last shards end with an empty metadata
block): natively on host threads, or with serializer="device" on the
card (parallel/device_serialize.py), one shard after another, a shard
the device path does not take going to the native serializer. The
decoder's distance ring crosses shard seams, so each shard's entry
ring is derived from the matches before it.
"""

import concurrent.futures as futures

import numpy as np
import torch

from ..enc import bitstream, matcher
from ..enc.encoder import encode
from ..format import constants as C
from ..ops.matcher import find_matches_device
from ..ops.optimal import find_matches_optimal
from ..utils import trace
from ..utils.device import resolve
from . import serialize_shard_native
from .device_serialize import serialize_shard_device


def compress_sharded(data: bytes, quality: int = 5, lgwin: int = 22,
                     n_shards: int = None, use_device: bool = True,
                     gather: str = "host", serializer: str = "native",
                     device=None, *, dp=None) -> bytes:
    """Compress with `n_shards` shards on `device` (None = "cuda";
    "cpu" runs the plain PyTorch versions of the kernels); returns a
    single RFC 7932 stream. `n_shards=None` means one shard per CUDA
    device on the card, one on the CPU.

    `serializer`: "native" runs the native serializer per shard on host
    threads; "device" plans the symbol stream and packs the payload bits
    on the card (trivial single-tree metablocks, slightly larger).

    `dp`: the ops.optimal.DPConfig of the DP that parses each shard at
    q >= 10 (None = the default v3), in place of the JAX package's
    BROTLI_TPU_DP and the other variables of its DP; the JAX package
    runs v1 off the TPU, which DPConfig(mode="v1") gives.

    An empty input, or one under n_shards * 64 KiB, is one stream of
    the port's one-shot encoder (enc/encoder.encode on `device`), as in
    the JAX package.

    Not ported yet, and raising NotImplementedError: more CUDA devices
    than one with n_shards > 1 (the mesh, ROADMAP M7), gather=
    "collective" (M7/M10), and use_device=False, where the JAX package
    takes its host vectorized matcher (M13, second slice)."""
    dev = resolve(device)
    if gather != "host":
        raise NotImplementedError(
            "gather='collective' (ROADMAP M7/M10)")
    if serializer not in ("native", "device"):
        raise ValueError(f"unknown serializer {serializer!r}")
    if not use_device:
        raise NotImplementedError(
            "use_device=False takes the host vectorized matcher "
            "(ROADMAP M13, second slice)")
    raw = bytes(data)
    arr = np.frombuffer(raw, dtype=np.uint8)
    n = len(arr)
    if n_shards is None:
        n_shards = max(torch.cuda.device_count(), 1) \
            if dev.type == "cuda" else 1
    if n == 0 or n < n_shards * (1 << 16):
        return encode(raw, quality=quality, lgwin=lgwin, device=dev, dp=dp)

    bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
    max_distance = C.max_backward_distance(lgwin)

    # Stage 1: match finding per shard on the card.
    shard_matches = _find_matches_sharded(arr, bounds, max_distance,
                                          quality, dev, dp)

    # split matches at metablock boundaries first: splitting can drop
    # tiny straddlers, and the ring derivation below must see exactly
    # the commands that will be serialized
    mb = 1 << min(22, C.MAX_INPUT_BLOCK_BITS)
    for si in range(n_shards):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        boundaries = list(range(lo + mb, hi, mb)) + [hi]
        m, lens, dists, flags = shard_matches[si]
        shard_matches[si] = matcher.split_matches_at(
            m + lo, lens, dists, flags, boundaries)

    # the decoder's distance ring crosses shard seams: derive each
    # shard's entry ring from the previous shard's matches
    entry_rings = [None]
    for si in range(n_shards - 1):
        _, _, sdists, sflags = shard_matches[si]
        entry_rings.append(bitstream.ring_after(sdists, sflags,
                                                entry_rings[-1]))

    # Stage 2: serialization per shard, each byte-aligned. The native
    # call releases the GIL, so shards serialize natively in parallel;
    # on the card they go one after another
    def serialize(si):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        is_last = si == n_shards - 1
        with trace.stage("serialize"):
            if serializer == "device":
                out = serialize_shard_device(
                    arr, lo, hi, shard_matches[si], entry_rings[si], lgwin,
                    si == 0, is_last, device=dev)
                if out is not None:
                    return out
            return serialize_shard_native(
                raw, lo, hi, shard_matches[si], quality, lgwin,
                entry_rings[si], si == 0, is_last)

    workers = 1 if serializer == "device" else min(n_shards, 8)
    with futures.ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(serialize, range(n_shards)))
    return b"".join(parts)


def _find_matches_sharded(arr, bounds, max_distance, quality, device,
                          dp=None):
    """Per-shard match finding, one shard after another on `device`.
    Match positions are shard-relative."""
    n_shards = len(bounds) - 1
    if device.type == "cuda" and torch.cuda.device_count() >= n_shards > 1:
        raise NotImplementedError(
            "one shard per CUDA device, the mesh (ROADMAP M7)")
    out = []
    for si in range(n_shards):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        shard = arr[lo:hi]
        if quality >= 10:
            out.append(find_matches_optimal(shard, max_distance, base=lo,
                                            device=device, dp=dp))
        else:
            out.append(find_matches_device(shard, max_distance, quality,
                                           base=lo, device=device))
    return out
