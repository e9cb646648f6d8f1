"""Sharded compression (counterpart of brotli_tpu.parallel.shard).

The input splits into shards; each is match-found on a device and
serialized as whole byte-aligned metablock sequences that concatenate
into ONE valid stream (non-last shards end with an empty metadata
block): natively on host threads, with serializer="python" by the
Python serializer (bitstream.store_metablock), or with
serializer="device" on the shard's device
(parallel/device_serialize.py), a shard the device path does not take
going to the native serializer. The decoder's distance ring crosses
shard seams, so each shard's entry ring is derived from
the matches before it.

Two routes, chosen by the JAX package's condition:
- the mesh, where CUDA is asked for and at least n_shards > 1 cards are
  visible: one shard per card, each carrying up to a window of the
  input before it as history (its halo), so matches reach across the
  seams (`_find_matches_mesh` at q<=9, the device matcher and K2;
  ops.optimal.find_matches_optimal_sharded at q>=10, the DP);
- otherwise the shards run one after another on `device`, each from its
  own first byte (the device matcher at q<=9, the DP at q>=10, each
  with the shard's absolute offset as its base).

The mesh functions take a device list, one entry per shard. A list that
names a device more than once queues those shards on it, which is how
the tests (["cpu"] * n) and the one-card smoke (["cuda:0"] * n) run
the code a machine with n cards runs.
"""

import concurrent.futures as futures

import numpy as np
import torch

from ..enc import bitstream, matcher
from ..enc.encoder import _DEFAULT_MB_BITS, encode
from ..format import constants as C
from ..ops.matcher import (_bucket, _post_segment, _run_segment,
                           find_matches_device)
from ..ops.optimal import find_matches_optimal, find_matches_optimal_sharded
from ..utils import trace
from ..utils.device import resolve
from . import serialize_shard_native, serialize_shard_python
from .device_serialize import serialize_shard_device


def compress_sharded(data: bytes, quality: int = 5, lgwin: int = 22,
                     n_shards: int = None, use_device: bool = True,
                     gather: str = "host", serializer: str = "native",
                     device=None, *, dp=None) -> bytes:
    """Compress with `n_shards` shards on `device` (None = "cuda";
    "cpu" runs the plain PyTorch versions of the kernels); returns a
    single RFC 7932 stream. `n_shards=None` means one shard per CUDA
    device on the card, one on the CPU. With CUDA and at least
    n_shards > 1 cards visible, shard i runs on cuda:i (the mesh, see
    the module docstring); otherwise the shards run one after another
    on `device`.

    `gather`: "host" joins the shards' bytes; "collective" gathers the
    ordered payloads from the mesh's cards onto the first and reads them
    back from there (without a mesh, it joins them too).

    `serializer`: "native" runs the native serializer per shard on host
    threads; "python" the Python serializer (bitstream.store_metablock,
    the JAX package's BROTLI_TPU_SERIALIZER=python); "device" plans the
    symbol stream and packs the payload bits on each shard's device
    (trivial single-tree metablocks, slightly larger).

    `dp`: the ops.optimal.DPConfig of the DP that parses each shard at
    q >= 10 (None = the default v3), in place of the JAX package's
    BROTLI_TPU_DP and the other variables of its DP; the JAX package
    runs v1 off the TPU, which DPConfig(mode="v1") gives. The mesh runs
    v3 whatever its mode, as the JAX mesh does
    (ops.optimal.find_matches_optimal_sharded).

    An empty input, or one under n_shards * 64 KiB, is one stream of
    the port's one-shot encoder (enc/encoder.encode on `device`), as in
    the JAX package.

    `use_device=False` finds every shard's matches with the host
    vectorized matcher (4 shards by default, as in the JAX package) and
    resolves no device unless serializer="device" asks for one; an
    input under n_shards * 64 KiB then takes `encode` with
    backend="numpy"."""
    if gather not in ("host", "collective"):
        raise ValueError(f"unknown gather {gather!r}")
    if serializer not in ("native", "device", "python"):
        raise ValueError(f"unknown serializer {serializer!r}")
    with trace.request("compress_sharded", len(data)) as req:
        raw = bytes(data)
        n = len(raw)
        if use_device:
            dev = resolve(device)
            if n_shards is None:
                n_shards = max(torch.cuda.device_count(), 1) \
                    if dev.type == "cuda" else 1
            mesh = _mesh_devices(dev, n_shards)
        else:
            dev = resolve(device) if serializer == "device" else None
            n_shards = 4 if n_shards is None else n_shards
            mesh = None
        if n == 0 or n < n_shards * (1 << 16):
            out = encode(raw, quality=quality, lgwin=lgwin, device=dev,
                         dp=dp, backend="auto" if use_device else "numpy")
        else:
            out = _compress_sharded(raw, quality, lgwin, n_shards, dev,
                                    mesh, gather=gather,
                                    serializer=serializer, dp=dp,
                                    use_device=use_device)
        req.done(len(out))
    return out


def _mesh_devices(device, n_shards):
    """The mesh's device list, [cuda:0, ..., cuda:n_shards-1], where the
    JAX package takes its mesh (a CUDA device asked for, and at least
    n_shards > 1 of them visible; its shard.py:183); else None."""
    if device.type == "cuda" and torch.cuda.device_count() >= n_shards > 1:
        return [torch.device("cuda", i) for i in range(n_shards)]
    return None


def _compress_sharded(raw: bytes, quality, lgwin, n_shards, device, mesh,
                      *, gather="host", serializer="native", dp=None,
                      use_device=True, seg=None):
    """compress_sharded past its checks and routing: match finding (on
    the mesh `mesh`, a device per shard, with mesh=None one shard after
    another on `device`, or with use_device=False by the host vectorized
    matcher), the split at metablock bounds, the entry rings,
    serialization and the gather. The input holds at least
    n_shards * 64 KiB. `seg`: the mesh DP's segment at q >= 10
    (ops.optimal.find_matches_optimal_sharded; None = SEG_V3)."""
    if mesh is not None and len(mesh) != n_shards:
        raise ValueError(f"{len(mesh)} mesh devices for {n_shards} shards")
    arr = np.frombuffer(raw, dtype=np.uint8)
    bounds = np.linspace(0, len(arr), n_shards + 1).astype(np.int64)
    max_distance = C.max_backward_distance(lgwin)

    # Stage 1: match finding per shard.
    if not use_device:
        shard_devs = [device] * n_shards
        shard_matches = _find_matches_host(arr, bounds, max_distance,
                                           quality)
    elif mesh is None:
        shard_devs = [device] * n_shards
        shard_matches = _find_matches_sharded(arr, bounds, max_distance,
                                              quality, device, dp)
    else:
        shard_devs = [resolve(d) for d in mesh]
        if quality >= 10:
            shard_matches = find_matches_optimal_sharded(
                arr, bounds, max_distance, shard_devs, dp=dp, seg=seg)
        else:
            shard_matches = _find_matches_mesh(arr, bounds, max_distance,
                                               quality, shard_devs)
    shard_matches = _split_at_metablocks(shard_matches, bounds,
                                         range(n_shards))

    # the decoder's distance ring crosses shard seams: derive each
    # shard's entry ring from the previous shard's matches
    entry_rings = [None]
    for si in range(n_shards - 1):
        _, _, sdists, sflags = shard_matches[si]
        entry_rings.append(bitstream.ring_after(sdists, sflags,
                                                entry_rings[-1]))

    # Stage 2: serialization per shard, each byte-aligned. The native
    # call releases the GIL, so shards serialize natively in parallel;
    # on the devices they go one after another. The pool's threads work
    # for the caller's request
    carried = trace.carry()

    def serialize(si):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        is_last = si == n_shards - 1
        if serializer == "python":
            # _write_blocks times each metablock under "serialize"
            with trace.adopt(carried):
                return serialize_shard_python(
                    arr, lo, hi, shard_matches[si], quality, lgwin,
                    entry_rings[si], si == 0, is_last)
        with trace.adopt(carried), trace.stage("serialize"):
            if serializer == "device":
                out = serialize_shard_device(
                    arr, lo, hi, shard_matches[si], entry_rings[si], lgwin,
                    si == 0, is_last, device=shard_devs[si])
                if out is not None:
                    return out
            return serialize_shard_native(
                raw, lo, hi, shard_matches[si], quality, lgwin,
                entry_rings[si], si == 0, is_last)

    workers = 1 if serializer == "device" else min(n_shards, 8)
    with futures.ThreadPoolExecutor(max_workers=workers) as ex:
        parts = list(ex.map(serialize, range(n_shards)))
    if gather == "collective":
        return _gather_payloads_collective(parts, shard_devs)
    return b"".join(parts)


def _split_at_metablocks(shard_matches, bounds, shards):
    """Lift the matches of each shard in `shards` to absolute positions
    and split them at its metablock bounds. Splitting can drop tiny
    straddlers, so it comes before the entry rings, which must see
    exactly the commands that will be serialized."""
    mb = 1 << _DEFAULT_MB_BITS
    out = []
    for si, (m, lens, dists, flags) in zip(shards, shard_matches):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        boundaries = list(range(lo + mb, hi, mb)) + [hi]
        out.append(matcher.split_matches_at(m + lo, lens, dists, flags,
                                            boundaries))
    return out


def _gather_payloads_collective(parts, devices):
    """In-order gather of the serialized shard payloads from the shards'
    devices onto the first (the JAX package's shard_map all_gather of
    the sizes and the padded payloads, read back from its first
    replica). With fewer
    distinct devices than payloads there is no mesh to gather over and
    the payloads are joined, as the JAX package does with fewer devices
    than shards."""
    if len(parts) == 1 or len(set(devices)) < len(parts):
        return b"".join(parts)
    return _all_gather_join(parts, devices)


def _all_gather_join(parts, devices):
    """Every payload row and size (each on its shard's device) copied
    onto the first device, where the JAX package reads its replica;
    read back there and joined."""
    sizes = np.array([len(p) for p in parts], np.int64)
    pad = np.zeros((len(parts), int(sizes.max())), np.uint8)
    for i, p in enumerate(parts):
        pad[i, :len(p)] = np.frombuffer(p, np.uint8)
    rows = [torch.from_numpy(pad[i]).to(d) for i, d in enumerate(devices)]
    lens = [torch.from_numpy(sizes[i:i + 1]).to(d)
            for i, d in enumerate(devices)]
    gp = torch.stack([r.to(devices[0]) for r in rows]).cpu().numpy()
    gs = torch.cat([s.to(devices[0]) for s in lens]).cpu().numpy()
    return b"".join(gp[i, :int(gs[i])].tobytes() for i in range(len(parts)))


def _find_matches_sharded(arr, bounds, max_distance, quality, device,
                          dp=None):
    """Per-shard match finding, one shard after another on `device`.
    Match positions are shard-relative."""
    out = []
    for si in range(len(bounds) - 1):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        shard = arr[lo:hi]
        if quality >= 10:
            out.append(find_matches_optimal(shard, max_distance, base=lo,
                                            device=device, dp=dp))
        else:
            out.append(find_matches_device(shard, max_distance, quality,
                                           base=lo, device=device))
    return out


def _find_matches_host(arr, bounds, max_distance, quality):
    """Per-shard match finding by the host vectorized matcher, the JAX
    package's route without a device. Match positions are
    shard-relative."""
    out = []
    for si in range(len(bounds) - 1):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        with trace.stage("match-find"):
            out.append(matcher.find_matches_vectorized(
                arr[lo:hi], max_distance,
                num_candidates=4 if quality >= 5 else 2,
                use_dict=quality >= 5, base=lo))
    return out


def _find_matches_mesh(arr, bounds, max_distance, quality, devices,
                       shards=None):
    """The mesh's match finding (the JAX package's shard_map over
    match_block): shard shards[i] (default: every shard) on devices[i],
    a torch.device.
    Every shard pads to one common bucket holding its halo, up to a
    window of the input before it, as window history (match_block's
    `start`), so its matches reach across the seam; the decoder's
    window is continuous over the stitched stream, which makes those
    distances valid. Every shard is queued before any is read back (one
    device-to-host read each, after its own event); the host then
    extends cap-hit matches and probes the static dictionary, as
    ops.matcher.find_matches_device does. Returns the shards'
    (m, lens, dists, flags), m shard-relative."""
    n_shards = len(bounds) - 1
    if shards is None:
        shards = range(n_shards)
    sizes = [int(bounds[i + 1] - bounds[i]) for i in range(n_shards)]
    # the bucket doubles to make room for the halo
    bucket = _bucket(2 * max(sizes))
    if bucket < max(sizes):  # shard exceeds the largest kernel bucket
        raise ValueError("shard too large for the mesh matcher")
    halos = [min(int(max_distance), int(bounds[i]), bucket - sizes[i])
             for i in range(n_shards)]
    ncand = 4 if quality >= 5 else 2
    handles = []
    for si, dev in zip(shards, devices):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        h = halos[si]
        padded = np.zeros(bucket, np.uint8)
        padded[:h + hi - lo] = arr[lo - h:hi]
        with trace.stage("match.dispatch"):
            handles.append(_run_segment(padded, max(h + hi - lo - 3, 0),
                                        max_distance, ncand, h, dev))
    out = []
    for si, hd in zip(shards, handles):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        h = halos[si]
        out.append(_post_segment(arr[lo - h:hi], hd, h, lo - h,
                                 max_distance, quality >= 5))
    return out
