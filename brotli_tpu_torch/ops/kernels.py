"""Build, bind and launch the hand-written Hopper kernels of csrc/.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library
with a plain C interface under `brotli_tpu_torch/_build/` at first use
(all sources in parallel; a source is stale when it or a header it
includes, `HEADERS`, is newer than its library), and is bound with
ctypes. A launch runs on PyTorch's current stream, allocates nothing
itself, and the C side returns cudaGetLastError(); a non-zero code
raises. LAUNCHES counts the launches of each kernel; SLOW holds the last
K7 and K8 launch's int32 (1,) count of the steps that took the kernel's
slow path (K7: a step whose sums may wrap runs the exact slot loop; K8:
a ring the look-ahead did not cover is compared on the chain), on the
card, unread.

nvcc is looked up only when a kernel is first needed, so the package
imports on machines without the CUDA toolkit.
"""

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from ..utils import filelock

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("suffix_min", "dp_scan", "dp_backtrack", "chain_select",
           "bitpack", "lz_resolve", "dp_scan_v1", "dp_scan_ring",
           "edge_keys", "edge_ranks", "edge_slots", "dict_probe")
# the csrc/ headers a source includes
HEADERS = {"dict_probe": ("dict_probe.h",)}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

W = 64
B = 4096
MAX_SLOTS = 64      # suffix_min.cu's, dp_scan_v1.cu's and edge_slots.cu's
                    # most edge slots
MAX_RANKS = 16      # edge_ranks.cu's most ranks a level, and the words
                    # of a level's row (64 bytes, zero-padded)
MAX_RANK = 512      # its largest rank (the halo of a tile of sorted rows)
MAX_LEVELS = 3      # its row pass's most levels
EDGE_TILE = 4096    # edge_slots.cu's positions per CTA
EDGE_MAX_SYMS = 520  # its most distance symbols: NPOSTFIX 3, NDIRECT 120
CHAIN_L = 4096      # chain_select.cu's chunk: n is a multiple of it
CHAIN_S = 256       # its sub-chunk: the longest walk of one thread
PACK_TILE = 4096    # bitpack.cu's fields per CTA
PACK_TABLE = 2 * (256 + 704 + 64)  # its code table: code and length of
                                   # the literal, command, distance trees
DICT_TILE = 2048    # dict_probe.cu's positions per CTA

LAUNCHES = {"suffix_min": 0, "dp_scan": 0, "dp_backtrack": 0,
            "chain_select": 0, "bitpack": 0, "lz_resolve": 0,
            "dp_scan_v1": 0, "dp_scan_ring": 0, "edge_keys": 0,
            "edge_ranks": 0, "edge_rows": 0, "edge_slots": 0,
            "dict_probe": 0}
SLOW = {"dp_scan_v1": None, "dp_scan_ring": None}

_libs = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_SIGNATURES = {
    "btt_suffix_min": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                       _P],
    "btt_dp_scan": [_P, _P, _P, ctypes.c_int, _P],
    "btt_dp_scan_v1": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       _P],
    "btt_dp_scan_ring": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                         ctypes.c_longlong, _P],
    "btt_dp_backtrack": [_P, _P, _P, ctypes.c_int, _P],
    "btt_chain_select": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                         _P],
    "btt_bitpack": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P,
                    ctypes.c_longlong, _P, _P],
    "btt_lz_resolve": [_P, ctypes.c_longlong, _P, _P, _P, _P, _P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                       _P, _P],
    "btt_edge_keys": [_P, _P, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_int, _P],
    "btt_edge_ranks": [_P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       _P],
    "btt_edge_rows": [_P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P],
    "btt_edge_slots": [_P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P,
                       ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    "btt_dict_probe": [_P, ctypes.c_longlong, ctypes.c_ulonglong,
                       ctypes.c_ulonglong, _P, _P, ctypes.c_longlong, _P, _P,
                       ctypes.c_longlong, _P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not pathlib.Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                           "to build the kernels")
    return nvcc


def _lib_path(name: str) -> pathlib.Path:
    return _BUILD / f"lib{name}.so"


def build(extra_flags=()) -> dict:
    """Compile every stale kernel library, one nvcc per source, all
    started together. Returns {source: compiler output} for the
    sources it compiled; raises with the compiler's output on
    failure.

    The staleness check and the compiles hold a lock on a file in
    `_build/` that other processes take too, and nvcc writes temporary
    files that replace the libraries once all have compiled, so a
    process never loads a library that another is still writing."""
    _BUILD.mkdir(exist_ok=True)
    with _lock, filelock.locked(_BUILD / "build.lock"):
        stale = [s for s in SOURCES
                 if not _lib_path(s).exists() or
                 _lib_path(s).stat().st_mtime <
                 max((_CSRC / f).stat().st_mtime
                     for f in (f"{s}.cu",) + HEADERS.get(s, ()))]
        if not stale:
            return {}
        nvcc = _nvcc()
        tmp = {s: _BUILD / f"lib{s}.{os.getpid()}.tmp.so" for s in stale}
        try:
            procs = {s: subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp[s]),
                 str(_CSRC / f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for s in stale}
            logs = {s: p.communicate()[0] for s, p in procs.items()}
            bad = [s for s, p in procs.items() if p.returncode != 0]
            if bad:
                raise RuntimeError("nvcc failed:\n" +
                                   "\n".join(logs[s] for s in bad))
            for s in stale:
                os.replace(tmp[s], _lib_path(s))
        finally:
            for t in tmp.values():
                t.unlink(missing_ok=True)
        return logs


def _fn(source: str, symbol: str):
    with _lock:
        lib = _libs.get(source)
    if lib is None:
        build()
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(source)))
                for sym, args in _SIGNATURES.items():
                    if hasattr(lib, sym):
                        getattr(lib, sym).argtypes = args
                        getattr(lib, sym).restype = ctypes.c_int
                _libs[source] = lib
    return getattr(lib, symbol)


def _check(t: torch.Tensor, name: str, ndim: int,
           dtype=torch.int32) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: expected a CUDA tensor, got "
                           f"{t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"{ndim} dims, got {t.dtype} {tuple(t.shape)}")


def _count(name: str) -> None:
    # several host threads launch at once (the mesh's shards), and a
    # bare += can lose one of their counts
    with _lock:
        LAUNCHES[name] += 1


def _launch(source, symbol, device, *args) -> None:
    fn = _fn(source, symbol)
    with torch.cuda.device(device):
        # the raw cudaStream_t, without building a torch.cuda.Stream
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")


def suffix_min(pd_flat, cs_flat, copyq):
    """K1 on the card: (nslots, n) int32 slots -> (n, 2W) int32."""
    _check(pd_flat, "pd_flat", 2)
    _check(cs_flat, "cs_flat", 2)
    _check(copyq, "copyq", 1)
    nslots, n = pd_flat.shape
    if cs_flat.shape != pd_flat.shape or copyq.shape[0] < W or \
            not 2 <= nslots <= MAX_SLOTS:
        raise ValueError("suffix_min: bad shapes")
    out = torch.empty((n, 2 * W), dtype=torch.int32, device=pd_flat.device)
    _launch("suffix_min", "btt_suffix_min", pd_flat.device,
            pd_flat.data_ptr(), cs_flat.data_ptr(), copyq.data_ptr(),
            out.data_ptr(), nslots, n)
    _count("suffix_min")
    return out


def dp_scan(mp, litq):
    """K3 on the card: (n, 2W) rows + (n,) literal costs -> int32
    paymat (n // B, B + 1)."""
    _check(mp, "mp", 2)
    _check(litq, "litq", 1)
    n = mp.shape[0]
    if mp.shape[1] != 2 * W or n % B or litq.shape[0] != n:
        raise ValueError("dp_scan: bad shapes")
    nb = n // B
    paymat = torch.empty((nb, B + 1), dtype=torch.int32, device=mp.device)
    _launch("dp_scan", "btt_dp_scan", mp.device, mp.data_ptr(),
            litq.data_ptr(), paymat.data_ptr(), nb)
    _count("dp_scan")
    return paymat


def dp_scan_v1(pd_flat, cs_flat, litq, copyq):
    """K7 on the card: (nslots, n) int32 slots, (n,) literal costs and
    the copy costs (>= W,) -> int32 paymat (n // B, B + 1). The slots
    are copied 16 bytes at a time, so both start on a 16-byte
    boundary."""
    _check(pd_flat, "pd_flat", 2)
    _check(cs_flat, "cs_flat", 2)
    _check(litq, "litq", 1)
    _check(copyq, "copyq", 1)
    nslots, n = pd_flat.shape
    if cs_flat.shape != pd_flat.shape or litq.shape[0] != n or n % B or \
            not 0 < n < 1 << 31 or copyq.shape[0] < W or \
            not 1 <= nslots <= MAX_SLOTS:
        raise ValueError("dp_scan_v1: bad shapes")
    if pd_flat.data_ptr() % 16 or cs_flat.data_ptr() % 16:
        raise ValueError("dp_scan_v1: slots must start on 16 bytes")
    nb = n // B
    dev = pd_flat.device
    paymat = torch.empty((nb, B + 1), dtype=torch.int32, device=dev)
    slow = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("dp_scan_v1", "btt_dp_scan_v1", dev, pd_flat.data_ptr(),
            cs_flat.data_ptr(), litq.data_ptr(), copyq.data_ptr(),
            paymat.data_ptr(), slow.data_ptr(), nslots, nb)
    _count("dp_scan_v1")
    SLOW["dp_scan_v1"] = slow
    return paymat


def dp_scan_ring(mp, litq, data, ring_init, ring_cost, copyq, icell, npos):
    """K8 on the card: (n, 2W) rows of K1, (n,) literal costs, the
    segment's uint8 bytes (n,), the entry ring of each block (nb,), the
    ring code's cost (>= 1,), the copy costs (>= W,) and the
    implicit-cell row (>= W,) or None -> int32 paymat (n // B, B + 1)."""
    _check(mp, "mp", 2)
    _check(litq, "litq", 1)
    _check(data, "data", 1, torch.uint8)
    _check(ring_init, "ring_init", 1)
    _check(ring_cost, "ring_cost", 1)
    _check(copyq, "copyq", 1)
    if icell is not None:
        _check(icell, "icell", 1)
    n = mp.shape[0]
    nb = n // B
    if mp.shape[1] != 2 * W or n % B or not 0 < n < 1 << 31 or \
            litq.shape[0] != n or data.shape[0] != n or \
            ring_init.shape[0] != nb or ring_cost.shape[0] < 1 or \
            copyq.shape[0] < W or (icell is not None and
                                   icell.shape[0] < W):
        raise ValueError("dp_scan_ring: bad shapes")
    paymat = torch.empty((nb, B + 1), dtype=torch.int32, device=mp.device)
    slow = torch.zeros(1, dtype=torch.int32, device=mp.device)
    _launch("dp_scan_ring", "btt_dp_scan_ring", mp.device, mp.data_ptr(),
            litq.data_ptr(), data.data_ptr(), ring_init.data_ptr(),
            ring_cost.data_ptr(), copyq.data_ptr(),
            None if icell is None else icell.data_ptr(),
            paymat.data_ptr(), slow.data_ptr(), nb, int(npos))
    _count("dp_scan_ring")
    SLOW["dp_scan_ring"] = slow
    return paymat


def dp_backtrack(paymat):
    """K4 on the card: paymat (nb, B + 1) -> int32 (B, nb) global match
    starts (-1 = none) and payloads, the two halves of one allocation.
    The walk's scratch is the kernel's shared memory; nothing else is
    allocated."""
    _check(paymat, "paymat", 2)
    nb = paymat.shape[0]
    if paymat.shape[1] != B + 1 or nb * B >= 1 << 31:
        raise ValueError("dp_backtrack: bad shapes")
    gsrc, vals = torch.empty((2, B, nb), dtype=torch.int32,
                             device=paymat.device)
    _launch("dp_backtrack", "btt_dp_backtrack", paymat.device,
            paymat.data_ptr(), gsrc.data_ptr(), vals.data_ptr(), nb)
    _count("dp_backtrack")
    return gsrc, vals


def chain_select_launch(skip, n, start):
    """K2 on the card, without reading its error flag: int32 skip (n,)
    -> (sel int32 (n,), err int32 (1,)), err non-zero when a skip lay
    outside [1, 16]. One launch; sel and one scratch allocation (two
    64-bit descriptor words a chunk, the ticket and err, zeroed by the C
    side). Nothing waits for the card here."""
    _check(skip, "skip", 1)
    if skip.shape[0] != n or n % CHAIN_L or not 0 < n < 1 << 31:
        raise ValueError(f"chain_select: n must be a multiple of {CHAIN_L} "
                         f"below 2**31 and equal skip's length")
    if start < 0:
        raise ValueError("chain_select: start must be >= 0")
    dev = skip.device
    nchunks = n // CHAIN_L
    sel = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * nchunks + 2, dtype=torch.int32, device=dev)
    _launch("chain_select", "btt_chain_select", dev, skip.data_ptr(),
            sel.data_ptr(), scratch.data_ptr(), n, int(start))
    _count("chain_select")
    return sel, scratch[-1:]


def bitpack(vals, markers, tables, bit0: int, cap_words: int,
            stats: bool = False):
    """K6 on the card: int32 fields (vals, markers) (n,) and the six
    int32 code tables (literal code and length (256,), command (704,),
    distance (64,)) -> (words int32 (cap_words,) of u32 bit patterns,
    total bits int64 0-dim, mod 2**32); with `stats`, also the count of
    tiles that took the slow path (int64 0-dim). One launch; one
    allocation holds the tiles' descriptors, the ticket, that count and
    the total; the words are zeroed on the C side."""
    _check(vals, "vals", 1)
    _check(markers, "markers", 1)
    for t in tables:
        _check(t, "code table", 1)
    n = vals.shape[0]
    tab = torch.cat(tables)
    if markers.shape[0] != n or tab.shape[0] != PACK_TABLE or \
            n >= 1 << 31 or cap_words <= 0 or not 0 <= bit0 < 32:
        raise ValueError("bitpack: bad shapes or arguments")
    dev = vals.device
    words = torch.empty(cap_words, dtype=torch.int32, device=dev)
    ntiles = max(1, -(-n // PACK_TILE))
    scratch = torch.empty(ntiles + 3, dtype=torch.int64, device=dev)
    _launch("bitpack", "btt_bitpack", dev, vals.data_ptr(),
            markers.data_ptr(), tab.data_ptr(), n, bit0, words.data_ptr(),
            cap_words, scratch.data_ptr())
    _count("bitpack")
    if stats:
        return words, scratch[-1], scratch[-2]
    return words, scratch[-1]


def lz_resolve(lits, nlit, ncopy, dist, n_out: int, n_steps: int,
               stats: bool = False):
    """K5 on the card: uint8 literals (L >= 1,) and int32 commands
    (nlit, ncopy, dist) (ncmd,) -> (uint8 out (n_out,), err), err an
    int64 (1,) non-zero when a copy's source lay outside [0, j). With
    `stats`, also an int64 (3,) tensor: the positions left unresolved
    after the tile collapse, the hops of the global jumps and the most
    hops of one position. The command prefix sums are torch cumsums
    (int32, as in the JAX code); the states are 8 bytes a position, so
    n_out < 2**31. Nothing waits for the card."""
    _check(lits, "lits", 1, torch.uint8)
    for t, name in ((nlit, "nlit"), (ncopy, "ncopy"), (dist, "dist")):
        _check(t, name, 1)
    ncmd = nlit.shape[0]
    if lits.shape[0] < 1 or ncopy.shape[0] != ncmd or \
            dist.shape[0] != ncmd or not 0 < ncmd < 1 << 31 or \
            not 0 < n_out < 1 << 31 or n_steps < 0:
        raise ValueError("lz_resolve: bad shapes or arguments")
    dev = lits.device
    ends = torch.cumsum(nlit + ncopy, 0, dtype=torch.int32)
    lit_off = torch.cumsum(nlit, 0, dtype=torch.int32) - nlit
    states = torch.empty(n_out, dtype=torch.int64, device=dev)
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    cnt = torch.empty(4, dtype=torch.int64, device=dev)
    _launch("lz_resolve", "btt_lz_resolve", dev, lits.data_ptr(),
            lits.shape[0], nlit.data_ptr(), ncopy.data_ptr(),
            dist.data_ptr(), ends.data_ptr(), lit_off.data_ptr(), ncmd,
            n_out, n_steps, states.data_ptr(), out.data_ptr(),
            cnt.data_ptr())
    _count("lz_resolve")
    return (out, cnt[:1], cnt[1:]) if stats else (out, cnt[:1])


def edge_keys(data, npos, plen, wide=False):
    """K9 on the card: the segment's uint8 bytes (n,), 16-byte aligned
    with n a multiple of 16 (a bucket), -> the int32 (n,) sort keys (the
    JAX uint32 key - 2**31; with `wide`, the hash's top 31 bits) of the
    level of `plen` prefix bytes (4, 8 or 16) below the level's `npos`
    (ops.optimal.edge_keys_plain)."""
    _check(data, "data", 1, torch.uint8)
    n = data.shape[0]
    if not 16 <= n < 1 << 31 or n % 16 or data.data_ptr() % 16 or \
            plen not in (4, 8, 16):
        raise ValueError("edge_keys: bad shapes or arguments")
    key = torch.empty(n, dtype=torch.int32, device=data.device)
    _launch("edge_keys", "btt_edge_keys", data.device, data.data_ptr(),
            key.data_ptr(), n, plen, int(npos), int(wide))
    _count("edge_keys")
    return key


def edge_ranks(key_s, order, data, npos, max_distance, ranks, words,
               base=0, row0=0, wide=False):
    """K10's level launch on the card: a level's stably sorted int32 keys
    and their int64 order (n,), the uint8 bytes (n,) (16-byte aligned, n
    a multiple of 16) -> the level's candidates (len << 25 | dist) of
    the positions from `row0` on, in position order, into the int32
    `words` (n - row0, MAX_RANKS), 16-byte aligned, zero past
    len(ranks); the row0 positions before are history only. `base`: the
    stream position of the first byte; `wide`: the keys are K9's wide
    ones, compared whole (ops.optimal.edge_ranks_plain)."""
    _check(key_s, "key_s", 1)
    _check(order, "order", 1, torch.int64)
    _check(data, "data", 1, torch.uint8)
    _check(words, "words", 2)
    n = key_s.shape[0]
    nranks = len(ranks)
    if order.shape[0] != n or data.shape[0] != n or \
            not 0 <= row0 < n or \
            words.shape != (n - row0, MAX_RANKS) or words.data_ptr() % 16 or \
            data.data_ptr() % 16 or n % 16 or not 32 <= n < 1 << 31 or \
            not 1 <= nranks <= MAX_RANKS or min(ranks) < 1 or \
            max(ranks) > MAX_RANK:
        raise ValueError("edge_ranks: bad shapes or arguments")
    rk = (ctypes.c_int * nranks)(*ranks)
    _launch("edge_ranks", "btt_edge_ranks", key_s.device, key_s.data_ptr(),
            order.data_ptr(), data.data_ptr(), words.data_ptr(), n, rk,
            nranks, int(npos), int(max_distance), int(base), int(row0),
            int(wide))
    _count("edge_ranks")


def edge_rows(words, nranks):
    """K10's row pass on the card: the levels' rows (int32 (nlevels, n,
    MAX_RANKS), 16-byte aligned) -> the int32 (n, sum(nranks)) candidate
    table, each level's first nranks[l] words of a row side by side."""
    _check(words, "words", 3)
    nlevels, n, stride = words.shape
    if len(nranks) != nlevels or not 1 <= nlevels <= MAX_LEVELS or \
            not all(1 <= r <= MAX_RANKS for r in nranks) or \
            stride != MAX_RANKS or words.data_ptr() % 16 or \
            not 0 < n < 1 << 31:
        raise ValueError("edge_rows: bad shapes or arguments")
    out = torch.empty((n, sum(nranks)), dtype=torch.int32,
                      device=words.device)
    nr = (ctypes.c_int * nlevels)(*nranks)
    _launch("edge_ranks", "btt_edge_rows", words.device, words.data_ptr(),
            out.data_ptr(), n, nr, nlevels)
    _count("edge_rows")
    return out


def edge_slots(cand, data, max_distance, dist_sym_bits_q, seed_pos,
               seed_len, seed_dist, lit_tab, ctx_tab=None, dict_pos=None,
               dict_pay=None, seg_base=0, dist_params=(0, 0)):
    """K11 on the card: K10's int32 candidates (n, ncand), the uint8
    bytes (n,), the int64 seed matches and (v3, `ctx_tab` given) the
    int64 dictionary hits, the int32 distance-symbol costs of
    `dist_params` (npostfix, ndirect; 16 + ndirect + (48 << npostfix) of
    them, 64 at (0, 0)) and the literal tables (v3: (64*256,) bits and
    (256*256,) contexts; v1: the (256*256,) [p1, byte] costs) -> int32
    pd_flat and cs_flat (nslots, n), litq and dist_fill (n,). One C
    call: two memsets of its scratch (one allocation), the scatter
    kernel and the slot kernel."""
    v3 = ctx_tab is not None
    npostfix, ndirect = dist_params
    nsym = 16 + ndirect + (48 << npostfix)
    _check(cand, "cand", 2)
    _check(data, "data", 1, torch.uint8)
    _check(dist_sym_bits_q, "dist_sym_bits_q", 1)
    _check(lit_tab, "lit_tab", 1)
    seeds = (seed_pos, seed_len, seed_dist)
    for t, name in zip(seeds, ("seed_pos", "seed_len", "seed_dist")):
        _check(t, name, 1, torch.int64)
    if v3:
        _check(ctx_tab, "ctx_tab", 1)
        _check(dict_pos, "dict_pos", 1, torch.int64)
        _check(dict_pay, "dict_pay", 1, torch.int64)
    n, ncand = cand.shape
    nslots = ncand + (2 if v3 else 1)
    ns = seed_pos.shape[0]
    nd = dict_pos.shape[0] if v3 else 0
    if data.shape[0] != n or not 0 < n < 1 << 31 or \
            not 1 <= ncand <= MAX_SLOTS - 2 or nslots > MAX_SLOTS or \
            not 0 <= npostfix <= 3 or not 0 <= ndirect <= 15 << npostfix or \
            ndirect % (1 << npostfix) or \
            dist_sym_bits_q.shape[0] < nsym or nsym > EDGE_MAX_SYMS or \
            seed_len.shape[0] != ns or seed_dist.shape[0] != ns or \
            lit_tab.shape[0] != (64 * 256 if v3 else 256 * 256) or \
            (v3 and (ctx_tab.shape[0] != 256 * 256 or
                     dict_pay.shape[0] != nd)):
        raise ValueError("edge_slots: bad shapes")
    dev = cand.device
    pd_flat, cs_flat = torch.empty((2, nslots, n), dtype=torch.int32,
                                   device=dev)
    litq, dist_fill = torch.empty((2, n), dtype=torch.int32, device=dev)
    ntiles = -(-n // EDGE_TILE)
    scratch = torch.empty(3 * n + ntiles, dtype=torch.int64, device=dev)
    _launch("edge_slots", "btt_edge_slots", dev, cand.data_ptr(),
            data.data_ptr(), seed_pos.data_ptr(), seed_len.data_ptr(),
            seed_dist.data_ptr(), ns,
            dict_pos.data_ptr() if v3 else None,
            dict_pay.data_ptr() if v3 else None, nd,
            dist_sym_bits_q.data_ptr(), lit_tab.data_ptr(),
            ctx_tab.data_ptr() if v3 else None, pd_flat.data_ptr(),
            cs_flat.data_ptr(), litq.data_ptr(), dist_fill.data_ptr(),
            scratch.data_ptr(), n, ncand, int(max_distance), int(seg_base),
            npostfix, ndirect)
    _count("edge_slots")
    return pd_flat, cs_flat, litq, dist_fill


def dict_probe(data, n, gates, base, max_distance, image):
    """K12 on the card: the static-dictionary probe of the uint8 bytes
    data[:n] (16-byte aligned) wherever no int32 gate interval
    [gates[0, i], gates[1, i]) covers the position (sorted, disjoint:
    native.probe_gates), over the uint8 table image
    (native.dict_index_image, 16-byte aligned), as
    native.dict_probe_all at `base` and `max_distance` -> int32 out
    (2 + 2 cap,): out[0] the count of hits, out[2:2 + cap] their
    positions and out[2 + cap:] their payloads in position order, both
    written only when the count is at most cap = max(n // 8 + 64, 1024).
    One C call: the probe, the scan of its tiles' counts, the ordered
    scatter; one scratch allocation, n int32 rounded up to a tile and
    two more a tile."""
    _check(data, "data", 1, torch.uint8)
    _check(gates, "gates", 2)
    _check(image, "image", 1, torch.uint8)
    if not 1 <= n <= data.shape[0] or n >= 1 << 31 or \
            gates.shape[0] != 2 or data.data_ptr() % 16 or \
            image.data_ptr() % 16 or base < 0 or max_distance < 0:
        raise ValueError("dict_probe: bad shapes or arguments")
    dev = data.device
    cap = max(n // 8 + 64, 1024)
    ntiles = -(-n // DICT_TILE)
    scratch = torch.empty(ntiles * (DICT_TILE + 2), dtype=torch.int32,
                          device=dev)
    out = torch.empty(2 + 2 * cap, dtype=torch.int32, device=dev)
    _launch("dict_probe", "btt_dict_probe", dev, data.data_ptr(), n,
            int(base), int(max_distance), image.data_ptr(),
            gates.data_ptr(), gates.shape[1], scratch.data_ptr(),
            out.data_ptr(), cap)
    _count("dict_probe")
    return out


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
