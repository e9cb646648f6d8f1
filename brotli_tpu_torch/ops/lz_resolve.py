"""LZ copy resolution by log-step pointer doubling (counterpart of
brotli_tpu.ops.lz_resolve; reference role: c/dec/decode.c:2401
ProcessCommands' byte movement).

The native symbol parse (native.parse_stream) gives a command list
(nlit, ncopy, dist) plus the flat literal stream; every output byte
either IS a literal (a fixed point) or points `dist` bytes back, and
pointer doubling (src = src[src], out of place) halves every chain's
depth a round, so ceil(log2(depth)) rounds resolve them all.
`resolve_plain` is the JAX package's `_resolve` in torch ops; `resolve`
runs it for the CPU and K5 (csrc/lz_resolve.cu) on the card. After
n_steps out-of-place rounds a position holds its chain's literal where
its copy depth is at most 2**n_steps, else 0; K5 computes every
position's literal and exact depth instead of doubling, and applies
that rule, so its bytes equal the doubling's at every round count.
"""

import numpy as np
import torch

from ..utils.device import resolve as resolve_device
from . import kernels


def resolve_plain(lits, nlit, ncopy, dist, n_out: int, n_steps: int):
    """uint8 (n_out,) output of the command list on the inputs' device:
    lits uint8 (L >= 1,), nlit/ncopy/dist int32 (ncmd,). Raises
    ValueError for a copy whose source is not in [0, j), which the
    native parse never emits."""
    i32 = torch.int32
    adv = nlit + ncopy
    ends = torch.cumsum(adv, 0, dtype=i32)
    starts = ends - adv
    lit_off = torch.cumsum(nlit, 0, dtype=i32) - nlit
    j = torch.arange(n_out, dtype=i32, device=lits.device)
    ci = torch.searchsorted(ends, j, right=True, out_int32=True)
    off = j - starts[ci]
    is_lit = off < nlit[ci]
    # literal value per position (defined only where is_lit)
    litval = lits[(lit_off[ci] + off).clamp(0, lits.shape[0] - 1)]
    d = dist[ci]
    if bool((~is_lit & ((d < 1) | (d > j))).any()):
        raise ValueError("lz_resolve: a copy reaches before the output")
    # copy source pointer; literals are fixed points
    src = torch.where(is_lit, j, j - d)
    for _ in range(n_steps):
        src = src[src]
    return torch.where(is_lit[src], litval[src], 0).to(torch.uint8)


def n_steps_for(n_out: int, max_depth=None) -> int:
    """Doubling rounds: ceil(log2(n_out)), cut to the bit length of the
    copy-chain depth bound when the parser measured one (the native
    parse does)."""
    n_steps = max(1, int(np.ceil(np.log2(n_out))))
    if max_depth is not None and 0 < max_depth < (1 << 30):
        n_steps = min(n_steps, max(1, int(max_depth).bit_length()))
    return n_steps


def resolve(lits: bytes, nlit, ncopy, dist, max_depth=None,
            device=None) -> bytes:
    """Resolve the deferred-LZ command list into output bytes on
    `device` (None = "cuda"; "cpu" runs `resolve_plain`). Raises
    ValueError on a copy that reaches before the output."""
    dev = resolve_device(device)
    nlit = np.asarray(nlit, np.int32)
    ncopy = np.asarray(ncopy, np.int32)
    dist = np.asarray(dist, np.int32)
    n_out = int(nlit.sum(dtype=np.int64) + ncopy.sum(dtype=np.int64))
    if n_out == 0:
        return b""
    if n_out >= 1 << 31:
        raise ValueError("lz_resolve: the output must stay under 2 GiB")
    n_steps = n_steps_for(n_out, max_depth)
    la = np.frombuffer(bytes(lits), np.uint8)
    if len(la) == 0:
        la = np.zeros(1, np.uint8)  # gather base for all-copy streams
    la = torch.from_numpy(la.copy()).to(dev)
    cmds = torch.from_numpy(np.stack([nlit, ncopy, dist])).to(dev)
    if dev.type == "cpu":
        out = resolve_plain(la, cmds[0], cmds[1], cmds[2], n_out, n_steps)
    else:
        out, err = kernels.lz_resolve(la, cmds[0], cmds[1], cmds[2], n_out,
                                      n_steps)
        out = out.cpu()
        if int(err.item()):
            raise ValueError("lz_resolve: a copy reaches before the output")
    return out.numpy().tobytes()


def copy_list(nlit, ncopy, dist):
    """The canonical form of a command list: (output position, length,
    distance) of every copy, int64 (k, 3). Parses that split literal
    runs differently (the native parse rolls literals and dictionary
    words into the next copy, the Python deferred parse emits them as
    literal-only commands) describe the same copy graph exactly when
    their literal streams and copy lists are equal."""
    nlit, ncopy, dist = (np.asarray(a, np.int64) for a in (nlit, ncopy, dist))
    pos = np.cumsum(nlit + ncopy) - ncopy
    keep = ncopy > 0
    return np.stack([pos[keep], ncopy[keep], dist[keep]], axis=1)
