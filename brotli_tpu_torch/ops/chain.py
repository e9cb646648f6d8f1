"""The greedy-parse chain walk (K2), the counterpart of
brotli_tpu.ops.chain_pallas.

The greedy LZ parse is a pointer chase pos -> pos + skip[pos] from
`start`; the walk takes the match at every visited position whose skip
exceeds 1. `chain_select_plain` is the sequential walk itself (the
oracle: speed does not matter); `chain_select` runs it for a tensor on
the CPU and K2 (csrc/chain_select.cu) for a tensor on the card, and on
both returns the error flag unread, for the caller to read when it
collects its results.
"""

import numpy as np
import torch

from . import kernels

CAP = 16  # the largest skip K2 takes


def chain_select_plain(skip, n: int, start: int = 0):
    """sel[i] = 1 iff the chain from `start` visits i and skip[i] > 1;
    int32 (n,) on skip's device. A skip below 1 steps by 1, as the JAX
    package's chain_select_xla does."""
    sk = skip[:n].cpu().numpy().astype(np.int64).tolist()
    taken = []
    pos = int(start)
    while pos < n:
        s = sk[pos]
        if s > 1:
            taken.append(pos)
        pos += max(s, 1)
    sel = np.zeros(n, np.int32)
    sel[taken] = 1
    return torch.from_numpy(sel).to(skip.device)


def chain_select(skip, n: int, start: int = 0):
    """K2: the plain version on the CPU, csrc/chain_select.cu on the
    card. Returns (sel, err): err an int32 (1,) tensor on skip's device,
    non-zero when a skip lies outside [1, 16] (the kernel walks such a
    skip as 1). Nothing here reads err, so nothing waits for the card."""
    if skip.device.type == "cpu":
        bad = ((skip[:n] < 1) | (skip[:n] > CAP)).any()
        return chain_select_plain(skip, n, start), bad.to(torch.int32)[None]
    return kernels.chain_select_launch(skip, n, start)
