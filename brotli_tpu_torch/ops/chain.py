"""The greedy-parse chain walk (K2), the counterpart of
brotli_tpu.ops.chain_pallas.

The greedy LZ parse is a pointer chase pos -> pos + skip[pos] from
`start`; the walk takes the match at every visited position whose skip
exceeds 1. `chain_select_plain` is the sequential walk itself (the
oracle: speed does not matter); `chain_select` runs it for a tensor on
the CPU and K2 (csrc/chain_select.cu) for a tensor on the card.
"""

import numpy as np
import torch

from . import kernels


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
    card (skip must lie in [1, 16] there)."""
    if skip.device.type == "cpu":
        return chain_select_plain(skip, n, start)
    return kernels.chain_select(skip, n, start)
