"""32-bit unsigned lane helpers.

PyTorch on the CPU implements neither shifts nor comparisons nor `min`
on torch.uint32, so uint32 lanes of the JAX code ride in int64 tensors
holding values in [0, 2**32). Every helper keeps that invariant and is
exact: no step overflows int64 and none goes through floating point.
"""

import torch

MASK32 = 0xFFFFFFFF


def mul(a: torch.Tensor, b: int) -> torch.Tensor:
    """Wrapping uint32 multiply of lanes `a` by the constant `b`. The
    constant is split into 16-bit halves so no partial product exceeds
    2**48 (int64 multiply never overflows)."""
    lo = b & 0xFFFF
    hi = (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of uint32 lanes (non-negative int64)."""
    return a >> k


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative lanes below 2**32 (the
    `32 - clz(v)` of the JAX code), by binary search on the value."""
    v = v.to(torch.int64)
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (v >> s) > 0
        n = n + torch.where(big, s, 0)
        v = torch.where(big, v >> s, v)
    return n + (v > 0).to(torch.int64)
