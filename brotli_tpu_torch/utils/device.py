"""Device resolution for the port's entry points (the role of
brotli_tpu.utils.jaxcfg.backend_or_cpu).

`None` means the card. There is no quiet fallback: asking for CUDA on
a machine without it raises, and only an explicit "cpu" runs the plain
PyTorch versions of the kernels.
"""

import torch


def resolve(device=None) -> torch.device:
    """`None` -> "cuda"; raises RuntimeError when CUDA is requested but
    unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "brotli_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"brotli_tpu_torch: unsupported device {dev}")
    return dev
