"""brotli_tpu_torch: the PyTorch/CUDA port of brotli_tpu.

The device half (the q10/q11 optimal-parse DP) runs as hand-written
CUDA kernels for Hopper (csrc/); the host half is copied from
brotli_tpu, so this package imports neither JAX nor brotli_tpu.
Entry points run on the card unless the caller passes device="cpu".
"""

from .api import compress, decompress, error  # noqa: F401

__version__ = "0.1.0"
