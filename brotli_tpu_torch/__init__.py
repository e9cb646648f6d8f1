"""brotli_tpu_torch: the PyTorch/CUDA port of brotli_tpu.

The device half (the q10/q11 optimal-parse DP, the q<=9 LZ matcher, the
device serializer's bit pack, the device decoder's LZ resolve) runs as
hand-written CUDA kernels for Hopper (csrc/); the host half is a copy
of brotli_tpu's, so this package imports neither JAX nor brotli_tpu.
Device entry points run on the card unless the caller passes
device="cpu"; the native routes of the public API need no card. The
sharded encoders take one shard per card where several are visible
(parallel.shard) or one set of shards per process
(parallel.multihost).

Public API as brotli_tpu's (python/brotli.py of the reference):
``compress``, ``decompress``, ``decompress_concatenated``,
``Compressor``, ``Decompressor``, ``error``; ``DPConfig`` chooses the
device DP's variant (``compress(..., dp=DPConfig(mode="v1"))``). The
Python decoder (``decompress(..., decoder="python")``) and serializer
(``compress(..., encoder="device")``) are copies of brotli_tpu's.
"""

from .api import (  # noqa: F401
    set_reporting_callbacks,
    MODE_GENERIC,
    MODE_TEXT,
    MODE_FONT,
    Compressor,
    Decompressor,
    compress,
    decompress,
    decompress_concatenated,
    error,
    estimate_peak_memory,
)
from .ops.optimal import DPConfig  # noqa: F401

__version__ = "0.1.0"
version = __version__  # parity: python/brotli.py `version`
