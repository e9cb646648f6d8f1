"""Platform and capability report (counterpart of
brotli_tpu.utils.platform; the c/common/platform.h role).

`info()` answers what this machine can run and which code path each
call takes: the Python, torch and CUDA versions, the visible cards,
whether the native host runtime loads, which CUDA kernel libraries are
already built, and the route of each quality. `configure()` validates
the port's route arguments (`encoder=`, `decoder=`, `serializer=`,
`dp=`, `backend=`, which take the place of the JAX package's BROTLI_TPU_*
variables) and returns the report with them; it sets nothing, since
the port reads no environment variable.
"""

import sys

import torch

from ..enc import encoder as E
from ..format import constants as C

DECODERS = ("native", "python", "device")
SERIALIZERS = ("native", "python", "device")


def routes() -> dict:
    """The route of each quality and entry point, with the thresholds
    read from enc/encoder (the conditions `encode` routes on)."""
    vec, dev = E._VECTOR_THRESHOLD >> 10, E.MIN_DEVICE_INPUT >> 10
    lo, hi = E.HOST_DP_MIN >> 10, E.HOST_DP_MAX >> 20
    win = C.MAX_WINDOW_BITS
    return {
        "q0-q9": f"native one-shot encoder; the Python pipeline "
                 f"(encoder='device' or 'python', base64, serialized "
                 f"dictionaries, a dictionary in modes 1-2, lgwin > "
                 f"{win}): the device matcher (K2) on {vec} KiB or more "
                 f"with backend='auto', else the host vectorized matcher, "
                 f"the greedy host matcher under {vec} KiB, then the "
                 f"Python serializer",
        "q10-q11": f"mode 0, {dev} KiB or more, lgwin <= {win}: the device "
                   f"DP (K1, K3, K4) and the native serializer, else "
                   f"native; the Python pipeline: the device DP on {dev} "
                   f"KiB or more with backend='auto', else the host DP "
                   f"from {lo} KiB to {hi} MiB (the cost-model parse "
                   f"beyond), then the Python serializer",
        "streaming": "Compressor mode 0: the native stream encoder; modes "
                     "1-2: the Python pipeline at each flush",
        "compress_sharded": "device matcher (q<=9) or DP (q>=10) per "
                            "shard, one card per shard where enough are "
                            "visible; use_device=False: the host "
                            "vectorized matcher, 4 shards; serializer "
                            + " | ".join(SERIALIZERS),
        "decompress": "decoder " + " | ".join(DECODERS) + " (native by "
                      "default; device: native parse, LZ resolve K5; "
                      "custom dictionary words: python)",
    }


def native_available() -> bool:
    """True when the native host runtime builds and loads here."""
    from .. import native
    try:
        native.get_lib()
        return True
    except Exception:
        return False


def kernels_built() -> list:
    """The CUDA kernel libraries already built under the package's
    `_build/` (they build at first launch, on a machine with nvcc)."""
    from ..ops import kernels
    return [s for s in kernels.SOURCES if kernels._lib_path(s).exists()]


def info() -> dict:
    """One dict describing what the routes switch on. Keys are stable;
    values are plain Python scalars, lists and dicts, so the report
    can be logged or JSON-serialized as it is."""
    cuda = torch.cuda.is_available()
    return {
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "byteorder": sys.byteorder,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())]
        if cuda else [],
        "native_runtime": native_available(),
        "kernels_built": kernels_built(),
        "routes": routes(),
    }


def configure(encoder=None, decoder=None, serializer=None, dp=None,
              backend=None):
    """Validate the route arguments (None = the default) and return
    `info()` with them under "config". Raises ValueError on an unknown
    value instead of ignoring it."""
    from ..ops.optimal import DPConfig
    if encoder is not None and encoder not in E.ENCODERS:
        raise ValueError(
            f"encoder must be auto|native|device|python: {encoder}")
    if decoder is not None and decoder not in DECODERS:
        raise ValueError(f"decoder must be native|python|device: {decoder}")
    if serializer is not None and serializer not in SERIALIZERS:
        raise ValueError(
            f"serializer must be native|python|device: {serializer}")
    if dp is not None and not isinstance(dp, DPConfig):
        raise ValueError(f"dp must be a DPConfig: {dp!r}")
    if backend is not None and backend not in E.BACKENDS:
        raise ValueError(f"backend must be auto|numpy: {backend}")
    report = info()
    report["config"] = {
        "encoder": encoder or "auto", "decoder": decoder or "native",
        "serializer": serializer or "native",
        "dp": repr(dp if dp is not None else DPConfig()),
        "backend": backend or "auto"}
    return report
