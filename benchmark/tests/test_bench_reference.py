"""The plain reference: round trips of the port's native streams, the
window bits it reads, and that it imports nothing of the program, jax
or the JAX package."""

import json
import subprocess
import sys

import pytest

from benchmark import core, reference


@pytest.mark.parametrize("quality,lgwin", [(1, 16), (5, 22), (9, 18),
                                           (11, 22), (5, 24)])
def test_reference_round_trips_native_streams(quality, lgwin):
    from brotli_tpu_torch import native
    gen = core.load_module("gen", "smoke_corpus")
    doc = gen.document(150_000, quality)
    stream = native.encode(doc, quality, lgwin)
    assert reference.window_bits(stream) == lgwin
    assert reference.decompress(stream) == doc


def test_reference_rejects_a_broken_stream():
    from brotli_tpu_torch import native
    t = core.load_json("traffic", "logs16m")
    params = {k: v for k, v in t["params"].items()
              if k not in ("doc_bytes", "pool")}
    doc = core.load_module("gen", t["gen"]).document(50_000, 1, **params)
    stream = bytearray(native.encode(doc, 5, 22))
    stream[len(stream) // 2] ^= 0xFF
    try:
        out = reference.decompress(bytes(stream))
    except reference.FormatError:
        return
    assert out != doc


@pytest.mark.parametrize("module", ["benchmark.reference", "benchmark.check",
                                    "benchmark.core", "benchmark.run"])
def test_harness_modules_load_no_program_or_jax(module):
    """Top-level names compared whole: brotli_tpu_torch begins with
    brotli_tpu, and neither may be loaded by these imports."""
    code = (f"import sys, json, {module}; print(json.dumps(sorted("
            f"{{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=core.ROOT).stdout
    top = set(json.loads(out.splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "brotli_tpu",
                      "brotli_tpu_torch", "torch"}
