"""The benchmark's own tests: on the CPU, the generators, the reference,
the window arithmetic, the rooflines, the readers and the check's faults;
tests marked `card` run a cell on a CUDA device and skip without one.

    python3 -m pytest benchmark/tests -q
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips on a machine without one")
