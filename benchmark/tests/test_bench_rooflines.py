"""Every roofline file returns chip_smoke.py's counts at the smoke's
shapes (frozen here as that script's expressions), and their bounds the
kernel table's (PERF.md, at 3.35 TB/s and 67 T op/s)."""

import pytest

from benchmark import core

N = 1 << 22           # the smoke's 4 MiB DP segment
NK = 1 << 23          # its K2 buffer
W, B = 64, 4096
LEVELS = [[4, 13], [8, 14]]
NCAND, NSLOTS = 27, 29
NS, ND = 123_457, 4_321  # the smoke's seed and dictionary edges (any)

# chip_smoke.py's nbytes and nops at those shapes
SMOKE = {
    "suffix_min": [((NSLOTS * N * 2 + W + N * 2 * W) * 4,
                    N * (NSLOTS + W) * 8)],
    "dp_scan": [((N * 2 * W + N + (N // B) * (B + 1)) * 4, N * W * 4)],
    "dp_backtrack": [(((N // B) * (B + 1) + 2 * B * (N // B)) * 4,
                      (N // B) * B * 8)],
    "edge_keys": [(N + 4 * N, N * 20)] * 2,
    "edge_ranks": [(4 * N + 8 * N + N + 4 * r * N, N * r * 8)
                   for _, r in LEVELS],
    "edge_rows": [(8 * NCAND * N, N * NCAND)],
    "edge_slots": [((4 * NCAND * N + N + 24 * NS + 16 * ND +
                     4 * (64 + 64 * 256 + 256 * 256) + 8 * NSLOTS * N +
                     8 * N), N * NSLOTS * 12)],
    "chain_select": [(2 * NK * 4, NK)],
}
# the kernel table's bound column, ms (the 8-byte level for K9 and K10)
BOUND_MS = {"suffix_min": 0.932, "dp_scan": 0.651, "dp_backtrack": 0.015,
            "edge_keys": 0.0063, "edge_ranks": 0.086, "edge_rows": 0.270,
            "edge_slots": 0.438, "chain_select": 0.020}

SEG = {"n": N, "levels": LEVELS, "ncand": NCAND, "nslots": NSLOTS,
       "W": W, "B": B, "ns": NS, "nd": ND}


def _files():
    return sorted(p.stem for p in (core.HERE / "rooflines").glob("*.py"))


def test_every_roofline_file_is_checked():
    assert _files() == sorted(SMOKE)


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_roofline_counts_are_chip_smokes(name):
    roof = core.load_module("rooflines", name)
    seg = SEG if roof.SHAPE == "dp_segment" else {"n": NK, "ncand": 4}
    got = roof.counts(seg)
    assert got == SMOKE[name]
    pk = core.peaks("NVIDIA H100 80GB HBM3")
    ms = max(got[-1][0] / pk["bytes_per_s"], got[-1][1] / pk["ops_per_s"])
    assert round(ms * 1e3, 4 if BOUND_MS[name] < 0.01 else 3) == \
        BOUND_MS[name]


def test_shapes_cut_requests_as_the_program_does():
    q11 = core.load_json("configs", "q11_w22")["shapes"]["dp_segment"]
    q5 = core.load_json("configs", "q5_w22")["shapes"]["match_segment"]
    dp = core.load_module("shapes", "dp_segment").segments
    ms = core.load_module("shapes", "match_segment").segments
    assert [s["n"] for s in dp(16 << 20, **q11)] == [4 << 20] * 4
    assert [s["n"] for s in dp((4 << 20) + 5, **q11)] == [4 << 20, 2 << 20]
    assert dp(16 << 20, **q11)[0]["nslots"] == 29
    assert [s["n"] for s in ms(16 << 20, **q5)] == [8 << 20] * 4
    assert [s["n"] for s in ms(600_000, **q5)] == [1 << 20]


def _window(ops, nreq=1, kind="NVIDIA H100 80GB HBM3"):
    q11 = core.load_json("configs", "q11_w22")
    warned = []
    from types import SimpleNamespace
    return SimpleNamespace(config=q11, request_bytes=[16 << 20] * nreq,
                           device_ops=ops, device_kind=kind,
                           warn=warned.append), warned


def test_roofline_share_counts_launches_seen_against_the_shapes():
    seg = core.load_module("shapes", "dp_segment").segments(
        16 << 20, **core.load_json("configs", "q11_w22")["shapes"][
            "dp_segment"])
    # each roofline kernel's launches, each taking twice its bound, and
    # a sort of the same total time that has no roofline file
    ops, t, total = [], 0.0, 0.0
    pk = core.peaks("H100")
    for name in sorted(SMOKE):
        roof = core.load_module("rooflines", name)
        if roof.SHAPE != "dp_segment":
            continue
        for s in seg:
            for nb, nop in roof.counts(s):
                d = 2 * max(nb / pk["bytes_per_s"], nop / pk["ops_per_s"])
                ops.append((roof.KERNEL, t, t + d))
                t += d
                total += d
    ops.append(("DeviceRadixSortOnesweepKernel", t, t + total))
    ops.append(("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0))
    dp = _metric_kernels("dp_kernels_roofline")
    w, warned = _window(ops)
    assert core.roofline_share(w, "dp_segment", dp) == pytest.approx(25.0)
    assert not warned
    # only the kernels the metric names count: a roofline file that is
    # not among them moves nothing
    w, warned = _window(ops)
    assert core.roofline_share(w, "dp_segment", dp[1:]) < 25.0
    assert not warned
    # a kernel launched other than its file expects adds no bound
    w, warned = _window(ops[1:])
    assert core.roofline_share(w, "dp_segment", dp) < 25.0 and warned
    # another card, no peaks: nothing to read
    w, _ = _window(ops, kind="some other card")
    assert core.roofline_share(w, "dp_segment", dp) is None


def _metric_kernels(metric):
    return core.load_module("metrics", metric).KERNELS


def test_every_roofline_file_is_named_by_one_roofline_metric():
    named = [k for m in core.spec()["per_layer"]
             if m["name"].endswith("_roofline")
             for k in _metric_kernels(m["name"])]
    assert sorted(named) == _files()


def test_kernel_names_are_cut_to_the_function():
    assert core.kernel_name("(anonymous namespace)::slots_kernel(Args)") == \
        "slots_kernel"
    assert core.kernel_name(
        "void at::native::(anonymous namespace)::fill<int>(int*)") == "fill"
    assert core.kernel_name("Memset (Device)") == "Memset"
