"""What the harness finds by name, and the arithmetic its readers share.

Everything that belongs to one configuration, traffic mix, metric,
roofline or segment shape is a file of its own under this folder, found
by the name that BENCHMARK.json (or a configuration) gives it:

    configs/<config>.json      the entry point, its arguments, the shapes
    traffic/<traffic>.json     the generator gen/<gen>.py, its parameters
                               and the client loop
    metrics/<metric>.py        read(window) -> number or None
    rooflines/<kernel>.py      SHAPE, KERNEL and counts(segment), named
                               by the metric that reads it
    shapes/<shape>.py          segments(request bytes, **shape params)
"""

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (a metric's name may hold
    dots, so it is loaded by path, not imported by name)."""
    path = HERE / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str) -> dict:
    """The workload entry with its configuration and traffic mix, and
    the metrics it reports: {"end_to_end": [...], "per_layer": [...]},
    each metric's entry as BENCHMARK.json gives it."""
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"benchmark: no workload {workload!r} in "
                         f"BENCHMARK.json")
    out = dict(w)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    out["config_file"] = json.loads((ROOT / entry["file"]).read_text())
    out["traffic_file"] = load_json("traffic", w["traffic"])
    for kind in ("end_to_end", "per_layer"):
        out[kind] = [m for m in bench[kind]
                     if workload in m.get("workloads", [workload])]
    return out


def device_intervals_union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_name(name: str) -> str:
    """A device operation's name as the trace gives it, cut to the
    function's own name: no namespace, template arguments or
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name.rsplit("::", 1)[-1]


def is_copy(name: str) -> bool:
    return name.lower().startswith("memcpy")


def segments(window, shape: str) -> list:
    """The segments of kind `shape` that the window's requests held,
    in request order, from the configuration's shape parameters; []
    where the configuration states no such shape."""
    params = window.config.get("shapes", {}).get(shape)
    if params is None:
        return []
    seg = load_module("shapes", shape).segments
    return [s for n in window.request_bytes for s in seg(n, **params)]


def peaks(kind: str) -> dict:
    """The published peaks of the card whose name holds a key of
    peaks.json; None for another card."""
    table = json.loads((HERE / "peaks.json").read_text())
    return next((v for k, v in table.items() if k in kind), None)


def roofline_share(window, shape: str, kernels):
    """Share (%) of the window's device kernel time that the kernels of
    `shape`'s segments would take at the card's peaks: the sum over the
    roofline files named in `kernels` (rooflines/<name>.py, each of that
    shape) of each launch's bound (the larger of its bytes over peak
    bytes/s and its operations over peak operations/s, both counted from
    the segment's shape), over the time of every kernel and memset the
    window ran. The metric names its files, so a roofline file added
    later moves no existing share. A named kernel whose launches in the
    window are not the count its file gives for these segments adds its
    time and no bound, and says so in the result line (`window.warn`).
    None without a device trace, segments, or the card's peaks."""
    segs = segments(window, shape)
    pk = peaks(window.device_kind)
    kernel_s = sum(e - s for n, s, e in window.device_ops if not is_copy(n))
    if not segs or pk is None or kernel_s <= 0:
        return None
    launches = {}
    for n, _, _ in window.device_ops:
        launches[n] = launches.get(n, 0) + 1
    bound_s = 0.0
    for name in kernels:
        roof = load_module("rooflines", name)
        if roof.SHAPE != shape:
            raise ValueError(f"rooflines/{name}.py counts {roof.SHAPE} "
                             f"segments, not {shape}")
        per_launch = [c for s in segs for c in roof.counts(s)]
        seen = launches.get(roof.KERNEL, 0)
        if seen != len(per_launch):
            window.warn(f"{name}: {seen} launches of {roof.KERNEL} in "
                        f"the window, {len(per_launch)} expected; its bound "
                        f"is left out")
            continue
        bound_s += sum(max(nb / pk["bytes_per_s"], ops / pk["ops_per_s"])
                       for nb, ops in per_launch)
    return 100.0 * bound_s / kernel_s


def stage_ms_per_mib(window, *names):
    """The host milliseconds of the program's named trace stages in the
    window, a MiB of input; None where none of them ran."""
    got = [window.stages[n][1] for n in names if n in window.stages]
    if not got:
        return None
    return 1e3 * sum(got) / (sum(window.request_bytes) / (1 << 20))
