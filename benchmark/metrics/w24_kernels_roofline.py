"""Share (%) of the DP kernels' own device time that they would take at
the card's peak bytes/s or operations/s, at a window wider than a
segment: K1, K3, K4, K9, K10, K10's row pass and K11, their bounds
counted from the segments' shapes (shapes/dp_segment_halo: K9 and K10
over the halo's candidate rows too, rooflines/edge_keys_halo.py and
edge_ranks_halo.py), over the time of those kernels' launches alone, as
font_kernels_roofline divides. A kernel whose launches in the window are
not the count its file gives, or whose file finds the counted halo
other than the program's counter dp.halo_bytes, adds neither its bound
nor its time, and says so in the result line. None without a device
trace, segments, the card's peaks or a kernel that counts."""

from benchmark import core

SHAPE = "dp_segment_halo"
KERNELS = ("suffix_min", "dp_scan", "dp_backtrack", "edge_keys_halo",
           "edge_ranks_halo", "edge_rows", "edge_slots")


def read(w):
    segs = core.segments(w, SHAPE)
    pk = core.peaks(w.device_kind)
    if not segs or pk is None or not w.device_ops:
        return None
    launches, own = {}, {}
    for n, s, e in w.device_ops:
        launches[n] = launches.get(n, 0) + 1
        own[n] = own.get(n, 0.0) + (e - s)
    bound_s = kernel_s = 0.0
    for name in KERNELS:
        roof = core.load_module("rooflines", name)
        per_launch = [c for s in segs for c in roof.counts(s)]
        seen = launches.get(roof.KERNEL, 0)
        if seen != len(per_launch):
            w.warn(f"{name}: {seen} launches of {roof.KERNEL} in the "
                   f"window, {len(per_launch)} expected; left out")
            continue
        if hasattr(roof, "agrees") and not roof.agrees(w, segs):
            continue
        bound_s += sum(max(nb / pk["bytes_per_s"], ops / pk["ops_per_s"])
                       for nb, ops in per_launch)
        kernel_s += own[roof.KERNEL] if seen else 0.0
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
