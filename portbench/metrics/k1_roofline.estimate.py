"""K1's share of its roofline in the traced sub-window: the least time of
the crops the traced estimates asked for (the larger of their bytes over the
card's memory bandwidth and their operations over its f32 peak;
``counts/k1.py``) over the device time of K1's kernels in the trace. None
when the trace holds no K1 kernel (a program that no longer runs it)."""

import re

from portbench.counts.peaks import FLOPS_PER_S, HBM_BYTES_PER_S

KERNEL = re.compile(r"crop_resize_normalize(?!_clamp)")


def read(run):
    t = run.traced
    if t is None or not run.counts.get("traced_k1_bytes"):
        return None
    busy = sum(e - s for s, e, name in t["kernels"] if KERNEL.search(name)) * 1e-6
    if busy <= 0:
        return None
    least = max(run.counts["traced_k1_bytes"] / HBM_BYTES_PER_S,
                run.counts["traced_k1_ops"] / FLOPS_PER_S["float32"])
    return 100.0 * least / busy
