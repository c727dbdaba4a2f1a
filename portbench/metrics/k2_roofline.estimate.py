"""K2's share of its roofline in the traced sub-window: each K2 launch's
least time (the fused volume's bytes plus both feature maps', at the cell's
shapes, over the card's memory bandwidth; ``counts/k2.py``) over the mean
device time of K2's kernels in the trace. None when the trace holds no K2
kernel (a program without it, or a cell whose warp is not bilinear), or when
the trace's K2 kernels are not two for each estimate traced (each call of
the program's root span ``adapose/estimate`` opened within the traced
session: ``SPANS`` of ``rgbmanip_tpu_torch.utils.logger``), since each
launch is then not one kernel."""

import re
import sys

from portbench.counts import k2
from portbench.counts.peaks import HBM_BYTES_PER_S

KERNEL = re.compile(r"plane_sweep_fuse")
ROOT = "adapose/estimate"


def traced_calls(run):
    """The root span's calls opened within the traced session (host clock,
    ``perf_counter``), or None without the spans."""
    spans = getattr(sys.modules.get("rgbmanip_tpu_torch.utils.logger"), "SPANS", None)
    records = getattr(spans, "records", None)
    if records is None:
        return None
    lo = run.tracer.t0 * 1e9
    hi = (run.tracer.t0 + run.traced["window_s"]) * 1e9
    return sum(1 for r in records if r.name == ROOT and r.parent is None and lo <= r.t0 <= hi)


def read(run):
    t = run.traced
    if t is None:
        return None
    times = [e - s for s, e, name in t["kernels"] if KERNEL.search(name)]
    if not times or len(times) != 2 * (traced_calls(run) or 0):
        return None
    least = k2.cell_launch_bytes(run.cfg, run.wl) / HBM_BYTES_PER_S
    return 100.0 * least * len(times) / (sum(times) * 1e-6)
