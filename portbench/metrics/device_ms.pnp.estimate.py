"""Device time of the estimate's span ``solve/pnp``, in ms an estimate: the
v1 solve's DLT PnP (one SVD a pair over its scaled NOCS points), inside
``adapose/solve``. The program's spans (``SPANS`` of
``rgbmanip_tpu_torch.utils.logger``) record while the profiler runs: the
harness's primed call and the traced sub-window. A span's device time runs
from the card finishing the work enqueued before it to the card finishing
its own, so it holds the time the card waited for the span's launches. The
span's device time summed over those calls, over the calls of the root span
``adapose/estimate``. None without the span (a program or solve without
it), or without device times (a CPU run)."""

import sys

SPAN = "solve/pnp"
ROOT = "adapose/estimate"


def read(run):
    spans = getattr(sys.modules.get("rgbmanip_tpu_torch.utils.logger"), "SPANS", None)
    if spans is None:
        return None
    s = spans.summary()
    root, stage = s.get(ROOT), s.get(SPAN)
    if not root or not stage or "device_ms" not in stage:
        return None
    return stage["device_ms"] * stage["calls"] / root["calls"]
