"""Synchronising calls a call of the estimate: the program's ``host_syncs``
counter (each call that torch's sync debug mode reports, charged to the
innermost span open; ``SPANS`` of ``rgbmanip_tpu_torch.utils.logger``)
summed over every span recorded while the profiler ran, over the calls of
the root span ``adapose/estimate``. In the estimate cells every span lies
inside an estimate. None without the spans, or off the card (no device
events, so no count)."""

import sys

ROOT = "adapose/estimate"


def read(run):
    spans = getattr(sys.modules.get("rgbmanip_tpu_torch.utils.logger"), "SPANS", None)
    if spans is None:
        return None
    s = spans.summary()
    root = s.get(ROOT)
    if not root or "device_ms" not in root:
        return None
    return sum(v.get("host_syncs", 0) * v["calls"] for v in s.values()) / root["calls"]
