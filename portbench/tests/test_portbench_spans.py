"""The readers of the program's spans: each reads ``SPANS.summary()`` of the
module ``rgbmanip_tpu_torch.utils.logger`` where the run loaded it, and
returns None where it did not, where the module has no spans (a program
without them), or where the spans hold no device times (a CPU run)."""

import sys
import types

import pytest

from portbench import harness as H

MODULE = "rgbmanip_tpu_torch.utils.logger"
STAGES = {"preprocess": "adapose/preprocess", "backbone": "stereo/backbone",
          "warp": "stereo/warp", "cost_reg": "stereo/cost_reg", "heads": "stereo/heads",
          "solve": "adapose/solve", "readback": "adapose/readback"}
READERS = [f"device_ms.{k}.estimate" for k in STAGES] + ["host_syncs.estimate"]


class Fake:
    """A span buffer whose summary is given: 4 estimates, each stage once a
    call but the heads twice, and syncs in the backbone and the readback."""

    def __init__(self, device=True):
        self.device = device

    def summary(self):
        rows = {"adapose/estimate": (4, 40.0, 0), "adapose/readback": (4, 2.0, 5)}
        rows.update({name: (4, 1.0 + i, 9 if k == "backbone" else 0)
                     for i, (k, name) in enumerate(STAGES.items()) if k != "readback"})
        rows["stereo/heads"] = (8, 0.5, 0)
        out = {}
        for name, (calls, ms, syncs) in rows.items():
            out[name] = {"calls": calls, "host_ms": 2 * ms, "host_syncs": syncs}
            if self.device:
                out[name]["device_ms"] = ms
        return out


def read(metric):
    return H.load_module("metrics", metric).read(None)


@pytest.mark.parametrize("metric", READERS)
def test_reader_without_the_spans_reads_none(metric, monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert read(metric) is None
    monkeypatch.setitem(sys.modules, MODULE, types.ModuleType(MODULE))
    assert read(metric) is None
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(SPANS=Fake(device=False)))
    assert read(metric) is None


def test_readers_of_a_fake_buffer(monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(SPANS=Fake()))
    got = {m: read(m) for m in READERS}
    assert got == {"device_ms.preprocess.estimate": 1.0, "device_ms.backbone.estimate": 2.0,
                   "device_ms.warp.estimate": 3.0, "device_ms.cost_reg.estimate": 4.0,
                   "device_ms.heads.estimate": 1.0, "device_ms.solve.estimate": 6.0,
                   "device_ms.readback.estimate": 2.0, "host_syncs.estimate": 14.0}
