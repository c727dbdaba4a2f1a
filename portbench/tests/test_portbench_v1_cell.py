"""The v1 cell ``v1.estimate_b16_f32``: the readers of the v1 network's own
spans (``stereo/volume_conv``, ``solve/match``, ``solve/pnp``) read nothing
without those spans and each stage's device time an estimate where they hold
device times; and the committed ``adapose_cabinet_v1`` configuration, shrunk
to a CPU test's size, holds the program against its reference."""

import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench.drivers import estimate as E

MODULE = "rgbmanip_tpu_torch.utils.logger"
V1_READERS = ["device_ms.volume_conv.estimate", "device_ms.match.estimate",
              "device_ms.pnp.estimate"]
CPU = torch.device("cpu")


class FakeV1:
    """A span buffer of a v1 run whose summary is given: 4 estimates, each
    with its backbone, warp, ``volume_conv``, heads and solve once, the match
    and PnP stages on half the calls, and syncs in the readback and the match
    stage."""

    def __init__(self, device=True):
        self.device = device

    def summary(self):
        rows = {"adapose/estimate": (4, 40.0, 0), "stereo/backbone": (4, 12.0, 0),
                "stereo/warp": (4, 3.0, 0), "stereo/volume_conv": (4, 7.5, 0),
                "stereo/heads": (4, 1.0, 0), "adapose/solve": (4, 9.0, 0),
                "solve/match": (2, 3.0, 1), "solve/pnp": (2, 5.0, 0),
                "adapose/readback": (4, 2.0, 5)}
        out = {}
        for name, (calls, ms, syncs) in rows.items():
            out[name] = {"calls": calls, "host_ms": 2 * ms, "host_syncs": syncs}
            if self.device:
                out[name]["device_ms"] = ms
        return out


def read(metric):
    return H.load_module("metrics", metric).read(None)


@pytest.mark.parametrize("metric", V1_READERS)
def test_v1_reader_without_the_spans_reads_none(metric, monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    assert read(metric) is None
    monkeypatch.setitem(sys.modules, MODULE, types.ModuleType(MODULE))
    assert read(metric) is None
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(SPANS=FakeV1(device=False)))
    assert read(metric) is None


def test_v1_readers_of_a_fake_buffer(monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(SPANS=FakeV1()))
    got = {m: read(m) for m in V1_READERS + ["host_syncs.estimate"]}
    assert got == {"device_ms.volume_conv.estimate": 7.5, "device_ms.match.estimate": 1.5,
                   "device_ms.pnp.estimate": 2.5, "host_syncs.estimate": 5.5}


def test_v1_readers_skip_a_v5_buffer(monkeypatch):
    """A v5 run opens none of v1's spans: its line leaves the three out."""
    class FakeV5(FakeV1):
        def summary(self):
            s = super().summary()
            for name in ("stereo/volume_conv", "solve/match", "solve/pnp"):
                del s[name]
            return s

    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(SPANS=FakeV5()))
    assert [read(m) for m in V1_READERS] == [None, None, None]


def test_v1_reference_matches_the_program_on_the_committed_configuration():
    """The committed ``adapose_cabinet_v1`` shrunk to a CPU test's size
    (resnet18, 64 px, 128 points, 8 planes; every other knob as committed):
    the program's ``AdaPoseEstimator(arch="v1")`` on the reference's seeded
    weights against the reference, both in float32 on the CPU, under the
    tolerances of ``test_portbench_generations``'s
    ``test_v1_reference_matches_the_program`` (their reasons are given
    there)."""
    cfg = dict(H.load_json(H.HERE, "configs", "adapose_cabinet_v1.json"),
               img_size=64, n_pts=128, backend="resnet18", n_depth=8)
    wl = dict(H.load_json(H.HERE, "workloads", "v1.estimate_b16_f32.json"), batch=2, pool=1)
    x = E.inputs(wl, 2 ** 33 + 7, CPU)[0]
    apart = torch.linalg.norm((x["ext2"] @ torch.linalg.inv(x["ext1"]))[:, :3, 3], dim=-1) > 1e-3
    est = E.program(cfg, torch.float32, 5, CPU)
    assert est.arch == "v1"
    est.generator = torch.Generator().manual_seed(99)
    prog = E.call(est, x)
    u1, u2 = E.draws(cfg, 2, 99, CPU)
    ref = E.reference_outputs(E.reference_net(cfg, 5, CPU), cfg, x, u1, u2)
    assert (prog["valid"] == ref["valid"]).all()
    assert (ref["valid"] & apart.numpy()).any() and (~apart).any()
    np.testing.assert_allclose(prog["bbox"], ref["bbox"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(prog["t_cam"], ref["t_cam"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(prog["scale"], ref["scale"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(prog["R_cam"][apart], ref["R_cam"][apart], rtol=0, atol=1e-3)
