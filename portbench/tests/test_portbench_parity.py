"""The published network's configuration (``adapose_cabinet_parity``): the
plain reference against the program at its knobs at a tiny size on the CPU
(through the eager warp, and through K2's plain twin with the pose features
read from the U-Net's layout, as the card runs it); K2's byte count against
a hand count; and the reader of ``k2_roofline.estimate`` on a synthetic
trace, with its None cases."""

import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench.counts import k2
from portbench.counts.peaks import HBM_BYTES_PER_S
from portbench.drivers import estimate as E

PARITY = dict(img_size=32, n_pts=64, backend="resnet34", backbone_stride=8,
              volume_scale=1, warp_mode="bilinear", n_depth=8)
MODULE = "rgbmanip_tpu_torch.utils.logger"
READER = "k2_roofline.estimate"


def parity_files():
    return (H.load_json(H.HERE, "configs", "adapose_cabinet_parity.json"),
            H.load_json(H.HERE, "workloads", "parity.estimate_b16.json"))


@pytest.mark.parametrize("path", ["eager", "k2"])
def test_reference_estimate_matches_the_program_at_the_parity_knobs(path, monkeypatch):
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    calls = []
    fused_volume = stereo.fused_volume
    monkeypatch.setattr(stereo, "fused_volume", lambda *a: calls.append(1) or fused_volume(*a))
    if path == "k2":        # as on the card: K2's route (its plain twin here), the U-Net's layout
        applies = stereo.StereoPoseNetWithDepth.k2_applies
        monkeypatch.setattr(stereo.StereoPoseNetWithDepth, "k2_applies",
                            lambda self, feat: applies(self, types.SimpleNamespace(is_cuda=True)))
    cfg, wl = parity_files()
    assert (cfg["volume_scale"], cfg["warp_mode"]) == (1, "bilinear")
    cfg.update(PARITY)
    wl = dict(wl, batch=3, pool=1)
    dev = torch.device("cpu")
    x = E.inputs(wl, 2 ** 33 + 7, dev)[0]
    est = E.program(cfg, torch.float32, 5, dev)
    est.generator = torch.Generator().manual_seed(99)
    prog = E.call(est, x)
    u1, u2 = E.draws(cfg, 3, 99, dev)
    ref = E.reference_outputs(E.reference_net(cfg, 5, dev), cfg, x, u1, u2)
    assert prog["valid"].all() and (prog["valid"] == ref["valid"]).all()
    for k in ("bbox", "R_cam", "t_cam", "scale"):
        np.testing.assert_allclose(prog[k], ref[k], rtol=1e-4, atol=1e-5)
    assert E.compare([(prog, ref)])["bbox_gap_max"] < 1e-4
    assert len(calls) == (2 if path == "k2" else 0)


def test_k2_bytes_by_hand():
    # a (2, 32, 24, 224, 224) bf16 volume written, two (2, 224, 224, 32) maps read
    assert k2.launch_bytes(2, 32, 24, 224, 224, 2) == (
        2 * 32 * 24 * 224 * 224 * 2 + 2 * (2 * 224 * 224 * 32 * 2))
    cfg, wl = parity_files()
    assert k2.cell_launch_bytes(cfg, wl) == 1_233_125_376 + 102_760_448
    assert k2.cell_launch_bytes(cfg, dict(wl, dtype="float32")) == 2 * (
        1_233_125_376 + 102_760_448)


class Record:
    def __init__(self, name, t0_s, parent=None):
        self.name, self.parent, self.t0 = name, parent, int(t0_s * 1e9)


def fake_run(kernels, roots):
    """A traced run of the parity cell: the session from t = 100 s for
    3 s, ``kernels`` (name, microseconds) on the device, and the root span
    opened at each time of ``roots`` (the primed call at 90 s among them),
    each with a stage span nested in it."""
    cfg, wl = parity_files()
    run = types.SimpleNamespace(cfg=cfg, wl=wl, tracer=types.SimpleNamespace(t0=100.0))
    ts, dev = 0.0, []
    for name, us in kernels:
        dev.append((ts, ts + us, name))
        ts += us + 5.0
    run.traced = {"kernels": dev, "window_s": 3.0}
    records = []
    for t in roots:
        records += [Record("adapose/estimate", t), Record("stereo/warp", t + 0.01,
                                                          "adapose/estimate")]
    return run, types.SimpleNamespace(SPANS=types.SimpleNamespace(records=records))


K2 = "void (anonymous namespace)::plane_sweep_fuse_kernel<__nv_bfloat16, 4>(uint4 const*)"
OTHER = "void cudnn::dgrad2d_grouped_direct_kernel<__nv_bfloat16>()"


def read(run):
    return H.load_module("metrics", READER).read(run)


def test_k2_roofline_reader_on_a_synthetic_trace(monkeypatch):
    least_us = 1e6 * k2.cell_launch_bytes(*parity_files()) / HBM_BYTES_PER_S
    kernels = [(K2, 800.0), (OTHER, 5000.0), (K2, 600.0)] * 2
    run, logger = fake_run(kernels, roots=[90.0, 100.5, 101.7])
    monkeypatch.setitem(sys.modules, MODULE, logger)
    assert read(run) == pytest.approx(100.0 * least_us / 700.0)
    assert 0 < read(run) < 100


@pytest.mark.parametrize("case", ["no_k2", "one_launch_short", "primed_only",
                                  "no_spans", "untraced"])
def test_k2_roofline_reader_reads_none(case, monkeypatch):
    kernels = [(K2, 800.0), (OTHER, 5000.0), (K2, 600.0)]
    roots = [90.0, 101.0]
    if case == "no_k2":
        kernels = [(OTHER, 5000.0)]
    elif case == "one_launch_short":
        kernels = kernels[:2]
    elif case == "primed_only":
        roots = [90.0]
    run, logger = fake_run(kernels, roots)
    monkeypatch.setitem(sys.modules, MODULE, logger)
    if case == "no_spans":
        monkeypatch.setitem(sys.modules, MODULE, types.ModuleType(MODULE))
    elif case == "untraced":
        run.traced = None
    assert read(run) is None
