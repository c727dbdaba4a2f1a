"""The port's spans (``rgbmanip_tpu_torch.utils.logger.span``) on the CPU:
off and free of profiler ranges without a profiler; under one, one record
per stage of an estimate with its parent, call id and counters, one
``user_annotation`` range each in the chrome trace, and outputs bitwise
equal to the untraced estimate's. The card's side (device times, the sync
counter) is in ``test_torch_cuda.py``."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
from rgbmanip_tpu_torch.utils import logger as L

torch.set_num_threads(2)

H, W, B = 480, 640, 2
# the fast configuration's knobs at a small crop and point count
CFG = dict(img_size=64, n_pts=128, backend="resnet18", backbone_stride=32, volume_scale=8,
           n_depth=16, d_interval=0.15, warp_mode="nearest", load=False)
ROOT = "adapose/estimate"
STAGES = ("adapose/preprocess", "stereo/backbone", "stereo/warp", "stereo/cost_reg",
          "stereo/heads", "adapose/solve", "adapose/readback")


@pytest.fixture(scope="module")
def est():
    return AdaPoseEstimator(CFG, device="cpu", seed=0)


@pytest.fixture
def views():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(2, B, H, W, 3)).astype(np.float32)
    mask = np.zeros((2, B, H, W), bool)
    mask[0, :, 100:200, 200:320] = True
    mask[1, :, 120:230, 180:300] = True
    K = np.repeat(np.array([[[500, 0, 320], [0, 500, 240], [0, 0, 1]]], np.float32), B, 0)
    ext = np.repeat(np.eye(4, dtype=np.float32)[None], B, 0)
    ext[:, 2, 3] = 1.0
    ext2 = ext.copy()
    ext2[:, 0, 3] = 0.05
    return K, rgb[0], mask[0], ext, rgb[1], mask[1], ext2


@pytest.fixture(autouse=True)
def empty_spans():
    L.SPANS.reset()
    yield
    L.SPANS.reset()


def test_no_profiler_records_nothing_and_opens_no_range(est, views, monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    est.estimate_full(*views)
    est.estimate(*views)
    assert opened == []
    assert L.SPANS.records == [] and L.SPANS.totals == {} and L.SPANS.summary() == {}


def test_profiled_estimate_records_each_span_once(est, views):
    with profile(activities=[ProfilerActivity.CPU]):
        out = est.estimate_full(*views)
    recs = {r.name: r for r in L.SPANS.records}
    assert len(L.SPANS.records) == 8 and set(recs) == {ROOT, *STAGES}
    assert {r.call for r in L.SPANS.records} == {1}
    assert recs[ROOT].parent is None
    assert all(recs[s].parent == ROOT for s in STAGES)
    # inputs already on the estimator's device: nothing copied in
    assert recs[ROOT].counts == {"host_syncs": 0, "pairs": B, "h2d_bytes": 0}
    assert recs["adapose/readback"].counts["d2h_bytes"] == sum(v.nbytes for v in out.values())
    assert all(r.counts["host_syncs"] == 0 and r.device_ms is None for r in recs.values())
    assert all(r.t0 <= r.t1 for r in recs.values())
    stages = [recs[s] for s in STAGES]
    assert all(a.t1 <= b.t0 for a, b in zip(stages, stages[1:]))
    assert recs[ROOT].t0 <= stages[0].t0 and stages[-1].t1 <= recs[ROOT].t1
    s = L.SPANS.summary()
    assert set(s) == {ROOT, *STAGES} and all(v["calls"] == 1 for v in s.values())
    assert s[ROOT]["pairs"] == B and "device_ms" not in s[ROOT]


def test_each_span_is_a_range_of_the_chrome_trace(est, views, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est.estimate(*views)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert {k: len(v) for k, v in ranges.items()} == {n: 1 for n in (ROOT, *STAGES)}
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    (r0, r1), = ranges[ROOT]
    assert lo <= r0 <= r1 <= hi
    assert all(r0 <= s0 <= s1 <= r1 for s in STAGES for s0, s1 in ranges[s])


def test_outputs_equal_with_spans_on_and_off(est, views):
    est.generator.manual_seed(5)
    off = est.estimate_full(*views)
    with profile(activities=[ProfilerActivity.CPU]):
        est.generator.manual_seed(5)
        on = est.estimate_full(*views)
    assert L.SPANS.summary()[ROOT]["calls"] == 1
    assert set(on) == set(off)
    for k in off:
        assert on[k].dtype == off[k].dtype and np.array_equal(on[k], off[k], equal_nan=True), k


def test_phase_timer_totals_with_and_without_a_profiler(monkeypatch):
    timer = L.PhaseTimer()
    opened = []
    real = torch.autograd.profiler.record_function

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    for _ in range(3):
        with timer.phase("render"):
            pass
    with timer.phase("skill"):
        pass
    assert timer.counts == {"render": 3, "skill": 1}
    assert set(timer.totals) == {"render", "skill"} and timer.summary() == timer.totals
    assert opened == [] and L.SPANS.totals == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.phase("render"):
            with L.span("inner", pairs=2):
                L.count(pairs=1)
    assert timer.counts["render"] == 4 and opened == ["render", "inner"]
    s = L.SPANS.summary()
    assert s["render"]["calls"] == 1 and s["inner"]["pairs"] == 3
    assert [(r.name, r.parent, r.call) for r in L.SPANS.records] == [
        ("inner", "render", 1), ("render", None, 1)]


def test_reset_clears_and_the_record_cap_holds(monkeypatch):
    monkeypatch.setattr(L.SPANS, "cap", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with L.span("step", pairs=1):
                pass
    assert len(L.SPANS.records) == 3 and [r.call for r in L.SPANS.records] == [1, 2, 3]
    s = L.SPANS.summary()
    assert s["step"]["calls"] == 5 and s["step"]["pairs"] == 1
    L.SPANS.reset()
    assert L.SPANS.records == [] and L.SPANS.summary() == {}
    L.count(pairs=1)                # no span open, no profiler: nothing
    assert L.SPANS.summary() == {}


def test_a_span_closes_when_its_body_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with L.span("outer"):
                with L.span("inner"):
                    raise ValueError("in the span")
        with L.span("after"):
            pass
    assert [(r.name, r.parent, r.call) for r in L.SPANS.records] == [
        ("inner", "outer", 1), ("outer", None, 1), ("after", None, 2)]
