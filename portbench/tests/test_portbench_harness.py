"""A run of each cell driven end to end on the CPU at a size a test can
hold, past the look for a card, in a fresh interpreter: sound, it comes out
``correct``; with the timed path broken underneath (an answer altered where
it is produced: the estimator's solve, the policy's action, the fusion the
skill acts on; one pair of a batch answered wrong, or invalid on the
program's side alone) it comes out not correct. Without a card a run exits non-zero
and prints no result."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness as H

DRIVE = r"""
import json, sys
import numpy as np
import torch
from portbench import harness as H, run
spec = json.loads(sys.argv[1])
cell = spec["cell"]
bench = H.load_json(H.ROOT, "BENCHMARK.json")
if "entry" in spec:
    bench["workloads"].append(spec["entry"])
    bench["end_to_end"] += spec["metrics"]
w, _, _ = H.cell_spec(bench, cell)
cfg = H.load_json(H.HERE, "configs", w["config"] + ".json")
cfg.update(spec.get("cfg", {}))
wl = H.load_json(H.HERE, "workloads", cell + ".json")
wl.update(spec.get("wl", {}))
fault = spec.get("fault")
if fault == "answer":
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    solve = AdaPoseEstimator._solve
    def bad(self, *a, **k):
        bbox, ok, R, t, s = solve(self, *a, **k)
        return bbox * 1.5, ok, R, t, s * 1.5
    AdaPoseEstimator._solve = bad
elif fault == "one_pair":
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    solve = AdaPoseEstimator._solve
    def bad(self, *a, **k):
        bbox, ok, R, t, s = solve(self, *a, **k)
        c = bbox[:1].mean(-1, keepdim=True)
        return torch.cat([c + 1.5 * (bbox[:1] - c), bbox[1:]]), ok, R, t, s
    AdaPoseEstimator._solve = bad
elif fault == "one_invalid":
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    solve = AdaPoseEstimator._solve
    def bad(self, *a, **k):
        bbox, ok, R, t, s = solve(self, *a, **k)
        return bbox, torch.cat([torch.zeros_like(ok[:1]), ok[1:]]), R, t, s
    AdaPoseEstimator._solve = bad
elif fault == "action":
    from rgbmanip_tpu_torch.algo.ppo import ActorCritic
    act = ActorCritic.act_inference
    ActorCritic.act_inference = lambda self, obs: act(self, obs) + 0.01
elif fault == "fusion":
    from rgbmanip_tpu_torch.models.controller import rl_pose
    fuse = rl_pose.consensus_fuse
    rl_pose.consensus_fuse = lambda *a, **k: fuse(*a, **k) + 0.01
sys.exit(run.main(["--workload", cell, "--seed", str(spec["seed"]), "--seconds",
                   str(spec["seconds"]), "--trace", "0"],
                  device=torch.device("cpu"), bench=bench, cfg=cfg, wl=wl))
"""

TINY = {"img_size": 64, "n_pts": 128, "backend": "resnet18", "backbone_stride": 32,
        "volume_scale": 8, "n_depth": 16, "weights": {"seeded": True}}
ESTIMATE = {"cfg": TINY, "wl": {"batch": 12, "pool": 2, "warmup_calls": 1, "check_calls": 2,
                                "dtype": "float32"}, "seconds": 1}
EVAL = {"wl": {"check_within": 1, "check_rounds": 1, "scene_rounds": 1},
        "seconds": 1}
# the evaluation's cell, which BENCHMARK.json leaves out (its rate spreads
# too widely on a shared host for any bound), as a later PR would put it back
EVAL_CELL = {"name": "fast.eval_cabinet", "config": "adapose_cabinet_fast",
             "traffic": "eval_cabinet", "chips": 1,
             "why": "the flagship evaluation in whole rounds of cabinet_test episodes"}
EVAL_METRICS = [{"name": "episodes_per_s", "unit": "episodes/s", "better": "higher",
                 "bound": 0.25, "source": "host_clock", "workloads": ["fast.eval_cabinet"]}]


def drive(spec):
    env = dict(os.environ, PYTHONPATH=H.ROOT, RGBMANIP_LOGLEVEL="ERROR")
    p = subprocess.run([sys.executable, "-c", DRIVE, json.dumps(spec)], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def eval_spec(**kw):
    spec = dict(EVAL, cell="fast.eval_cabinet", seed=2 ** 32 + 3, entry=EVAL_CELL,
                metrics=EVAL_METRICS, **kw)
    wl = H.load_json(H.HERE, "workloads", "fast.eval_cabinet.json")
    spec["wl"] = dict(spec["wl"], overrides=[o if not o.startswith("task.num_envs")
                                             else "task.num_envs=2" for o in wl["overrides"]])
    return spec


@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in ("paper.estimate_b16", "fast.estimate_b128")
    for fault in (None, "answer", "one_invalid")] + [("fast.estimate_b128", "one_pair")])
def test_estimate_cell(cell, fault):
    """One pair in twelve answered wrong, or invalid on one side, leaves the
    median and the 90th percentile as they were: the widest gap and the
    valid flags catch it."""
    out = drive(dict(ESTIMATE, cell=cell, seed=2 ** 33 + 1, fault=fault))
    assert out["correct"] is (fault is None), out["checks"]
    if fault in ("one_pair", "one_invalid"):
        failed = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
        assert not failed & {"bbox_gap_p50", "bbox_gap_p90", "bbox_gap_p50_ratio"}, failed
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    assert set(out["metrics"]) == {"estimates_per_s", "estimate_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", [None, "answer", "action", "fusion"])
def test_eval_cell(fault):
    out = drive(eval_spec(fault=fault))
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["metrics"]) == {"episodes_per_s", "setup_s"}
    assert out["attempted"] % 2 == 0 and out["attempted"] > 0


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "paper.estimate_b16", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=H.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode != 0 and '"correct"' not in p.stdout


def test_capture_views_records_the_evaluations_pairs(tmp_path):
    out = tmp_path / "views.json"
    p = subprocess.run([sys.executable, "-m", "portbench.capture_views", "--rounds", "1",
                        "--envs", "2", "--device", "cpu", "--out", str(out)], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, RGBMANIP_LOGLEVEL="ERROR"))
    assert p.returncode == 0, p.stderr[-3000:]
    table = json.loads(out.read_text())
    assert table["image"] == [480, 640]
    assert sorted((r["step"], r["env"]) for r in table["pairs"]) == [
        (s, e) for s in (1, 2, 3, 4) for e in (0, 1)]
    for r in table["pairs"]:
        assert len(r["K"]) == 9 and len(r["ext1"]) == len(r["ext2"]) == 16
        assert r["win1"] and 0 <= r["win1"][0] <= r["win1"][2] < 480
    first = [r for r in table["pairs"] if r["step"] == 1]
    assert all(r["win1"] == r["win2"] and r["ext1"] == r["ext2"] for r in first)


def test_eval_schedule_runs_the_same_rounds_for_every_seed():
    from portbench.drivers import evaluate as V
    cycle = [[f"scene{p}.{e}" for e in range(3)] for p in range(4)]
    runs = []
    for seed in (1, 2 ** 33 + 5, 2 ** 31 + 7, 99):
        sched = V.schedule(cycle, seed)
        runs.append([next(sched) for _ in range(12)])
    for run in runs:
        assert all(cfgs == cycle[p] for (p, _), cfgs in run)
        assert sorted(key for key, _ in run) == [(p, v) for p in range(4) for v in range(3)]
    assert len({run[0][0] for run in runs}) > 1
