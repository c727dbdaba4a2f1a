"""The flagship diagnostic (``rgbmanip_tpu_torch/scripts/diag_flagship.py``)
against the JAX package's ``scripts/diag_flagship.py``, both on the CPU.

``Recorder`` records and prints as the JAX one on seeded arrays. Then both
scripts run one round of 2 envs of RL + AdaPose and one of heuristic +
AdaPose with the flagship checkpoints (``EST_CKPT`` names the estimator, as
``scripts/r5_stageD.sh:18`` does). As in ``tests/test_torch_rl_loop.py``,
the port's estimator is fed the point-sampling draws the JAX estimator made
on each call, and the JAX crop runs through its Pallas kernel in interpret
mode; the camera moves by each package's own policy, so the camera
distances part by f32 rounding only.

The policy's first estimation step pairs the reset view with the first
policy view, but the reset view rarely frames the handle, so that step's
pair is one view duplicated into both stereo slots (camera distance 0):
such estimates are ill-conditioned and part by centimetres between the
frameworks (ROADMAP Queue 3). The first estimation step held to 1e-3 m in
centre error is therefore, in each env, the first one from two distinct
views, and the heuristic's single two-view step. Every step's camera
distance up to it is held to 1e-5 m. Later steps are chaotic at f32
rounding and are not compared.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.scripts import diag_flagship as port_diag
from test_torch_paper_estimator import init_shapes_only
from test_torch_rl_loop import jax_pallas_crop, keep_keys, replay_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = "checkpoints/ppo_rl_coadapt_model_165.ckpt"
EST = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
N_ENVS = 2


def jax_diag_module(mp):
    mp.setattr(sys, "path", list(sys.path))     # the JAX script prepends "."
    spec = importlib.util.spec_from_file_location(
        "jax_diag_flagship", os.path.join(REPO, "scripts", "diag_flagship.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rigid(rng, n):
    """(n, 4, 4) world->cam transforms: a random rotation and translation."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = q
    out[:, :3, 3] = rng.normal(size=(n, 3))
    return out.astype(np.float32)


def test_recorder_records_and_prints_as_the_jax_recorder(monkeypatch, capsys):
    mod = jax_diag_module(monkeypatch)
    rng = np.random.default_rng(0)
    jrec, prec = mod.Recorder(), port_diag.Recorder()
    for rec in (jrec, prec):
        rec.table("empty")
    assert capsys.readouterr().out == "empty: no estimations recorded\n" * 2
    for step in (1, 2, 2, 3, 4):
        e1, e2 = rigid(rng, 6), rigid(rng, 6)
        np.testing.assert_array_equal(port_diag.cam_centers_from_extr(e1),
                                      mod.cam_centers_from_extr(e1))
        gt = rng.normal(size=(6, 8, 3))
        pred = gt + rng.normal(scale=0.08, size=(6, 8, 3))
        for rec in (jrec, prec):
            rec.record(e1, e2, pred, gt, step)
    np.testing.assert_array_equal(np.array(prec.rows), np.array(jrec.rows))
    assert len(prec.rows) == 30
    jrec.table("seeded")
    ref = capsys.readouterr().out
    prec.table("seeded")
    out = capsys.readouterr().out
    assert "== seeded: 30 estimations ==" in out and out == ref


@pytest.fixture(scope="module")
def diags():
    """(JAX recorders [RL, heuristic], the port's ``main`` result)."""
    from rgbmanip_tpu import train as jax_train
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth

    with pytest.MonkeyPatch.context() as mp:
        mod = jax_diag_module(mp)
        made, keys = [], []

        class Recorder(mod.Recorder):
            def __init__(self):
                super().__init__()
                made.append(self)

        def keyed(*args, **kwargs):
            est = jax_prepare(*args, **kwargs)
            keep_keys(est, keys)
            return est

        def replayed(*args, **kwargs):
            est = port_prepare(*args, **kwargs)
            replay_draws(est, keys)
            return est

        jax_prepare, port_prepare = (jax_train.prepare_pose_estimator,
                                     port_train.prepare_pose_estimator)
        mp.setattr(mod, "Recorder", Recorder)
        mp.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
        mp.setattr(jax_train, "prepare_pose_estimator", keyed)
        mp.setattr(port_train, "prepare_pose_estimator", replayed)
        mp.setenv("EST_CKPT", EST)
        mp.setattr(sys, "argv", ["diag_flagship.py", POLICY, "1", str(N_ENVS)])
        with jax_pallas_crop():
            mod.main()
        out = port_diag.main([POLICY, "1", str(N_ENVS), "device=cpu"])
    return made, out


def test_the_diag_runs_both_loops_on_the_port(diags):
    ref, out = diags
    assert len(ref) == 2
    assert out["episodes"] == N_ENVS
    for name, jrec in zip(("rl", "heuristic"), ref):
        assert len(out[name].rows) == len(jrec.rows) > 0
        assert [r[0] for r in out[name].rows] == [r[0] for r in jrec.rows]


def test_the_first_two_view_step_within_a_millimetre(diags):
    ref, out = diags
    # rows go step by step, N_ENVS rows a step: (steps, N_ENVS, [step, deg, m, m])
    port = np.array(out["rl"].rows).reshape(-1, N_ENVS, 4)
    jax_rows = np.array(ref[0].rows).reshape(-1, N_ENVS, 4)
    print("cam_dist port", port[..., 2], "jax", jax_rows[..., 2])
    print("center_err port", port[..., 3], "jax", jax_rows[..., 3])
    assert (jax_rows[0, :, 2] == 0).all(), "the first step is not a duplicated pair"
    for e in range(N_ENVS):
        first = int(np.argmax(jax_rows[:, e, 2] > 0.04))
        assert jax_rows[first, e, 2] > 0.04, f"env {e}: no two-view step"
        np.testing.assert_allclose(port[:first + 1, e, 2], jax_rows[:first + 1, e, 2],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(port[first, e, [1, 3]], jax_rows[first, e, [1, 3]],
                                   rtol=0, atol=1e-3)
    # the heuristic's fixed two-view pair
    hp, hj = np.array(out["heuristic"].rows), np.array(ref[1].rows)
    np.testing.assert_allclose(hp[:, 2], hj[:, 2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(hp[:, 3], hj[:, 3], rtol=0, atol=1e-3)
