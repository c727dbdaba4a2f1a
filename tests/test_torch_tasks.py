"""Every task and the heuristic two-view controller through the port's
``train`` functions against the JAX package's, both on the CPU.

- The ground-truth stack (``pose_estimator=ground_truth
  controller=gt_pose``) on ``open_pot``, ``pick_mug``, ``close_cabinet`` and
  ``close_drawer``, and the default command (``controller=heuristic_pose``
  on the ground-truth estimator): the same seed gives the same success rate
  and move distance, exactly. The simulator is bit-exact and the skills are
  numpy in both packages.
- ``homing``: the hand poses after ``run`` are equal.
- Heuristic + AdaPose on pot and mug with the committed estimators,
  lock-step: the two fixed viewpoints give the same views bit for bit, the
  port is fed the point-sampling draws of the JAX estimator (as in
  tests/test_torch_rl_loop.py) and its estimate is held within 1e-3 m of the
  JAX one (f32 on both sides, convolutions summed in other orders: ~1e-6 m
  is expected); then both skills act on the JAX bbox, since the closed-loop
  skill turns micrometres into centimetres of arm motion, and the success
  and move distance are equal.
- The privilege gate of the close skill: under ``ground_truth`` it reads the
  part's dof, under a learned estimator it never does.
- Every config that this slice copied composes to the same dict in both
  loaders (the port's adds its ``device`` key).
"""

import os

import numpy as np
import pytest
import torch
import yaml

from rgbmanip_tpu import train as jax_train
from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.config.loader import CFG_ROOT, load_config
from rgbmanip_tpu_torch.utils.logger import get_logger

from test_torch_paper_estimator import init_shapes_only
from test_torch_rl_loop import jax_pallas_crop, keep_keys, replay_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACKS = {
    "open_pot": ["dataset=pot_test", "task=open_pot", "manipulation=open_pot"],
    "pick_mug": ["dataset=mug_test", "task=pick_mug", "manipulation=pick_mug"],
    "close_cabinet": ["dataset=cabinet_test", "task=close_cabinet",
                      "manipulation=close_cabinet"],
    "close_drawer": ["dataset=drawer_test", "task=close_drawer",
                     "manipulation=close_drawer"],
}
RUN = ["train=test", "task.num_envs=4", "train.total_round=8", "seed=0"]
GT = ["pose_estimator=ground_truth", "controller=gt_pose"]
ESTIMATORS = {"open_pot": "adapose_pot_fast", "pick_mug": "adapose_mug_fast"}
# the configs this slice copied into the port, by group
COPIED = {
    "task": ["open_pot", "pick_mug", "close_cabinet", "close_drawer", "open_cabinet_45",
             "open_drawer_30", "open_cabinet_no_dr", "open_drawer_no_dr"],
    "dataset": ["pot_train", "pot_test", "mug_train", "mug_test"],
    "manipulation": ["open_pot", "pick_mug", "close_cabinet", "close_drawer",
                     "open_cabinet_open_loop", "open_drawer_open_loop",
                     "open_pot_open_loop", "pick_mug_open_loop",
                     "close_cabinet_open_loop", "close_drawer_open_loop"],
    "pose_estimator": ["adapose_pot_fast", "adapose_mug_fast"],
    "controller": ["collect_pose", "collect_baselines"],
    "train": ["test_baseline"],
}


def build(pkg, cfg, log):
    """The env, skill, estimator and controller of ``cfg``; the port's on
    its ``device``."""
    kw = {"device": cfg["device"]} if pkg is port_train else {}
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    manip = pkg.prepare_manipulation(env, cfg["manipulation"], log)
    pe = pkg.prepare_pose_estimator(env, cfg["pose_estimator"], log, **kw)
    return env, manip, pe, pkg.prepare_controller(env, pe, manip, cfg["controller"],
                                                  cfg, log, **kw)


def both(over):
    """The JAX package's and the port's composed configs of ``over``."""
    return jax_load_config(over), load_config(over + ["device=cpu"])


def run_test(pkg, cfg, log):
    env, _, _, ctrl = build(pkg, cfg, log)
    try:
        return pkg.test(env, ctrl, cfg, log)
    finally:
        env.close()


@pytest.mark.parametrize("task", sorted(STACKS))
def test_gt_stack_on_every_new_task_equals_jax(task):
    ref_cfg, cfg = both(STACKS[task] + GT + RUN)
    ref = run_test(jax_train, ref_cfg, jax_get_logger())
    out = run_test(port_train, cfg, get_logger())
    print(task, "port", out, "jax", ref)
    assert out == ref and out["rounds"] == 8


@pytest.mark.parametrize("stack", [[], STACKS["open_pot"], STACKS["close_drawer"]],
                         ids=["default", "open_pot", "close_drawer"])
def test_the_default_command_equals_jax(stack):
    """No override but the run's size: ``heuristic_pose`` on the
    ground-truth estimator, ``open_cabinet``; and the same controller on a
    pot and a close task."""
    ref_cfg, cfg = both(stack + RUN)
    assert cfg["controller"]["name"] == "heuristic_pose"
    assert cfg["pose_estimator"]["name"] == "ground_truth"
    ref = run_test(jax_train, ref_cfg, jax_get_logger())
    out = run_test(port_train, cfg, get_logger())
    print("port", out, "jax", ref)
    assert out == ref


def test_homing_leaves_the_hand_where_jax_does():
    poses = []
    for pkg, (cfg, log) in ((jax_train, (both(["controller=homing"] + RUN)[0],
                                         jax_get_logger())),
                            (port_train, (both(["controller=homing"] + RUN)[1],
                                          get_logger()))):
        env, _, _, ctrl = build(pkg, cfg, log)
        try:
            env.reset()
            ctrl.run()
            poses.append((env.hand_pose(robot_frame=True), env.robot_qpos()))
        finally:
            env.close()
    (ref_pose, ref_q), (pose, q) = poses
    np.testing.assert_array_equal(pose, ref_pose)
    np.testing.assert_array_equal(q, ref_q)
    # the hand reached the home position (the path planner's tolerance)
    np.testing.assert_allclose(pose[:, :3], np.tile([0.3, 0.0, 0.6], (len(pose), 1)),
                               atol=0.02)


# ------------------------------------------------ heuristic + AdaPose, lock-step --
def heuristic_adapose(task):
    return STACKS[task] + [f"pose_estimator={ESTIMATORS[task]}",
                           "controller=heuristic_pose", "train=test",
                           "task.num_envs=2", "train.total_round=2", "seed=11"]


def record_estimates(est, calls, drive=None):
    """Record each estimate's arguments and bbox; with ``drive`` (the JAX
    run's calls) return the JAX bbox of the same call to the skill."""
    estimate = est.estimate

    def recorded(*args):
        bbox = np.asarray(estimate(*args))
        calls.append(([np.array(a) for a in args], bbox))
        return drive[len(calls) - 1][1] if drive is not None else bbox
    est.estimate = recorded


def lockstep_round(pkg, cfg, log, keys, drive=None):
    calls = []
    env, manip, est, ctrl = build(pkg, cfg, log)
    try:
        if drive is None:
            keep_keys(est, keys)
        else:
            replay_draws(est, keys)
        record_estimates(est, calls, drive)
        result = pkg.test(env, ctrl, cfg, log)
        obs = env.get_observation()
        return {"calls": calls, "result": result, "success": np.array(obs["success"]),
                "move": np.array(obs["total_move_distance"]),
                "privileged_ok": manip.privileged_ok}
    finally:
        env.close()


@pytest.mark.parametrize("task", sorted(ESTIMATORS))
def test_heuristic_adapose_lockstep_equals_jax(task, monkeypatch):
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth

    ref_cfg, cfg = both(heuristic_adapose(task))
    keys = []
    # the JAX estimator's initial weights are overwritten by its checkpoint:
    # take their shapes only (flax's init runs op by op, ~40 s on a CPU)
    monkeypatch.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
    with jax_pallas_crop():
        ref = lockstep_round(jax_train, ref_cfg, jax_get_logger(), keys)
    out = lockstep_round(port_train, cfg, get_logger(), keys, drive=ref["calls"])
    assert len(out["calls"]) == len(ref["calls"]) == 1      # one estimate per round
    gaps = []
    for (args, bbox), (ref_args, ref_bbox) in zip(out["calls"], ref["calls"]):
        for a, b in zip(args, ref_args):                    # K, both views, cameras
            np.testing.assert_array_equal(a, b)
        assert (np.abs(ref_bbox).max(axis=(1, 2)) < 8.0).all(), "a JAX estimate is a sentinel"
        gaps.append(float(np.abs(bbox - ref_bbox).max()))
    print(f"{task}: largest |port - JAX| bbox gap {max(gaps):.3g} m (limit 1e-3); "
          f"port {out['result']}, JAX {ref['result']}")
    assert max(gaps) <= 1e-3
    assert not out["privileged_ok"] and not ref["privileged_ok"]
    np.testing.assert_array_equal(out["success"], ref["success"])
    np.testing.assert_array_equal(out["move"], ref["move"])
    assert out["result"] == ref["result"]


# ------------------------------------------------------------ privilege gate --
@pytest.mark.parametrize("estimator, reads", [("ground_truth", True),
                                              ("adapose_cabinet_fast", False)])
def test_the_close_skill_reads_the_dof_only_under_the_oracle(estimator, reads):
    """``CloseCabinetManipulation`` reads ``env.obj_dof()`` (ground truth)
    only when ``prepare_controller`` stamped ``privileged_ok``, which it does
    for the ground-truth estimator alone."""
    from rgbmanip_tpu_torch.models.controller.gt_pose import bbox_to_center_axes

    cfg = load_config(STACKS["close_cabinet"] + GT + RUN + [
        f"pose_estimator={estimator}", "task.num_envs=2", "device=cpu"])
    env, manip, _, _ = build(port_train, cfg, get_logger())
    try:
        env.reset()
        reads_seen = []
        obj_dof = env.obj_dof

        def counted():
            reads_seen.append(1)
            return obj_dof()
        env.obj_dof = counted
        center, axes = bbox_to_center_axes(env.handle_bbox())
        manip.plan_pathway(center, axes, eval=True)
    finally:
        env.close()
    assert manip.privileged_ok is reads
    assert (len(reads_seen) > 0) is reads, f"{len(reads_seen)} reads of obj_dof"


# ------------------------------------------------------------------- configs --
@pytest.mark.parametrize("group, name", [(g, n) for g in sorted(COPIED) for n in COPIED[g]])
def test_every_copied_config_composes_as_in_jax(group, name):
    with open(os.path.join(CFG_ROOT, group, f"{name}.yaml")) as f:
        mine = yaml.safe_load(f)
    with open(os.path.join(REPO, "rgbmanip_tpu", "config", "cfg", group, f"{name}.yaml")) as f:
        assert mine == yaml.safe_load(f)
    ref = jax_load_config([f"{group}={name}"])
    out = load_config([f"{group}={name}"])
    assert out.pop("device") == "cuda"
    assert out == ref
