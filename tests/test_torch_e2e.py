"""The ground-truth stack (``pose_estimator=ground_truth controller=gt_pose``,
the README's first command) through the port's ``train`` functions against
the JAX package's: the same seed gives the same success rate and move
distance for ``open_cabinet`` and ``open_drawer``. ``main`` writes
``result.json``."""

import glob
import json

import pytest

from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu import train as jax_train
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.config.loader import load_config
from rgbmanip_tpu_torch.utils.logger import get_logger

TASKS = {"open_cabinet": ["dataset=cabinet_train", "task=open_cabinet",
                          "manipulation=open_cabinet"],
         "open_drawer": ["dataset=drawer_train", "task=open_drawer",
                         "manipulation=open_drawer"]}
GT = ["pose_estimator=ground_truth", "controller=gt_pose", "train=test",
      "task.num_envs=4", "train.total_round=4", "seed=0"]


def run_stack(pkg, cfg, log):
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = pkg.prepare_manipulation(env, cfg["manipulation"], log)
        pe = pkg.prepare_pose_estimator(env, cfg["pose_estimator"], log)
        ctrl = pkg.prepare_controller(env, pe, manip, cfg["controller"], cfg, log)
        return pkg.test(env, ctrl, cfg, log)
    finally:
        env.close()


@pytest.mark.parametrize("task", sorted(TASKS))
def test_gt_stack_success_and_move_distance_equal_jax(task):
    over = TASKS[task] + GT
    ref = run_stack(jax_train, jax_load_config(over), jax_get_logger())
    out = run_stack(port_train, load_config(over + ["device=cpu"]), get_logger())
    print(task, "port", out, "jax", ref)
    assert out == ref
    assert out["rounds"] == 4


def test_main_writes_result_json(tmp_path):
    res = port_train.main(TASKS["open_drawer"] + GT + [
        "device=cpu", f"train.save_dir={tmp_path / 'saves'}",
        f"train.log_dir={tmp_path / 'logs'}"])
    files = glob.glob(str(tmp_path / "saves" / "test" / "*" / "result.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert json.load(f) == res
    assert sorted(res) == ["move_distance", "rounds", "success_rate"]
    assert glob.glob(str(tmp_path / "saves" / "test" / "*" / "config.yaml"))


def test_the_privilege_gate_opens_for_the_ports_own_oracle_only():
    """``prepare_controller`` stamps ``privileged_ok`` on the skill only for
    the port's ``GroundTruthPoseEstimator``; the JAX package's class of the
    same name must not open it."""
    from rgbmanip_tpu.models.pose_estimator.groundtruth_estimator import (
        GroundTruthPoseEstimator as JaxOracle)
    from rgbmanip_tpu_torch.models.manipulation.open_cabinet import OpenCabinetManipulation
    from rgbmanip_tpu_torch.models.pose_estimator.groundtruth_estimator import (
        GroundTruthPoseEstimator)

    cfg = load_config(TASKS["open_cabinet"] + GT + ["device=cpu"])
    log = get_logger()
    for oracle, expected in ((GroundTruthPoseEstimator(None, {}, log), True),
                             (JaxOracle(None, {}, log), False)):
        manip = OpenCabinetManipulation(None, cfg["manipulation"], log)
        port_train.prepare_controller(None, oracle, manip, cfg["controller"], cfg, log)
        assert manip.privileged_ok is expected
