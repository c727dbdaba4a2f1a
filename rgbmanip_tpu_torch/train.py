"""Experiment driver of the port (counterpart of ``rgbmanip_tpu/train.py``;
reference train.py:45-473), with hydra-style overrides:

    python -m rgbmanip_tpu_torch.train dataset=cabinet_train task=open_cabinet \\
        pose_estimator=ground_truth manipulation=open_cabinet \\
        controller=gt_pose train=test device=cpu

Two run modes are ported:
- ``train=test``: evaluate ``train.total_round`` episodes and report the
  success rate and the move distance, written to ``result.json``;
- ``train=controller``: PPO-train the camera-scheduling policy
  (``controller=rl``) for ``train.iterations_per_epoch`` iterations, from
  ``controller.load`` or a fresh policy, writing ``model_<it>.ckpt`` into
  ``controller.learn.save_dir``:

    python -m rgbmanip_tpu_torch.train dataset=cabinet_train task=open_cabinet \
        manipulation=open_cabinet controller=rl train=controller \
        pose_estimator=adapose_cabinet_fast \
        controller.load=checkpoints/ppo_rl_coadapt_model_165.ckpt

The estimator and the policy run on ``device`` (the card by default; the
run raises without one unless ``device=cpu`` is passed). The simulator and
the skills run on the host. ``RGBMANIP_PROFILE=<dir>`` records a
torch.profiler trace of the run into ``<dir>/trace.json``. Either mode logs
the env's PhaseTimer split at its end.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .config.loader import load_config, save_config
from .utils.logger import MetricsWriter, get_logger

_CONTROLLERS = "(ROADMAP.md, Queue 1: 'the remaining controllers and run modes')"
_MANIP_RL = "(ROADMAP.md, Queue 1: 'RLManipulation')"
_TASKS = "(ROADMAP.md, Queue 1: 'the pot, mug and close tasks')"
_REALWORLD = "(ROADMAP.md, Queue 1: 'the real-world env')"


def prepare_env(task_cfg, data_cfg, headless=True, viewerless=False, log=None, seed=0):
    """Construct the batched task env (reference train.py:45-149)."""
    from .envs.vec_env import OpenCabinetEnv

    name = task_cfg["name"]
    if name in ("open_cabinet", "open_drawer", "open_cabinet_visualize"):
        return OpenCabinetEnv(data_cfg, task_cfg, headless=headless,
                              viewerless=viewerless, logger=log, seed=seed)
    if name in ("open_pot", "pick_mug", "close_cabinet", "close_drawer"):
        raise NotImplementedError(f"task {name!r} is not ported yet {_TASKS}")
    if name == "real_world":
        raise NotImplementedError(f"task {name!r} is not ported yet {_REALWORLD}")
    raise NotImplementedError(f"task {name!r}")


def prepare_manipulation(env, manip_cfg, log):
    """(reference train.py:151-178)"""
    from .models.manipulation.open_cabinet import OpenCabinetManipulation
    from .models.manipulation.open_drawer import OpenDrawerManipulation

    name = manip_cfg["name"]
    table = {"open_cabinet": OpenCabinetManipulation,
             "open_drawer": OpenDrawerManipulation}
    if name in table:
        return table[name](env, manip_cfg, log)
    if name == "rl":
        raise NotImplementedError(f"manipulation {name!r} is not ported yet {_MANIP_RL}")
    if name in ("open_pot", "pick_mug", "close_cabinet", "close_drawer"):
        raise NotImplementedError(f"manipulation {name!r} is not ported yet {_TASKS}")
    raise NotImplementedError(f"manipulation {name!r}")


def prepare_pose_estimator(env, pe_cfg, log, device=None):
    """(reference train.py:216-260); the estimator runs on ``device``."""
    name = pe_cfg["name"]
    if name == "ground_truth":
        from .models.pose_estimator.groundtruth_estimator import GroundTruthPoseEstimator
        return GroundTruthPoseEstimator(env, pe_cfg, log)
    if name.startswith("adapose"):
        from .models.pose_estimator.adapose import AdaPoseEstimator
        return AdaPoseEstimator(pe_cfg, log, device=device)
    raise NotImplementedError(f"pose_estimator {name!r}")


def prepare_controller(env, pose_estimator, manipulation, ctrl_cfg, cfg, log,
                       writer=None, device=None):
    """(reference train.py:180-214); the policy runs on ``device``."""
    # Privileged-state gate: skills may only read gt env state when the
    # estimator itself is the gt oracle; a learned-perception stack must
    # stay proprioceptive end to end.
    from .models.pose_estimator.groundtruth_estimator import GroundTruthPoseEstimator
    if manipulation is not None:
        manipulation.privileged_ok = isinstance(pose_estimator,
                                                GroundTruthPoseEstimator)
    name = ctrl_cfg["name"]
    if name == "gt_pose":
        from .models.controller.gt_pose import GtPoseController
        return GtPoseController(env, pose_estimator, manipulation, ctrl_cfg, log)
    if name == "rl":
        from .models.controller.rl_pose import RLPoseController
        return RLPoseController(env, pose_estimator, manipulation, ctrl_cfg, cfg, log,
                                writer=writer, device=device)
    if name in ("heuristic_pose", "collection", "homing", "baseline"):
        raise NotImplementedError(f"controller {name!r} is not ported yet {_CONTROLLERS}")
    raise NotImplementedError(f"controller {name!r}")


def test(env, controller, cfg, log, writer=None):
    """Evaluation loop (reference train.py:262-285): run total_round rounds,
    report success rate and mean move distance."""
    total_round = cfg["train"]["total_round"]
    n = env.num_envs
    succ, dist, rounds = 0.0, 0.0, 0
    t0 = time.time()
    for rnd in range(int(np.ceil(total_round / n))):
        env.reset()
        controller.run(eval=True)
        obs = env.get_observation()
        succ += float(obs["success"].sum())
        dist += float(obs["total_move_distance"].sum())
        rounds += n
        rate = succ / rounds * 100
        log.info(f"round {rounds}/{total_round}: success {rate:.2f}% "
                 f"move {dist / rounds:.3f} m ({(time.time()-t0)/rounds:.2f} s/ep)")
        if writer:
            writer.add_scalar("test/success_rate", rate, rounds)
            writer.add_scalar("test/move_distance", dist / rounds, rounds)
        if rounds >= total_round:
            break
    log.info(f"FINAL success rate {succ / rounds * 100:.2f}%  "
             f"move distance {dist / rounds:.3f} m over {rounds} episodes")
    log_phases(env, log)
    return {"success_rate": succ / rounds * 100, "move_distance": dist / rounds,
            "rounds": rounds}


def log_phases(env, log):
    phases = " ".join(f"{k}={v:.3f}s" for k, v in env.timer.summary().items())
    log.info(f"phase timings: {phases}")


def train(env, controller, cfg, log):
    """PPO training of the camera-scheduling controller (reference
    train.py:396-410)."""
    iters = cfg["train"].get("iterations_per_epoch", 600)
    if cfg["train"].get("train_manipulation", False):
        raise NotImplementedError(f"train.train_manipulation (RLManipulation, "
                                  f"manipulation=rl) is not ported yet {_MANIP_RL}")
    if cfg["train"].get("train_controller", False):
        controller.train_controller(iters)
    log_phases(env, log)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config(argv)
    log = get_logger()

    run_name = cfg["train"]["name"]
    if run_name in ("collect", "test_baseline"):
        raise NotImplementedError(f"train={run_name!r} is not ported yet {_CONTROLLERS}")
    if run_name not in ("test", "train"):
        raise NotImplementedError(run_name)
    device = resolve_device(cfg.get("device"))
    if device.type == "cuda":
        # f32 throughout, as the parity tests hold the estimator: cuDNN would
        # otherwise run the f32 convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    stamp = time.strftime("%Y-%m-%d_%H-%M-%S") + "_" + str(cfg.get("exp_name", "run"))
    log_dir = os.path.join(cfg["train"].get("log_dir", "./logs"), run_name, stamp)
    save_dir = os.path.join(cfg["train"].get("save_dir", "./saves"), run_name, stamp)
    os.makedirs(save_dir, exist_ok=True)
    writer = MetricsWriter(log_dir)
    save_config(cfg, os.path.join(save_dir, "config.yaml"))

    env = prepare_env(cfg["task"], cfg["dataset"], cfg.get("headless", True),
                      cfg.get("viewerless", False), log, seed=cfg.get("seed", 0))
    manipulation = prepare_manipulation(env, cfg["manipulation"], log)
    pose_estimator = prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
    controller = prepare_controller(env, pose_estimator, manipulation,
                                    cfg["controller"], cfg, log, writer=writer,
                                    device=device)

    profile_dir = os.environ.get("RGBMANIP_PROFILE")
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    result = None
    try:
        if run_name == "test":
            result = test(env, controller, cfg, log, writer)
        else:
            train(env, controller, cfg, log)
    finally:
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        writer.close()
        env.close()
    if result is not None:
        with open(os.path.join(save_dir, "result.json"), "w") as f:
            json.dump(result, f)
        log.info(f"wrote {os.path.join(save_dir, 'result.json')}")
    return result


if __name__ == "__main__":
    main()
