"""Experiment driver of the port (counterpart of ``rgbmanip_tpu/train.py``;
reference train.py:45-473), with hydra-style overrides. With no override it
runs the default stack of ``config.yaml``: the heuristic two-view controller
on the ground-truth estimator, ``open_cabinet``, ``train=test``:

    python -m rgbmanip_tpu_torch.train dataset=cabinet_train task=open_cabinet \\
        pose_estimator=ground_truth manipulation=open_cabinet \\
        controller=heuristic_pose train=test device=cpu

Every task runs: ``open_cabinet``/``open_drawer`` (and their ``_45``,
``_30`` and ``_no_dr`` variants), ``open_pot``, ``pick_mug``,
``close_cabinet`` and ``close_drawer``, on the procedural datasets and on
the URDF fixtures (``dataset=<cabinet|drawer|pot|mug>_urdf_fixture``).
``task=real_world`` builds the real-robot env without drivers, so its
first move or image raises (``envs/realworld``). ``manipulation=rl`` is the
PPO skill on the joint-space actions (``models/manipulation/rl.py``, with
its ``learn`` and ``policy`` blocks passed as overrides), trained by
``train=controller train.train_controller=false
train.train_manipulation=true``. Four run modes:
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

- ``train=collect``: write offline view pairs (``controller=collect_pose``,
  for the estimator's ``inference``) or point clouds with their position
  maps (``controller=collect_baselines``, for the baselines) into
  ``controller.learn.save_dir``;
- ``train=test_baseline``: replay the offline actions of
  ``train.action_path`` against the settings under
  ``train.task_setting_root`` (``controller=baseline``).

The estimator and the policy run on ``device`` (the card by default; the
run raises without one unless ``device=cpu`` is passed). The simulator and
the skills run on the host. ``RGBMANIP_PROFILE=<dir>`` records a
torch.profiler trace of the run into ``<dir>/trace.json``, and its spans
(``utils.logger.span``: each phase, and the estimate's stages inside its
``estimate`` phase) into ``<dir>/spans.json``. Each mode logs the env's
PhaseTimer split at its end, and a profiled run its spans.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .config.loader import ConfigError, load_config, save_config
from .utils.logger import SPANS, MetricsWriter, get_logger

def prepare_env(task_cfg, data_cfg, headless=True, viewerless=False, log=None, seed=0):
    """Construct the batched task env (reference train.py:45-149)."""
    from .envs.vec_env import CloseCabinetEnv, OpenCabinetEnv, OpenPotEnv

    name = task_cfg["name"]
    kw = dict(headless=headless, viewerless=viewerless, logger=log, seed=seed)
    if name in ("open_cabinet", "open_drawer", "open_cabinet_visualize"):
        return OpenCabinetEnv(data_cfg, task_cfg, **kw)
    if name in ("open_pot", "pick_mug"):
        return OpenPotEnv(data_cfg, task_cfg, **kw)
    if name in ("close_cabinet", "close_drawer"):
        return CloseCabinetEnv(data_cfg, task_cfg, **kw)
    if name == "real_world":
        # built without drivers: the first image or move raises
        from .envs.realworld.base_realworld import BaseRealworldEnv
        return BaseRealworldEnv()
    raise NotImplementedError(f"task {name!r}")


def prepare_manipulation(env, manip_cfg, log, train_cfg=None, device=None):
    """(reference train.py:151-178); an RL skill's policy runs on ``device``."""
    from .models.manipulation.close_cabinet import (
        CloseCabinetManipulation, CloseDrawerManipulation)
    from .models.manipulation.open_cabinet import OpenCabinetManipulation
    from .models.manipulation.open_drawer import OpenDrawerManipulation
    from .models.manipulation.open_pot import OpenPotManipulation
    from .models.manipulation.pick_mug import PickMugManipulation

    table = {
        "open_cabinet": OpenCabinetManipulation,
        "open_drawer": OpenDrawerManipulation,
        "open_pot": OpenPotManipulation,
        "pick_mug": PickMugManipulation,
        "close_cabinet": CloseCabinetManipulation,
        "close_drawer": CloseDrawerManipulation,
    }
    name = manip_cfg["name"]
    if name == "rl":
        from .models.manipulation.rl import RLManipulation
        return RLManipulation(env, manip_cfg, log, device=device)
    if name not in table:
        raise NotImplementedError(f"manipulation {name!r}")
    return table[name](env, manip_cfg, log)


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
    if name == "heuristic_pose":
        from .models.controller.heuristic_pose import HeuristicPoseController
        return HeuristicPoseController(env, pose_estimator, manipulation, ctrl_cfg, log)
    if name == "gt_pose":
        from .models.controller.gt_pose import GtPoseController
        return GtPoseController(env, pose_estimator, manipulation, ctrl_cfg, log)
    if name == "rl":
        from .models.controller.rl_pose import RLPoseController
        return RLPoseController(env, pose_estimator, manipulation, ctrl_cfg, cfg, log,
                                writer=writer, device=device)
    if name == "collection":
        from .models.controller.collection import CollectionController
        return CollectionController(env, pose_estimator, manipulation, ctrl_cfg, log)
    if name == "homing":
        from .models.controller.homing import HomingController
        return HomingController(env, pose_estimator, manipulation, ctrl_cfg, log)
    if name == "baseline":
        from .models.controller.baseline import BaselineController
        return BaselineController(env, pose_estimator, manipulation, ctrl_cfg, log)
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


def log_spans(summary, path, log):
    """Write the profiled run's spans (``SPANS.summary()``) to ``path`` and
    log them: per span, calls and host (and device) ms a call."""
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    spans = " ".join(f"{k}={v['calls']}x{v['host_ms']:.3f}"
                     + (f"/{v['device_ms']:.3f}" if "device_ms" in v else "") + "ms"
                     for k, v in summary.items())
    log.info(f"span timings (calls x host/device ms a call): {spans}")


def collect(env, controller, cfg, log):
    """(reference train.py:384-394)"""
    total_round = cfg["train"]["total_round"]
    n = env.num_envs
    for rnd in range(int(np.ceil(total_round / n))):
        env.reset()
        controller.run(eval=False)
        log.info(f"collect round {rnd + 1}")
    log_phases(env, log)


def train(env, controller, cfg, log):
    """PPO training of the camera-scheduling controller and, with
    ``train.train_manipulation``, of an RL skill (``manipulation=rl``)
    (reference train.py:396-410)."""
    iters = cfg["train"].get("iterations_per_epoch", 600)
    if cfg["train"].get("train_controller", False):
        controller.train_controller(iters)
    if cfg["train"].get("train_manipulation", False):
        controller.train_manipulation(iters)
    log_phases(env, log)


def _baseline_position_map(root, key):
    """Per-setting Position map (H, W, 3) for pixel-coordinate actions.

    The reference stores it inside the setting pickle
    (``observation.pic.camera0.Position``, train.py:318-320); our collection
    controller writes it to a sibling ``<key>.npz`` (collection.py).
    """
    npz_path = os.path.join(root, key + ".npz")
    if os.path.exists(npz_path):
        data = np.load(npz_path)
        if "position" in data:
            return data["position"]
    return None


def _floats(tokens):
    out = []
    for t in tokens:
        t = t.strip().strip("[](),")
        if not t:
            continue
        try:
            out.append(float(t))
        except ValueError:
            continue  # format junk between the numeric fields (scores, tags)
    return out


def parse_baseline_actions(action_path, settings, position_of=None):
    """Parse an offline baseline action file into [(key, action6), ...].

    Handles the reference's four formats (train.py:307-365):
      1. plain whitespace: ``key x y z dx dy dz``
      2. comma 3-D point:  ``name, [px, py, pz], [dx dy dz]``
      3. comma pixel:      ``name, [cx, cy], [dx, dy, dz]`` — the point is
         recovered from the setting's stored Position map at (cx, cy)
      4. Where2Act report (``_w2a_report`` in the filename):
         ``name (cx, cy) ... [xd xd xd] [yd yd yd]`` — pixel point + the x
         direction vector
    position_of(key) -> (H, W, 3) array or None supplies the Position maps.
    """
    is_w2a = "_w2a_report" in os.path.basename(action_path)
    actions = []
    with open(action_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if is_w2a:
                toks = line.split()
                key = toks[0]
                key = key[:-7] if key.endswith(".pickle") else key
                key = key[:-4] if key.endswith(".pkl") else key
                cx, cy = int(float(toks[1].strip("(),"))), \
                    int(float(toks[2].strip("(),")))
                # direction = the x vector, the FIRST bracketed group (any
                # score field between the pixel and the brackets is skipped,
                # reference train.py:326-331)
                groups = re.findall(r"\[([^\]]*)\]", line)
                if not groups:
                    continue
                nums = _floats(groups[0].split())
                if len(nums) < 3:
                    continue
                direction = np.asarray(nums[:3])
                pos = position_of(key) if position_of else None
                if pos is None:
                    continue
                point = np.asarray(pos[cx][cy][:3], np.float64)
            elif "," in line:
                block = [b.strip() for b in line.split(",")]
                key = block[0]
                key = key[:-7] if key.endswith(".pickle") else key
                key = key[:-4] if key.endswith(".pkl") else key
                nums = _floats(" ".join(block[1:]).replace(
                    "[", " ").replace("]", " ").split())
                if len(nums) >= 6:          # [px, py, pz], [dx, dy, dz]
                    point = np.asarray(nums[:3])
                    direction = np.asarray(nums[3:6])
                elif len(nums) == 5:        # [cx, cy], [dx, dy, dz]
                    cx, cy = int(nums[0]), int(nums[1])
                    direction = np.asarray(nums[2:5])
                    pos = position_of(key) if position_of else None
                    if pos is None:
                        continue
                    point = np.asarray(pos[cx][cy][:3], np.float64)
                else:
                    continue
            else:
                parts = line.split()
                key = parts[0]
                nums = _floats(parts[1:])
                if len(nums) < 6:
                    continue
                point, direction = np.asarray(nums[:3]), np.asarray(nums[3:6])
            if key not in settings:
                continue
            actions.append((key, np.concatenate([point, direction])))
    return actions


def test_baseline(env, controller, cfg, log):
    """Replay offline baseline actions against saved task settings
    (reference train.py:287-382)."""
    root = cfg["train"]["task_setting_root"]
    action_path = cfg["train"]["action_path"]
    if not root or not action_path:
        raise ConfigError("test_baseline needs train.task_setting_root and train.action_path")
    settings = {}
    for fname in sorted(os.listdir(root)):
        if fname.endswith((".pkl", ".pickle")):
            with open(os.path.join(root, fname), "rb") as f:
                settings[os.path.splitext(fname)[0]] = pickle.load(f)

    def position_of(key):
        s = settings.get(key)
        if isinstance(s, dict):        # reference layout: in-pickle map
            try:
                return s["observation"]["pic"]["camera0"]["Position"]
            except (KeyError, TypeError):
                pass
        return _baseline_position_map(root, key)

    succ, rounds = 0.0, 0
    for key, action in parse_baseline_actions(action_path, settings, position_of):
        controller.run(settings[key], action)
        obs = env.get_observation()
        succ += float(obs["success"].sum())
        rounds += env.num_envs
        log.info(f"baseline {key}: success {succ / rounds * 100:.2f}%")
    log.info(f"BASELINE success rate {succ / max(rounds, 1) * 100:.2f}%")
    log_phases(env, log)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = load_config(argv)
    log = get_logger()

    run_name = cfg["train"]["name"]
    modes = {"collect": collect, "train": train, "test_baseline": test_baseline}
    if run_name != "test" and run_name not in modes:
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
    manipulation = prepare_manipulation(env, cfg["manipulation"], log, cfg["train"], device)
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
        SPANS.reset()
        prof.start()
    result = None
    try:
        if run_name == "test":
            result = test(env, controller, cfg, log, writer)
        else:
            modes[run_name](env, controller, cfg, log)
    finally:
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            log_spans(SPANS.summary(), os.path.join(profile_dir, "spans.json"), log)
        writer.close()
        env.close()
    if result is not None:
        with open(os.path.join(save_dir, "result.json"), "w") as f:
            json.dump(result, f)
        log.info(f"wrote {os.path.join(save_dir, 'result.json')}")
    return result


if __name__ == "__main__":
    main()
