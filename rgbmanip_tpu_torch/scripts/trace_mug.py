"""Probe pick_mug never-grasped failures with the gt stack through the port
(counterpart of ``scripts/trace_mug.py``): at gripper-close time record the
commanded-vs-actual hand pose error and the grip-centre distance to the gt
handle bbox centre, per env.

    python -m rgbmanip_tpu_torch.scripts.trace_mug [dataset] [rounds]

Extra tokens with '=' are config overrides (``device=cpu`` where there is no
card; the gt stack itself runs on the host). ``main`` returns how often each
wrapped hook fired (``hand_move_to`` and the gripper's close).
"""

from __future__ import annotations

import collections
import sys

import numpy as np

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in args if "=" in a]
    pos = [a for a in args if "=" not in a]
    split = pos[0] if len(pos) > 0 else "mug_train"
    rounds = int(pos[1]) if len(pos) > 1 else 8
    cfg = load_config([f"dataset={split}", "task=pick_mug",
                       "manipulation=pick_mug", "controller=gt_pose",
                       "pose_estimator=ground_truth", "train=test",
                       "task.num_envs=8"] + overrides)
    resolve_device(cfg.get("device"))
    log = get_logger()
    level = log.level
    log.setLevel("WARNING")
    env = T.prepare_env(cfg["task"], cfg["dataset"], True, False, log, seed=0)
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        est = T.prepare_pose_estimator(env, cfg["pose_estimator"], log)
        ctrl = T.prepare_controller(env, est, manip, cfg["controller"], cfg, log)

        orig_cm = env.class_method
        snap = {}
        fired = collections.Counter()
        orig_hmt = env.hand_move_to

        def traced_hmt(poses, *a, **kw):
            snap.setdefault("targets", []).append(np.asarray(poses)[:, :3].copy())
            fired["hand"] += 1
            return orig_hmt(poses, *a, **kw)

        env.hand_move_to = traced_hmt

        def traced_cm(name, **kw):
            if name == "toggle_gripper" and not kw.get("open", True):
                gt = env.get_observation(gt=True)
                bbox = np.asarray(gt["handle_bbox"])          # (N, 8, 3)
                center = bbox.mean(axis=1)
                gp = env.gripper_pose()[:, :3]
                hp = env.hand_pose()[:, :3] if hasattr(env, "hand_pose") else gp
                snap["close"] = (center.copy(), gp.copy(), hp.copy())
                fired["close"] += 1
            return orig_cm(name, **kw)

        env.class_method = traced_cm

        for rnd in range(rounds):
            ctrl.run()
            dof = env.obj_dof()[:, 0]
            ok = dof > cfg["task"]["object_conf"]["success_dof"][0]
            grasped = env.grasped()
            # an episode can abort before gripper-close (planner/IK exception);
            # skip the round instead of dying and losing prior rounds' output
            if snap.get("close") is None or snap.get("targets") is None:
                print(f"rnd {rnd}: aborted before grasp (no close/targets snap) "
                      f"ok={ok.tolist()}")
                snap.clear()
                env.reset()
                continue
            center, gp, hp = snap["close"]
            d = np.linalg.norm(gp - center, axis=-1)
            dz = gp[:, 2] - center[:, 2]
            dxy = np.linalg.norm((gp - center)[:, :2], axis=-1)
            base = env.robot_pose()[0, :3]  # not hardcoded: follows robot_conf.init_pose
            tg = snap["targets"]
            pre, grasp_t = tg[0], tg[1] if len(tg) > 1 else tg[0]
            for i in range(len(dof)):
                rp = np.linalg.norm(pre[i] - base)
                rg = np.linalg.norm(grasp_t[i] - base)
                print(f"rnd {rnd} env {i}: {'OK ' if ok[i] else 'FAIL'} "
                      f"grasped={int(grasped[i])} |grip-center|={d[i]:.3f} "
                      f"dxy={dxy[i]:.3f} dz={dz[i]:+.3f} "
                      f"|pre-base|={rp:.3f} |grasp-base|={rg:.3f} "
                      f"pre_z={pre[i, 2]:.3f}")
            snap.clear()
            env.reset()
    finally:
        log.setLevel(level)
        env.close()
    return dict(fired)


if __name__ == "__main__":
    main()
