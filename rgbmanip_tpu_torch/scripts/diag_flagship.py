"""Diagnose the RL + AdaPose flagship against heuristic + AdaPose through the
port (counterpart of ``scripts/diag_flagship.py``).

The scheduler with a gt estimator scores 95.8%; heuristic + AdaPose 85.6 /
88.5; RL + AdaPose ~70 / 63 (the JAX package's rows, on its TPU). The
hypothesis: the estimator degrades on policy-chosen view pairs
(distribution shift and/or a small stereo baseline). This script runs the
RL evaluation loop and, at every estimation, records per env:

  - the angular baseline between the two views used (the angle subtended at
    the gt handle centre by the two camera positions),
  - the translation distance between the two camera positions,
  - the estimate's centre error against gt (corners (0, 7) centre, the read
    of ``call_manipulation`` and of the reference rl_pose.py:366).

It then runs the heuristic controller with the SAME estimator checkpoint and
records the same quantities for its fixed view pair, printing both tables.

    EST_CKPT=checkpoints/estimator_fast_cabinet_aug_r5.ckpt \\
        python -m rgbmanip_tpu_torch.scripts.diag_flagship <rl_ckpt> [rounds] [num_envs]

``EST_CKPT`` names the estimator (``scripts/r5_stageD.sh:18``; by default
``checkpoints/estimator_fast_cabinet_dagger_r3.ckpt``, as in the JAX
script). Extra tokens with '=' are config overrides (``device=cpu`` runs
the estimator and the policy on the CPU; the card is the default).
``main`` returns both recorders and both success counts.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger


def cam_centers_from_extr(extr):
    """extr: (N, 4, 4) world->cam. Returns camera centers in world (N, 3)."""
    R = extr[:, :3, :3]
    t = extr[:, :3, 3]
    return -np.einsum("nij,ni->nj", R, t)


class Recorder:
    def __init__(self):
        self.rows = []  # (step, baseline_deg, cam_dist, center_err)

    def record(self, extr1, extr2, pred_bbox, gt_bbox, step):
        c1 = cam_centers_from_extr(np.asarray(extr1, np.float64))
        c2 = cam_centers_from_extr(np.asarray(extr2, np.float64))
        gt_center = (gt_bbox[:, 0] + gt_bbox[:, 6]) / 2
        v1 = c1 - gt_center
        v2 = c2 - gt_center
        cosang = np.sum(v1 * v2, axis=-1) / (
            np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9)
        ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
        dist = np.linalg.norm(c1 - c2, axis=-1)
        pred_center = (pred_bbox[:, 0] + pred_bbox[:, 7]) / 2
        err = np.linalg.norm(pred_center - gt_center, axis=-1)
        for a, d, e in zip(ang, dist, err):
            self.rows.append((step, a, d, e))

    def table(self, name):
        rows = np.array(self.rows)
        if not len(rows):
            print(f"{name}: no estimations recorded")
            return
        print(f"\n== {name}: {len(rows)} estimations ==")
        print("step  n    baseline_deg  cam_dist_m  center_err_cm  err>10cm%")
        for s in sorted(set(rows[:, 0].astype(int))):
            r = rows[rows[:, 0] == s]
            print(f"{s:4d} {len(r):4d}  {np.median(r[:, 1]):10.1f}  "
                  f"{np.median(r[:, 2]):9.3f}  {np.median(r[:, 3]) * 100:12.2f}  "
                  f"{(r[:, 3] > 0.10).mean() * 100:8.1f}")
        print(f"all  {len(rows):4d}  {np.median(rows[:, 1]):10.1f}  "
              f"{np.median(rows[:, 2]):9.3f}  {np.median(rows[:, 3]) * 100:12.2f}  "
              f"{(rows[:, 3] > 0.10).mean() * 100:8.1f}")


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in args if "=" in a]
    pos = [a for a in args if "=" not in a]
    rl_ckpt = pos[0]
    rounds = int(pos[1]) if len(pos) > 1 else 4
    num_envs = int(pos[2]) if len(pos) > 2 else 8

    log = get_logger()
    cfg = load_config([
        "dataset=cabinet_test", "task=open_cabinet",
        "manipulation=open_cabinet", "controller=rl",
        f"controller.load={rl_ckpt}",
        "pose_estimator=adapose_cabinet_fast",
        "pose_estimator.checkpoint_path=" + os.environ.get(
            "EST_CKPT", "checkpoints/estimator_fast_cabinet_dagger_r3.ckpt"),
        "train=test", f"task.num_envs={num_envs}", "seed=11",
        "exp_name=diag_flagship",
    ] + overrides)
    device = resolve_device(cfg.get("device"))
    if device.type == "cuda":
        # f32 without TF32, as train.main runs it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=11)
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        pe = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, pe, manip, cfg["controller"], cfg, log,
                                    device=device)
        iface = ctrl.control_interface

        rec_rl = Recorder()
        orig_estimate = pe.estimate

        def tapped_estimate(intr, rgb1, msk1, extr1, rgb2, msk2, extr2):
            out = orig_estimate(intr, rgb1, msk1, extr1, rgb2, msk2, extr2)
            gt = np.asarray(env.get_observation(gt=True)["handle_bbox"])
            rec_rl.record(extr1, extr2, np.asarray(out), gt,
                          iface.accumulate_steps)
            return out

        pe.estimate = tapped_estimate
        succ = 0
        for r in range(rounds):
            env.reset()
            ctrl.run(eval=True)
            s = np.asarray(env.get_observation(gt=True)["success"]).reshape(-1)
            succ += s.sum()
            print(f"round {r + 1}/{rounds}: success "
                  f"{succ / ((r + 1) * num_envs) * 100:.1f}%")
        rec_rl.table(f"RL policy ({rl_ckpt})")

        # heuristic with the same estimator
        rec_h = Recorder()

        def tapped_estimate_h(intr, rgb1, msk1, extr1, rgb2, msk2, extr2):
            out = orig_estimate(intr, rgb1, msk1, extr1, rgb2, msk2, extr2)
            gt = np.asarray(env.get_observation(gt=True)["handle_bbox"])
            rec_h.record(extr1, extr2, np.asarray(out), gt, 0)
            return out

        pe.estimate = tapped_estimate_h
        from ..models.controller.heuristic_pose import HeuristicPoseController
        hctrl = HeuristicPoseController(env, pe, manip, cfg["controller"], log)
        hsucc = 0
        for r in range(rounds):
            env.reset()
            hctrl.run(eval=True)
            s = np.asarray(env.get_observation(gt=True)["success"]).reshape(-1)
            hsucc += s.sum()
        rec_h.table("heuristic fixed views (same estimator)")
        print(f"\nsuccess: RL {succ / (rounds * num_envs) * 100:.1f}%  "
              f"heuristic {hsucc / (rounds * num_envs) * 100:.1f}%")
    finally:
        env.close()
    return {"rl": rec_rl, "heuristic": rec_h, "rl_success": int(succ),
            "heuristic_success": int(hsucc), "episodes": rounds * num_envs}


if __name__ == "__main__":
    main()
