"""Mug miss anatomy under the LEARNED estimator, through the port
(counterpart of ``scripts/trace_mug_learned.py``): heuristic + AdaPose with
``adapose_mug_fast`` (K1 on every estimate). Per env-episode it records the
estimate's signed centre-error components (approach axis, lateral,
vertical), whether the grasp engaged (after the re-grasp probes), and
success, to direct the probe pattern in ``pick_mug.plan_pathway``.

    python -m rgbmanip_tpu_torch.scripts.trace_mug_learned [mug_test] [rounds=8]

Extra tokens with '=' are config overrides (``device=cpu`` runs the
estimator on the CPU; the card is the default). ``main`` returns the rows
(e_approach, e_lateral, e_z, |err|, grasped, success), one per episode.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger

CKPT = "checkpoints/estimator_fast_mug_fine_r5.ckpt"


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in args if "=" in a]
    pos = [a for a in args if "=" not in a]
    split = pos[0] if len(pos) > 0 else "mug_test"
    rounds = int(pos[1]) if len(pos) > 1 else 8
    cfg = load_config([f"dataset={split}", "task=pick_mug",
                       "manipulation=pick_mug", "controller=heuristic_pose",
                       "pose_estimator=adapose_mug_fast",
                       f"pose_estimator.checkpoint_path={CKPT}",
                       "pose_estimator.d_min=0.35", "pose_estimator.d_interval=0.08",
                       "train=test", "task.num_envs=8", "seed=11"] + overrides)
    device = resolve_device(cfg.get("device"))
    if device.type == "cuda":
        # f32 without TF32, as train.main runs it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    log = get_logger()
    level = log.level
    log.setLevel("WARNING")
    env = T.prepare_env(cfg["task"], cfg["dataset"], True, False, log, seed=11)
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        est = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, est, manip, cfg["controller"], cfg, log,
                                    device=device)

        rows = []  # (e_approach, e_lat, e_z, err_norm, grasped, success)
        orig_pp = manip.plan_pathway

        def traced_pp(center, axis, eval=False):
            gt = np.asarray(env.get_observation(gt=True)["handle_bbox"])
            gt_center = gt.mean(axis=1)  # true box center, ordering-independent
            err = np.asarray(center) - gt_center          # (N, 3) signed world error
            ax = np.asarray(axis)[:, 1].copy()            # approach = handle dir
            z_ = np.array([0.0, 0.0, 1.0])
            ax[:, 2] = 0.0                                # horizontal projection
            n = np.linalg.norm(ax, axis=-1, keepdims=True) + 1e-9
            ax /= n
            lat = np.cross(np.tile(z_, (len(ax), 1)), ax)
            e_app = (err * ax).sum(-1)
            e_lat = (err * lat).sum(-1)
            e_z = err[:, 2]
            out = orig_pp(center, axis, eval)
            grasped = env.grasped().astype(bool)
            succ = np.asarray(env.get_observation(gt=True)["success"]).reshape(-1)
            for i in range(len(e_app)):
                rows.append((e_app[i], e_lat[i], e_z[i],
                             float(np.linalg.norm(err[i])), bool(grasped[i]),
                             bool(succ[i])))
            return out

        manip.plan_pathway = traced_pp
        for r in range(rounds):
            env.reset()
            ctrl.run(eval=True)
            print(f"round {r + 1}/{rounds}", flush=True)

        a = np.array([(p, l, z, e, g, s) for p, l, z, e, g, s in rows])
        g = a[:, 4] > 0.5
        s = a[:, 5] > 0.5
        print(f"\n{len(a)} episodes: grasped {g.mean()*100:.1f}%  success {s.mean()*100:.1f}%")
        for name, m in (("grasped", g), ("NOT grasped", ~g)):
            if m.sum() == 0:
                continue
            r = a[m]
            print(f"{name:12s} n={m.sum():3d}  |e_app| med {np.median(np.abs(r[:,0]))*100:.1f}cm"
                  f"  |e_lat| med {np.median(np.abs(r[:,1]))*100:.1f}cm"
                  f"  |e_z| med {np.median(np.abs(r[:,2]))*100:.1f}cm"
                  f"  |err| med {np.median(r[:,3])*100:.1f}cm")
        ng = a[~g]
        if len(ng):
            print("NOT-grasped signed comps: e_app med %.1f cm, e_lat med %.1f, e_z med %.1f"
                  % tuple(np.median(ng[:, i]) * 100 for i in range(3)))
            print("NOT-grasped |err|>3cm: %.0f%%  |e_z|>1.8cm: %.0f%%  |e_lat|>2cm: %.0f%%"
                  % ((np.abs(ng[:, 3]) > 0.03).mean() * 100,
                     (np.abs(ng[:, 2]) > 0.018).mean() * 100,
                     (np.abs(ng[:, 1]) > 0.02).mean() * 100))
    finally:
        log.setLevel(level)
        env.close()
    return rows


if __name__ == "__main__":
    main()
