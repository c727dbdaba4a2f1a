"""Categorise open_drawer failures with the gt stack through the port
(counterpart of ``scripts/trace_drawer.py``): record the dof after the grasp
and after each pull step, plus the grasped state, over N rounds. Buckets:
never-grasped, grasped-but-slipped (dof regressed), partial pull (ended
below success_dof), planner/approach failures (no grasp attempt).

    python -m rgbmanip_tpu_torch.scripts.trace_drawer [dataset] [rounds] [task] [manipulation]

Extra tokens with '=' are config overrides (``device=cpu`` where there is no
card; the gt stack itself runs on the host). ``main`` returns the buckets
and how often each wrapped hook fired, by tag.
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
    split = pos[0] if len(pos) > 0 else "drawer_train"
    rounds = int(pos[1]) if len(pos) > 1 else 8
    task = pos[2] if len(pos) > 2 else "open_drawer"
    manip_name = pos[3] if len(pos) > 3 else task
    cfg = load_config([f"dataset={split}", f"task={task}",
                       f"manipulation={manip_name}", "controller=gt_pose",
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

        success_dof = cfg["task"]["object_conf"]["success_dof"]
        inverted = task.startswith("close")  # close tasks succeed when dof DROPS below
        trace = []
        fired = collections.Counter()

        def wrap(name, tag):
            orig = getattr(env, name)

            def f(*a, **kw):
                r = orig(*a, **kw)
                trace.append((tag, env.obj_dof()[:, 0].copy(),
                              env.grasped().astype(int).copy()))
                fired[tag] += 1
                return r

            setattr(env, name, f)

        wrap("gripper_move_to", "move")
        wrap("hand_move_to", "hand")
        orig_cm = env.class_method

        def traced_cm(name, **kw):
            r = orig_cm(name, **kw)
            if name == "toggle_gripper":
                trace.append(("grip", env.obj_dof()[:, 0].copy(),
                              env.grasped().astype(int).copy()))
                fired["grip"] += 1
            return r

        env.class_method = traced_cm

        buckets = {"success": 0, "never_grasped": 0, "slipped": 0, "partial": 0}
        for rnd in range(rounds):
            trace.clear()
            ctrl.run()
            dof = env.obj_dof()[:, 0]
            ok = (dof < success_dof) if inverted else (dof > success_dof)
            # per-env episode analysis from the trace
            steps = np.stack([t[1] for t in trace])          # (T, N)
            grasped = np.stack([t[2] for t in trace])        # (T, N)
            for i in range(len(dof)):
                if ok[i]:
                    buckets["success"] += 1
                    continue
                gi = grasped[:, i]
                di = steps[:, i]
                if not gi.any():
                    buckets["never_grasped"] += 1
                    tag = "never_grasped"
                elif di.max() - di[-1] > 0.03 or (gi.any() and not gi[-1]):
                    buckets["slipped"] += 1
                    tag = "slipped"
                else:
                    buckets["partial"] += 1
                    tag = "partial"
                print(f"rnd {rnd} env {i}: FAIL {tag} dof_end={dof[i]:.3f} "
                      f"dof_max={di.max():.3f} grasp_frac={gi.mean():.2f} "
                      f"dofs={np.round(di, 3).tolist()}")
            env.reset()

        n = rounds * env.num_envs
        print(f"\n=== {task}/{split}: {n} episodes, success_dof={success_dof}")
        for k, v in buckets.items():
            print(f"  {k:>14}: {v:3d}  ({100.0 * v / n:.1f}%)")
    finally:
        log.setLevel(level)
        env.close()
    return {"buckets": buckets, "fired": dict(fired)}


if __name__ == "__main__":
    main()
