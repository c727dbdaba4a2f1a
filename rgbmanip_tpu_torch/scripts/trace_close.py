"""Categorise close_cabinet failures through the port (counterpart of
``scripts/trace_close.py``): run the REAL skill on the gt stack, record the
dof after the grasp and after each push step (by wrapping
``env.gripper_move_to``, ``env.hand_move_to`` and ``env.class_method``'s
``toggle_gripper``), plus the grasped state, for N rounds. Prints a
per-episode table.

    python -m rgbmanip_tpu_torch.scripts.trace_close [task] [rounds] [dataset]

Extra tokens with '=' are config overrides (``device=cpu`` where there is no
card; the gt stack itself runs on the host). ``main`` returns how often each
wrapped hook fired, by tag: a skill that moved through a private mover
instead would leave its tag at 0 and the table empty.
"""

from __future__ import annotations

import collections
import sys

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in args if "=" in a]
    pos = [a for a in args if "=" not in a]
    task = pos[0] if len(pos) > 0 else "close_cabinet"
    rounds = int(pos[1]) if len(pos) > 1 else 4
    dataset = pos[2] if len(pos) > 2 else "cabinet_train"
    cfg = load_config([f"dataset={dataset}", f"task={task}",
                       f"manipulation={task}", "controller=gt_pose",
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

        wrap("gripper_move_to", "push")
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

        for rnd in range(rounds):
            env.reset()
            trace.clear()
            d0 = env.obj_dof()[:, 0].copy()
            ctrl.run(eval=True)
            obs = env.get_observation()
            succ = obs["success"].astype(int)
            dN = env.obj_dof()[:, 0].copy()
            print(f"--- round {rnd}: success {succ.sum()}/{len(succ)}")
            for e in range(len(succ)):
                steps = " ".join(f"{tag[0]}{v[e]:.2f}{'*' if g[e] else ' '}"
                                 for tag, v, g in trace)
                print(f"  env{e} init {d0[e]:.2f} -> {dN[e]:.2f} "
                      f"succ={succ[e]} | {steps}")
    finally:
        log.setLevel(level)
        env.close()
    return dict(fired)


if __name__ == "__main__":
    main()
