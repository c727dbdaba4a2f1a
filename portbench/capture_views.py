"""Records the view pairs that the flagship evaluation hands its estimator,
as the table the estimate cells' traffic draws from (``traffic/<name>.json``):
for each view pair of each estimate, both views' mask windows (the bounding
box of the part's mask, or null for an empty mask) and camera extrinsics
(world -> camera), the camera's intrinsics, the step of the episode and the
env. It drives the evaluation's stack (``drivers/evaluate`` with
``workloads/<workload>.json`` and ``configs/<config>.json``) on the card over
``--rounds`` rounds of scenes that the env's own generator draws at
``--scene-seed``, so the table is the evaluation's geometry on scenes that
the evaluation's traffic file does not run:

    python3 -m portbench.capture_views --workload fast.eval_cabinet --rounds 32 \
        --scene-seed 23 --out portbench/traffic/cabinet_test_views.json
"""

import argparse
import json
import sys

import numpy as np


def window(mask):
    """[y0, x0, y1, x1] (inclusive) of a (H, W) mask's pixels, or None."""
    ys, xs = np.flatnonzero(mask.any(1)), np.flatnonzero(mask.any(0))
    if not len(ys):
        return None
    return [int(ys[0]), int(xs[0]), int(ys[-1]), int(xs[-1])]


def flat(a):
    """A float32 matrix as a list, to 7 decimals."""
    return [round(float(x), 7) for x in np.asarray(a, np.float64).reshape(-1)]


def rows(K, m1, e1, m2, e2, step):
    """One table row per view pair of an estimate call."""
    return [{"step": step, "env": j, "K": flat(K[j]),
             "win1": window(np.asarray(m1[j])), "ext1": flat(e1[j]),
             "win2": window(np.asarray(m2[j])), "ext2": flat(e2[j])} for j in range(len(m1))]


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.capture_views")
    p.add_argument("--workload", default="fast.eval_cabinet")
    p.add_argument("--config", default="adapose_cabinet_fast")
    p.add_argument("--rounds", type=int, default=32)
    p.add_argument("--scene-seed", type=int, default=23)
    p.add_argument("--out", required=True)
    p.add_argument("--envs", type=int, default=None, help="envs a round (the workload's by default)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from portbench import harness as H
    from portbench.drivers import evaluate as V
    wl = H.load_json(H.HERE, "workloads", f"{args.workload}.json")
    cfg = H.load_json(H.HERE, "configs", f"{args.config}.json")
    wl.update(scene_seed=args.scene_seed, scene_rounds=args.rounds)
    if args.envs:
        wl["overrides"] = [o for o in wl["overrides"] if not o.startswith("task.num_envs")] \
            + [f"task.num_envs={args.envs}"]
    device = torch.device(args.device)
    env, est, ctrl, rec, sched = V.build(cfg, wl, 0, device)
    table = []
    inner = est.estimate
    state = {"step": 0, "image": None}

    def estimate(K, rgb1, m1, e1, rgb2, m2, e2):
        state["step"] += 1
        state["image"] = list(np.asarray(m1).shape[1:])
        table.extend(rows(K, m1, e1, m2, e2, state["step"]))
        return inner(K, rgb1, m1, e1, rgb2, m2, e2)

    est.estimate = estimate
    success = 0.0
    try:
        for _ in range(args.rounds):
            state["step"] = 0
            success += V.one_round(env, ctrl, rec, next(sched))
    finally:
        env.close()
    out = {"captured": f"{args.workload} stack, {args.rounds} rounds of {env.num_envs} envs "
                       f"at scene seed {args.scene_seed}, success {success:g}",
           "image": state["image"],
           "pairs": table}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({"pairs": len(table), "success": success,
                      "empty_windows": sum(r["win1"] is None or r["win2"] is None
                                           for r in table)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
