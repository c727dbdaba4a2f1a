"""Full evaluation sweep through the port: every task x split at >=100
episodes, one JSON file (the port's counterpart of ``scripts/eval_sweep.py``;
reference evaluations are 100-round, cfg/train/test.yaml:5).

    python -m rgbmanip_tpu_torch.scripts.eval_sweep [rounds] [controller] [pose_estimator]
  controller: gt_pose (default) | heuristic_pose | rl
  pose_estimator: ground_truth (default) | adapose_cabinet_fast | ...

Extra tokens with '=' are passed through to every row as config overrides
(e.g. ``pose_estimator.checkpoint_path=... controller.load=...``;
``device=cpu`` runs the estimator and the policy on the CPU, the card being
the default). A row whose task is not of the estimator's category runs the
ground-truth estimator, as in the JAX script.

Two deliberate differences from the JAX script:
- it writes ``docs/sweep_torch_{controller}_{estimator}.json`` (relative to
  the working directory, as the JAX script writes its file), so that a run
  from the repo root never overwrites the JAX package's committed
  ``docs/sweep_*.json``, which are the reference's results;
- a row that raises is recorded as ``{"error": "Type: message"}`` and the
  sweep goes on, as in JAX, but once the file is written the script exits
  non-zero if any row failed, so that a failed row is never taken for a
  finished sweep.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger

ROWS = [
    # task, manipulation, [(split-name, dataset)...]
    ("open_cabinet", "open_cabinet", [("train", "cabinet_train"), ("test", "cabinet_test")]),
    ("open_cabinet_45", "open_cabinet", [("train", "cabinet_train"), ("test", "cabinet_test")]),
    ("open_drawer", "open_drawer", [("train", "drawer_train"), ("test", "drawer_test")]),
    ("open_drawer_30", "open_drawer", [("train", "drawer_train"), ("test", "drawer_test")]),
    ("open_pot", "open_pot", [("train", "pot_train"), ("test", "pot_test")]),
    ("pick_mug", "pick_mug", [("train", "mug_train"), ("test", "mug_test")]),
    ("close_cabinet", "close_cabinet", [("train", "cabinet_train"), ("test", "cabinet_test")]),
    ("close_drawer", "close_drawer", [("train", "drawer_train"), ("test", "drawer_test")]),
]


def row_overrides(task, manip_name, dataset, rounds, controller, estimator, passthru):
    """The config overrides of one row (scripts/eval_sweep.py:50-60)."""
    cat_ok = estimator == "ground_truth" or \
        any(k in estimator for k in task.split("_"))
    return [
        f"dataset={dataset}", f"task={task}",
        f"manipulation={manip_name}", f"controller={controller}",
        f"pose_estimator={estimator if cat_ok else 'ground_truth'}",
        "train=test", f"train.total_round={rounds}",
        "task.num_envs=8",
    ] + list(passthru)


def run_row(overrides, log):
    """One row's ``train=test`` run: its result as the sweep records it."""
    cfg = load_config(overrides)
    device = resolve_device(cfg.get("device"))
    if device.type == "cuda":
        # f32 without TF32, as train.main runs it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=0)
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log, cfg["train"], device)
        pe = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, pe, manip, cfg["controller"], cfg, log,
                                    device=device)
        r = T.test(env, ctrl, cfg, log)
    finally:
        env.close()
    return {"success": round(r["success_rate"], 2),
            "move": round(r["move_distance"], 3),
            "episodes": r["rounds"]}


def sweep(rows, rounds, controller, estimator, passthru, log):
    """Every row of ``rows`` (``ROWS``' form): {"task/split": result or
    {"error": "Type: message"}}."""
    results = {}
    for task, manip_name, splits in rows:
        for split, dataset in splits:
            key = f"{task}/{split}"
            try:
                results[key] = run_row(row_overrides(task, manip_name, dataset, rounds,
                                                     controller, estimator, passthru), log)
                r = results[key]
                print(f"{key:28s}: {r['success']:6.2f}% "
                      f"({r['episodes']} eps)", flush=True)
            except Exception as e:  # record, keep sweeping
                results[key] = {"error": f"{type(e).__name__}: {e}"}
                print(f"{key:28s}: ERROR {e}", flush=True)
    return results


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    passthru = [a for a in args if "=" in a]
    pos = [a for a in args if "=" not in a]
    rounds = int(pos[0]) if len(pos) > 0 else 104
    controller = pos[1] if len(pos) > 1 else "gt_pose"
    estimator = pos[2] if len(pos) > 2 else "ground_truth"

    log = get_logger()
    level = log.level
    log.setLevel("WARNING")
    t0 = time.time()
    try:
        results = sweep(ROWS, rounds, controller, estimator, passthru, log)
    finally:
        log.setLevel(level)
    out = {"controller": controller, "estimator": estimator,
           "rounds": rounds, "results": results,
           "wall_s": round(time.time() - t0, 1)}
    fname = f"docs/sweep_torch_{controller}_{estimator}.json"
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    with open(fname, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {fname} in {out['wall_s']}s")
    failed = [k for k, v in results.items() if "error" in v]
    if failed:
        raise SystemExit(f"{len(failed)} of {len(results)} rows failed: {', '.join(failed)}")
    return out


if __name__ == "__main__":
    main()
