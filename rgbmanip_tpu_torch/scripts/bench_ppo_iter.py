"""The full PPO iteration (rollout collect + update) at ``BASELINE.json``'s
shape: ``controller=rl`` on ``open_cabinet`` with gt observations, 64 envs
x 16 transitions, "PPO env-steps/sec (num_envs=64)" (counterpart of the
JAX package's ``scripts/bench_ppo_iter.py``).

    python -m rgbmanip_tpu_torch.scripts.bench_ppo_iter [num_envs] [iters] [key=value ...]

It builds the training stack through ``rgbmanip_tpu_torch.train``'s
``prepare_*`` functions and runs ``train_controller(iters)``. The collect
and learn seconds of each iteration come from the trainer's own record
(``PPO.history``), and the line printed is the best iteration's:
env-steps/s = T * N / (collect + learn). The collect half is the host's
simulator and renderer; the update runs on ``device``. The policy runs on
the card unless ``device=cpu`` is passed, and then the seconds are the
CPU's. The last line is one JSON object of the printed numbers.
Checkpoints go to a temporary directory.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import torch

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..utils.logger import get_logger


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    overrides = [a for a in args if "=" in a]
    pos = [a for a in args if "=" not in a]
    num_envs = int(pos[0]) if len(pos) > 0 else 64
    iters = int(pos[1]) if len(pos) > 1 else 3

    log = get_logger()
    with tempfile.TemporaryDirectory(prefix="bench_iter_") as save_dir:
        cfg = load_config([
            "dataset=cabinet_train", "task=open_cabinet",
            "manipulation=open_cabinet", "controller=rl",
            "pose_estimator=ground_truth", "train=controller",
            f"task.num_envs={num_envs}", "exp_name=bench_iter",
            f"controller.learn.save_dir={save_dir}",
        ] + overrides)
        device = resolve_device(cfg.get("device"))
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=0)
        try:
            manip = T.prepare_manipulation(env, cfg["manipulation"], log)
            pe = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
            ctrl = T.prepare_controller(env, pe, manip, cfg["controller"], cfg, log,
                                        device=device)
            t0 = time.time()
            ctrl.train_controller(iters)
            wall = time.time() - t0
        finally:
            env.close()

    history = ctrl.controller.history
    T_ = cfg["controller"]["learn"]["num_transitions_per_env"]
    best = min(history, key=lambda h: h["collect_s"] + h["learn_s"])
    fps = T_ * num_envs / (best["collect_s"] + best["learn_s"])
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"PPO full iteration at T={T_} N={num_envs} ({where}): best collect "
          f"{best['collect_s']:.2f}s + learn {best['learn_s']:.3f}s = {fps:.1f} "
          f"env-steps/s ({len(history)} iters, wall {wall:.1f}s)", flush=True)
    out = {"T": T_, "N": num_envs, "iters": len(history), "collect_s": best["collect_s"],
           "learn_s": best["learn_s"], "env_steps_per_s": fps, "wall_s": wall}
    print(json.dumps(out), flush=True)
    return dict(out, history=history)


if __name__ == "__main__":
    main()
