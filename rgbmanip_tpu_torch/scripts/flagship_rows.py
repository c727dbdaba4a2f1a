"""The flagship evaluation's rows through the port, with the estimator in a
chosen compute dtype.

    python -m rgbmanip_tpu_torch.scripts.flagship_rows [--dtype bf16 f32] \\
        [--rounds 104] [--device cuda]

Each row is ``scripts/r5_cabinet_evals.sh``'s run of ``train=test``
(``controller=rl`` with ``checkpoints/ppo_rl_coadapt_model_165.ckpt``,
``pose_estimator=adapose_cabinet_fast`` with
``checkpoints/estimator_fast_cabinet_aug_r5.ckpt``, consensus fusion, 8
envs, seed 11): k=4 on ``cabinet_test``, k=4 on ``cabinet_train`` and k=3 on
``cabinet_test``. The run is ``python -m rgbmanip_tpu_torch.train``'s, but the
estimator is built here with ``AdaPoseEstimator(..., dtype=...)``: the
configs run it in f32, as the JAX package's do, and name no dtype. Prints
one JSON line: each dtype's success rate per row.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from .. import train as T
from ..config.loader import load_config
from ..models.pose_estimator.adapose import AdaPoseEstimator
from ..utils.logger import get_logger

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ROWS = {"k4_test": ("test", 4), "k4_train": ("train", 4), "k3_test": ("test", 3)}


def row_args(split: str, k: int, rounds: int, device: str):
    return [f"dataset=cabinet_{split}", "task=open_cabinet", "manipulation=open_cabinet",
            "controller=rl", "controller.load=checkpoints/ppo_rl_coadapt_model_165.ckpt",
            "pose_estimator=adapose_cabinet_fast",
            "pose_estimator.checkpoint_path=checkpoints/estimator_fast_cabinet_aug_r5.ckpt",
            "controller.estimate_fusion=consensus", f"controller.early_stop={k}",
            "train=test", f"train.total_round={rounds}", "task.num_envs=8", "seed=11",
            f"device={device}"]


def run_row(argv, dtype):
    """``train.main``'s ``train=test`` run of ``argv`` with the estimator in
    ``dtype``: its result dict."""
    cfg = load_config(argv)
    log = get_logger()
    device = resolve_device(cfg.get("device"))
    env = T.prepare_env(cfg["task"], cfg["dataset"], cfg.get("headless", True),
                        cfg.get("viewerless", False), log, seed=cfg.get("seed", 0))
    try:
        manipulation = T.prepare_manipulation(env, cfg["manipulation"], log, cfg["train"])
        estimator = AdaPoseEstimator(cfg["pose_estimator"], log, device=device, dtype=dtype)
        controller = T.prepare_controller(env, estimator, manipulation, cfg["controller"],
                                          cfg, log, device=device)
        return T.test(env, controller, cfg, log)
    finally:
        env.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", nargs="+", choices=sorted(DTYPES), default=["bf16", "f32"])
    ap.add_argument("--rounds", type=int, default=104)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        # f32 without TF32, as train.main runs it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in args.dtype:
        out[name] = {row: run_row(row_args(split, k, args.rounds, args.device),
                                  DTYPES[name])["success_rate"]
                     for row, (split, k) in ROWS.items()}
    print(json.dumps({"rounds": args.rounds, "success_rate": out}))
    return out


if __name__ == "__main__":
    main()
