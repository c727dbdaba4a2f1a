"""Train the AdaPose estimator on simulator-generated supervision
(counterpart of ``rgbmanip_tpu/models/pose_estimator/train_estimator.py``):
scenes randomised per batch, views rendered by the C++ raycaster, exact
labels derived analytically (``data.py``), and the train step on ``device``
(the card by default; ``device=cpu`` runs the plain path).

    python -m rgbmanip_tpu_torch.models.pose_estimator.train_estimator \\
        dataset=cabinet_train task=open_cabinet task.num_envs=8 seed=7 \\
        img_size=192 backend=resnet18 backbone_stride=32 volume_scale=8 \\
        n_depth=16 d_interval=0.15 warp_mode=nearest [bf16=0] \\
        [resume=checkpoints/estimator_fast_cabinet_aug_r5.ckpt] \\
        [steps=2000] [save=saves/estimator.ckpt] [device=cpu]

The keys are the JAX package's, plus ``device`` and ``log_dir`` (its
metrics, ``logs/estimator`` by default). ``bf16`` defaults to 1, as in the
JAX package: the network computes in bf16 with f32 parameters, gradients and
Adam; ``bf16=0`` trains in f32. ``train(dtype=...)`` defaults to f32, as the
JAX package's ``train`` does. The returned estimator's
``train_stats`` hold the steps, their seconds (in all and each step's, its
sampling included), the bytes the sampler copied to the device and the
PhaseTimer split: ``render`` (fresh view pairs),
``prepare`` (preprocessing and labels) and ``train_step``.
"""

from __future__ import annotations

import sys
import time

import torch

from ... import resolve_device
from ...config.loader import load_config
from ...utils.logger import MetricsWriter, get_logger

def train(overrides=None, steps: int = 2000, img_size: int = 224,
          n_pts: int = 1024, lr: float = 1e-4, save_path: str = "saves/estimator.ckpt",
          log_every: int = 10, save_every: int = 200, env=None,
          est_overrides: dict | None = None, reuse: int = 8, buffer_size: int = 32,
          resume: str = "", policy_ckpt: str = "", policy_mix: float = 0.5,
          policy_noise: float = 0.15, policy_pair: str = "last", view_aug: str = "box",
          device=None, log_dir: str = "logs/estimator", dtype=torch.float32):
    """Returns the trained ``AdaPoseEstimator`` (its head saved to
    ``save_path`` every ``save_every`` steps and at the end)."""
    log = get_logger()
    from ...train import prepare_env
    from .adapose import AdaPoseEstimator
    from .data import PolicyViewSampler, SimViewSampler
    from .training import EstimatorTrainer

    device = resolve_device(device)
    cfg = load_config(overrides or [])
    if env is None:
        env = prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg.get("seed", 0))
    # the volume settings default to those the production configs evaluate
    # with, so the network trains with the architecture it runs with
    est_cfg = {"name": "adapose_v5", "task_name": cfg["task"]["name"],
               "load": False, "checkpoint_path": "", "img_size": img_size,
               "use_depth": True, "n_pts": n_pts, "direct_regression": True,
               "real_world": False, "volume_scale": 2, "warp_mode": "nearest"}
    est_cfg.update(est_overrides or {})
    if resume:
        est_cfg.update(load=True, checkpoint_path=resume)
    est = AdaPoseEstimator(est_cfg, log, device=device, dtype=dtype)
    trainer = EstimatorTrainer(est.model, lr=lr)
    sampler_kw = dict(img_size=img_size, n_pts=n_pts, seed=cfg.get("seed", 0),
                      reuse=reuse, buffer_size=buffer_size, d_min=est.d_min,
                      d_interval=est.d_interval, n_depth=est.n_depth,
                      view_aug=view_aug, device=device)
    if policy_ckpt:
        # DAgger pass: views from the trained RL camera scheduler (the
        # scheduler's config comes from controller=rl in the overrides)
        log.info(f"policy-view sampling from {policy_ckpt} (mix={policy_mix}, "
                 f"noise={policy_noise}, pair={policy_pair})")
        sampler = PolicyViewSampler(env, cfg, policy_ckpt, mix=policy_mix,
                                    noise=policy_noise, pair_mode=policy_pair,
                                    **sampler_kw)
    else:
        sampler = SimViewSampler(env, **sampler_kw)
    timer = sampler.timer
    writer = MetricsWriter(log_dir)

    t0 = time.time()
    done = 0
    step_seconds = []
    while done < steps:
        t_step = time.time()
        batch = sampler.sample_batch()
        if batch is None:
            continue
        with timer.phase("train_step"):
            total, parts = trainer.step(batch)  # "valid" masks per-env losses
        done += 1
        step_seconds.append(time.time() - t_step)
        if done % log_every == 0:
            rate = done / (time.time() - t0)
            log.info(f"step {done}/{steps} loss {total:.4f} "
                     + " ".join(f"{k}={v:.3f}" for k, v in parts.items())
                     + f" ({rate:.2f} it/s)")
            writer.add_scalar("estimator/loss", total, done)
            writer.add_scalars(parts, done, prefix="estimator/")
        if done % save_every == 0 or done == steps:
            est.save(save_path)
    writer.close()
    est.train_stats = {"steps": done, "seconds": time.time() - t0,
                       "step_seconds": step_seconds,
                       "h2d_bytes": sampler.h2d_bytes, "phases": timer.summary(),
                       "counts": dict(timer.counts)}
    return est


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    local = ("steps", "img_size", "n_pts", "lr", "save", "log_every", "bf16",
             "volume_scale", "warp_mode", "backend", "n_depth",
             "volume_channels", "backbone_stride", "d_interval", "d_min",
             "reuse", "buffer_size", "resume", "policy_ckpt", "policy_mix",
             "policy_noise", "policy_pair", "view_aug", "save_every", "device",
             "log_dir")
    overrides = [a for a in argv if "=" in a and a.split("=")[0] not in local]
    est_overrides = {}
    for k in ("volume_scale", "n_depth", "volume_channels", "backbone_stride"):
        if k in kv:
            est_overrides[k] = int(kv[k])
    for k in ("warp_mode", "backend"):
        if k in kv:
            est_overrides[k] = kv[k]
    for k in ("d_interval", "d_min"):
        if k in kv:
            est_overrides[k] = float(kv[k])
    device = resolve_device(kv.get("device"))
    if device.type == "cuda":
        # no TF32 in the f32 parts, as the parity tests hold the estimator
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return train(overrides=overrides,
                 steps=int(kv.get("steps", 2000)),
                 img_size=int(kv.get("img_size", 224)),
                 n_pts=int(kv.get("n_pts", 1024)),
                 lr=float(kv.get("lr", 1e-4)),
                 save_path=kv.get("save", "saves/estimator.ckpt"),
                 est_overrides=est_overrides, reuse=int(kv.get("reuse", 8)),
                 buffer_size=int(kv.get("buffer_size", 32)),
                 resume=kv.get("resume", ""),
                 policy_ckpt=kv.get("policy_ckpt", ""),
                 policy_mix=float(kv.get("policy_mix", 0.5)),
                 policy_noise=float(kv.get("policy_noise", 0.15)),
                 policy_pair=kv.get("policy_pair", "last"),
                 view_aug=kv.get("view_aug", "box"),
                 save_every=int(kv.get("save_every", 200)),
                 log_every=int(kv.get("log_every", 10)),
                 device=device, log_dir=kv.get("log_dir", "logs/estimator"),
                 dtype=torch.bfloat16 if kv.get("bf16", "1") != "0" else torch.float32)


if __name__ == "__main__":
    main()
