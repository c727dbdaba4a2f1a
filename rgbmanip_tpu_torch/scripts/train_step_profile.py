"""Where the estimator's training step spends its wall time, in f32 and bf16.

    python -m rgbmanip_tpu_torch.scripts.train_step_profile [--device cpu] \\
        [--batch 8] [--reps 10]

One ``EstimatorTrainer`` step at the production recipe
(``scripts/tunnel_watch_estimator.sh:66-70``: ``adapose_cabinet_fast``,
resnet18 at backbone stride 32, 192 px, 1024 points, volume scale 8, 16
bins, nearest warp), from ``checkpoints/estimator_fast_cabinet_aug_r5.ckpt``
on a synthetic batch (``training.synthetic_batch``), for each compute dtype:
the step's median wall time, the card's busy time and idle share
(torch.profiler), the aten ops it dispatches (every level, forward and
backward) and the ops that take most of the host's time, by their own CPU
time. Prints one JSON line. On the CPU (``--device cpu``) it counts the ops
and times nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..config.loader import load_group
from ..models.pose_estimator.adapose import AdaPoseEstimator
from ..models.pose_estimator.training import EstimatorTrainer, synthetic_batch
from .perfutil import card_line, require_card

CKPT = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def profile_step(step, device, top=12):
    """(device busy ms, aten ops dispatched, the ``top`` ops by host self
    time as (name, calls, ms)) of one call of ``step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        step()
        if device.type == "cuda":
            torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    aten = [e for e in events if e.key.startswith("aten::")]
    ops = sum(e.count for e in aten)
    host = sorted(aten, key=lambda e: -e.self_cpu_time_total)[:top]
    return busy, ops, [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in host]


def run(device="cuda", batch=8, reps=10, seed=1):
    dev = torch.device(device)
    if dev.type != "cpu":
        require_card(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": CKPT})
    S, N = int(cfg["img_size"]), int(cfg["n_pts"])
    data = {k: v.to(dev) for k, v in synthetic_batch(
        torch.Generator().manual_seed(seed), batch, S, N, n_depth=int(cfg["n_depth"])).items()}
    out = {}
    for name, dtype in DTYPES.items():
        trainer = EstimatorTrainer(AdaPoseEstimator(cfg, device=dev, dtype=dtype).model)

        def step():
            trainer.step(data)
        for _ in range(2):
            step()
        row = {}
        if dev.type == "cuda":
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            row["wall_ms"] = statistics.median(times)
        busy, ops, host = profile_step(step, dev)
        row["aten_ops"] = ops
        row["top_host_ops"] = [{"op": k, "calls": c, "self_ms": round(ms, 3)}
                               for k, c, ms in host]
        if dev.type == "cuda":
            row["busy_ms"] = busy
            row["idle"] = 1.0 - busy / row["wall_ms"]
        out[name] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    res = run(args.device, args.batch, args.reps)
    card = card_line() if torch.device(args.device).type == "cuda" else None
    print(json.dumps({"card": card, "batch": args.batch, **res}))
    return res


if __name__ == "__main__":
    main()
