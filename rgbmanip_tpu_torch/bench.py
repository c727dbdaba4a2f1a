"""Headline benchmark of the port: AdaPose pose-estimation throughput on
one card (counterpart of the JAX package's ``bench.py``).

    python -m rgbmanip_tpu_torch.bench [--batch 128 64] [--iters 10] [--reps 3]

It times the whole estimate as one step: preprocessing from raw 640x480
RGB and mask (K1's bf16 entry point, twice per estimate), the network
(``StereoPoseNetWithDepth`` at the fast knobs: resnet18 at backbone stride
32, 192 px, ``volume_scale`` 8, 16 depths at 0.15 m, 1024 points, nearest
warp) in bf16, and the direct-regression solve: what
``AdaPoseEstimator.estimate`` runs in the evaluation. The weights are the
committed ``checkpoints/estimator_fast_cabinet_r2.ckpt``; a missing
checkpoint is an error (random weights would hide a broken load). "Frames"
counts camera views, two per estimate.

The inputs are made on the card as the JAX script makes them on its chip:
RGB from a seeded generator on the device, the mask window
``[180:300, 280:400]``, the JAX script's ``K`` and extrinsics
(``bench_inputs``); the point-sampling draws come from the estimator's own
generator. Each batch (128, then 64) is timed with
``scripts/perfutil.py::bench`` (CUDA events, a fresh copy of the RGB per
rep, ``iters`` calls per rep, the best of ``reps``). A batch that runs out
of device memory is skipped; any other failure ends the run with an error,
and so does a run in which no batch ran. Without a card it raises: it never
times the CPU.

Before the last line it prints the card's name and power limit, then one
JSON row per measured shape (the headline batches in bf16, then f32 at
B=64 and B=8 and bf16 at B=8): ``ms`` per estimate, frames/s, and K1's
launches counted by its wrapper over the row's estimates (``launches``,
``launches_bf16``). The last line keeps the JAX script's format,
``{"metric": "pose_estimation_fps", "value", "unit", "vs_baseline"}``;
``vs_baseline`` is null, since the 10,000 frames/s target of
``BASELINE.json`` was set for a TPU chip and is not this card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import repo_path
from .models.pose_estimator.adapose import AdaPoseEstimator
from .ops import crop_resize as k1
from .scripts import perfutil
from .utils.logger import get_logger

CKPT = "checkpoints/estimator_fast_cabinet_r2.ckpt"
CFG = {"name": "adapose_v5", "task_name": "one_door_cabinet",
       "load": True, "checkpoint_path": CKPT, "img_size": 192,
       "use_depth": True,
       "n_pts": 1024, "direct_regression": True, "real_world": False,
       "backend": "resnet18", "backbone_stride": 32,
       "volume_scale": 8, "n_depth": 16, "d_interval": 0.15,
       "warp_mode": "nearest"}
H, W = 480, 640
K_CAM = ((439.3, 0.0, 320.0), (0.0, 439.3, 240.0), (0.0, 0.0, 1.0))
SEED = 1                                  # the JAX script's PRNGKey(1)
HEADLINE = (128, 64)
# the other shapes of the estimate: (B, dtype)
OTHERS = ((64, torch.float32), (8, torch.float32), (8, torch.bfloat16))


def bench_inputs(B: int, seed, device, rgb=None):
    """(K, rgb1, mask, ext1, rgb2, ext2) on ``device``: two (B, 480, 640, 3)
    RGB batches, uniform in [0, 1) from a generator on the device seeded with
    ``seed`` unless ``rgb`` gives them, the mask window [180:300, 280:400]
    (one mask for both views), and the JAX script's intrinsics and
    extrinsics (view 2 shifted 0.1 m in x)."""
    dev = torch.device(device)
    if rgb is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        rgb = [torch.rand(B, H, W, 3, generator=g, device=dev) for _ in range(2)]
    rgb1, rgb2 = (torch.as_tensor(r, device=dev) for r in rgb)
    mask = torch.zeros(B, H, W, dtype=torch.bool, device=dev)
    mask[:, 180:300, 280:400] = True
    K = torch.tensor(K_CAM, device=dev).expand(B, 3, 3).contiguous()
    ext1 = torch.eye(4, device=dev).repeat(B, 1, 1)
    ext1[:, 2, 3] = 1.0
    ext2 = ext1.clone()
    ext2[:, 0, 3] = 0.1
    return K, rgb1, mask, ext1, rgb2, ext2


def estimator(checkpoint: str, dtype, device) -> AdaPoseEstimator:
    """The bench's estimator on ``checkpoint``, which must exist."""
    path = repo_path(checkpoint)
    if not os.path.exists(path):
        raise FileNotFoundError(f"bench: the trained checkpoint is missing at {path}")
    return AdaPoseEstimator(dict(CFG, checkpoint_path=path), get_logger(),
                            device=device, dtype=dtype)


def estimate_ms(est: AdaPoseEstimator, B: int, iters: int, reps: int) -> dict:
    """Time ``est._estimate`` at batch ``B`` on the card; K1's launch
    counters are set to 0 just before and read just after."""
    K, rgb1, mask, ext1, rgb2, ext2 = bench_inputs(B, SEED, est.device)

    def run(r1, r2, m, k_, e1, e2):
        return est._estimate(k_, r1, m, e1, r2, m, e2, est.generator, est.generator)

    k1.crop_resize_normalize.launches = 0
    k1.crop_resize_normalize.launches_bf16 = 0
    ms = perfutil.bench(run, rgb1, rgb2, mask, K, ext1, ext2, iters=iters, reps=reps)
    return {"B": B, "dtype": str(est.dtype).removeprefix("torch."), "ms": ms,
            "frames_per_s": 2 * B / ms * 1e3,
            "estimates": 1 + iters * reps,          # perfutil.bench's warm-up call
            "launches": k1.crop_resize_normalize.launches,
            "launches_bf16": k1.crop_resize_normalize.launches_bf16}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=list(HEADLINE),
                    help="headline batches, bf16")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--checkpoint", default=CKPT)
    args = ap.parse_args(argv)
    dev = perfutil.require_card("cuda")
    # f32 as the parity tests hold it: cuDNN would run f32 convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    get_logger().setLevel("WARNING")
    print(perfutil.card_line(), flush=True)
    print(f"checkpoint {args.checkpoint}", flush=True)

    est = estimator(args.checkpoint, torch.bfloat16, dev)
    best = None
    for B in args.batch:
        try:
            row = estimate_ms(est, B, args.iters, args.reps)
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).replace("\n", " ")[:300]
            print(f"bench: batch {B} ran out of device memory: {msg}", file=sys.stderr)
            torch.cuda.empty_cache()
            continue
        print(json.dumps(row), flush=True)
        if best is None or row["frames_per_s"] > best["frames_per_s"]:
            best = row
    if best is None:
        sys.exit("bench: no batch ran")

    ests = {torch.bfloat16: est}
    for B, dtype in OTHERS:
        if dtype not in ests:
            ests[dtype] = estimator(args.checkpoint, dtype, dev)
        print(json.dumps(estimate_ms(ests[dtype], B, args.iters, args.reps)), flush=True)

    result = {
        "metric": "pose_estimation_fps",
        "value": round(best["frames_per_s"], 2),
        "unit": f"frames/sec/card (B={best['B']}, {torch.cuda.get_device_name(dev)}, "
                f"bf16, 192px, r18-s32, 16 depth, load=True)",
        "vs_baseline": None,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
