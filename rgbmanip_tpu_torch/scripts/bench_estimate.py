"""Throughput of the whole estimate (preprocessing from raw 640x480,
network, pose solve) for the parity and fast estimator configurations, in
bf16 on seeded weights (counterpart of the JAX package's
``scripts/bench_estimate.py``).

    python -m rgbmanip_tpu_torch.scripts.bench_estimate [both|fast|parity]
        [--batch B ...]

``PARITY`` is the reference-shaped configuration (224 px at the
estimator's default backbone, resnet34, stride 8, ``volume_scale`` 2);
``FAST`` is 112 px, resnet18, ``volume_channels`` 8 and 512 points. Both
run with ``load: False``, so the weights are the estimator's seeded ones,
drawn as flax draws them. ``FAST`` runs at B = 16, 32 and 64, ``PARITY`` at
16 (``--batch`` replaces either list). The inputs come from
``np.random.default_rng(0)`` as in the JAX script, around the views of
``rgbmanip_tpu_torch.bench.bench_inputs``. Each batch is timed as
``rgbmanip_tpu_torch.bench`` times its estimate (``perfutil.bench``: CUDA
events, a fresh copy of the first view's RGB per rep), at the JAX script's
8 calls per rep and 2 reps, and prints one line,
``<tag> B=<B>: <ms> ms -> <fps> fps`` (two frames per estimate). A batch
that runs out of device memory prints ``failed`` and ends that
configuration's list; any other failure raises. The last line is one JSON
object of the times, ``{"fast": {"<B>": ms, ...}, "parity": {...}}``.
Without a card it raises.

The JAX script unpacks two values from ``_estimate``, which returns three
(bbox, valid, pose), so each of its batches raises ``ValueError``, which
its ``except`` prints as "failed": it times nothing. This script times
what it meant to time.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import H, W, bench_inputs
from ..models.pose_estimator.adapose import AdaPoseEstimator
from ..utils.logger import get_logger
from . import perfutil

PARITY = {"name": "adapose_v5", "task_name": "one_door_cabinet", "load": False,
          "checkpoint_path": "", "img_size": 224, "use_depth": True,
          "n_pts": 1024, "direct_regression": True, "real_world": False,
          "volume_scale": 2, "warp_mode": "nearest"}

FAST = dict(PARITY, img_size=112, backend="resnet18", n_depth=16,
            d_interval=0.15, volume_scale=2, volume_channels=8, n_pts=512)


ITERS, REPS = 8, 2                      # the JAX script's scan_bench arguments


def estimate_inputs(rng: np.random.Generator, B: int, device):
    """``bench_inputs``' views on ``device`` with the RGB drawn from ``rng``
    (view 1, then view 2), as the JAX script draws them."""
    rgb = [rng.uniform(size=(B, H, W, 3)).astype(np.float32) for _ in range(2)]
    return bench_inputs(B, None, device, rgb=rgb)


def bench(cfg, tag, Bs=(16, 32, 64)):
    """Print one line per batch of ``Bs`` on the card; returns {B: ms}."""
    dev = torch.device("cuda")
    log = get_logger()
    log.setLevel("WARNING")
    rng = np.random.default_rng(0)
    est = AdaPoseEstimator(cfg, log, device=dev, dtype=torch.bfloat16)
    out = {}
    for B in Bs:
        K, rgb1, mask, ext, rgb2, ext2 = estimate_inputs(rng, B, dev)

        def run(r1, r2):
            return est._estimate(K, r1, mask, ext, r2, mask, ext2, est.generator,
                                 est.generator)

        try:
            ms = perfutil.bench(run, rgb1, rgb2, iters=ITERS, reps=REPS)
        except torch.cuda.OutOfMemoryError as e:
            print(f"{tag} B={B}: failed {type(e).__name__}: {e}", flush=True)
            torch.cuda.empty_cache()
            break
        out[B] = ms
        print(f"{tag} B={B:3d}: {ms:8.2f} ms -> {2*B/ms*1e3:7.0f} fps", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="both", choices=("both", "fast", "parity"))
    ap.add_argument("--batch", type=int, nargs="+", help="batches (default: 16 32 64 "
                    "for fast, 16 for parity)")
    args = ap.parse_args(argv)
    perfutil.require_card("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(perfutil.card_line(), flush=True)
    out = {}
    if args.which in ("both", "fast"):
        out["fast"] = bench(FAST, "fast  ", tuple(args.batch or (16, 32, 64)))
    if args.which in ("both", "parity"):
        out["parity"] = bench(PARITY, "parity", tuple(args.batch or (16,)))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
