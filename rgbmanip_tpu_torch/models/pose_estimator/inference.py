"""Standalone estimator evaluation on stored view pairs (counterpart of
``rgbmanip_tpu/models/pose_estimator/inference.py``; reference
AdaPose/inference.py:20-243).

Evaluates the estimator on saved view pairs (the .npz files that
``train=collect`` writes with ``controller=collect_pose``) and reports the
bbox centre and extent errors against the stored ground truth. The pairs
are estimated ``--batch`` at a time on ``--device`` (the card by default;
``--device cpu`` runs the plain path), K1 twice per batch on the card.

Usage:
    python -m rgbmanip_tpu_torch.models.pose_estimator.inference \\
        --data_root saves/collect --checkpoint saves/estimator.ckpt \\
        [--img_size 224] [--n_pts 1024] [--limit 100] [--batch 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from ... import resolve_device
from ...utils.logger import get_logger

PAIR_KEYS = {"rgb1", "rgb2", "mask1", "mask2", "intrinsic", "extrinsic1", "extrinsic2",
             "gt_bbox"}


def bbox_errors(pred_bbox: np.ndarray, gt_bbox: np.ndarray):
    """Center / extent errors between two 8-corner boxes (world frame)."""
    pc = pred_bbox.mean(0)
    gc = gt_bbox.mean(0)
    center_err = float(np.linalg.norm(pc - gc))
    pe = pred_bbox.max(0) - pred_bbox.min(0)
    ge = gt_bbox.max(0) - gt_bbox.min(0)
    size_err = float(np.abs(pe - ge).mean())
    return center_err, size_err


def estimator_cfg(img_size: int = 224, n_pts: int = 1024, checkpoint: str = "") -> dict:
    """The estimator that ``main`` evaluates: the estimator's default
    architecture (resnet34 at backbone stride 8, volume scale 1, bilinear
    warp), on ``checkpoint`` or, without one, its seeded weights."""
    return {"name": "adapose_v5", "task_name": "eval", "load": bool(checkpoint),
            "checkpoint_path": checkpoint, "img_size": img_size, "use_depth": True,
            "n_pts": n_pts, "direct_regression": True, "real_world": False}


def pair_files(data_root: str, limit: int = 0):
    """The sorted ``.npz`` files under ``data_root``, the first ``limit``."""
    files = sorted(glob.glob(os.path.join(data_root, "**", "*.npz"), recursive=True))
    return files[:limit] if limit else files


def stack_pairs(samples):
    """The estimator's arguments for a batch of loaded pairs: K, then each
    view's colour, mask and extrinsic."""
    return tuple(np.stack([s[k] for s in samples]) for k in
                 ("intrinsic", "rgb1", "mask1", "extrinsic1", "rgb2", "mask2",
                  "extrinsic2"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--img_size", type=int, default=224)
    parser.add_argument("--n_pts", type=int, default=1024)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="where the estimator runs (default: the card)")
    args = parser.parse_args(argv)

    log = get_logger()
    from .adapose import AdaPoseEstimator

    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 throughout, as the parity tests hold the estimator
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    est = AdaPoseEstimator(estimator_cfg(args.img_size, args.n_pts, args.checkpoint),
                           log, device=device)

    files = pair_files(args.data_root, args.limit)
    if not files:
        raise SystemExit(f"no .npz samples under {args.data_root}")

    center_errs, size_errs, n_eval = [], [], 0
    for start in range(0, len(files), args.batch):
        chunk = files[start:start + args.batch]
        samples = [np.load(f) for f in chunk]
        if not PAIR_KEYS <= set(samples[0].files):
            log.warning(f"skipping {len(chunk)} files without view-pair keys")
            continue
        bbox = est.estimate(*stack_pairs(samples))
        for i, s in enumerate(samples):
            ce, se = bbox_errors(bbox[i], s["gt_bbox"])
            center_errs.append(ce)
            size_errs.append(se)
            n_eval += 1
        log.info(f"{n_eval}/{len(files)}: center {np.mean(center_errs):.4f} m  "
                 f"size {np.mean(size_errs):.4f} m")

    result = {"n": n_eval,
              "center_err_mean": float(np.mean(center_errs)),
              "center_err_median": float(np.median(center_errs)),
              "size_err_mean": float(np.mean(size_errs))}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
