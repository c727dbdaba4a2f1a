"""Evaluate a trained AdaPose estimator against simulator ground truth
(counterpart of ``rgbmanip_tpu/models/pose_estimator/evaluate.py``).

Samples fresh randomized scenes and view pairs (same distribution as
training, ``data.SimViewSampler``), runs the full estimate on ``device``
(the card by default; ``device=cpu`` runs the plain path), and reports
world-frame bbox errors against the gt handle bbox: center distance,
diagonal (size) error and symmetric corner chamfer, and the rotation and
translation errors of the solved pose. Each view's colour stays on the
device as the sampler keeps it (f16), so the estimate copies no frame.

    python -m rgbmanip_tpu_torch.models.pose_estimator.evaluate \\
        task=open_cabinet dataset=cabinet_test task.num_envs=8 \\
        checkpoint=saves/estimator_cabinet.ckpt rounds=12 [device=cpu]

``dtype`` is the estimator's compute dtype, bf16 by default as in the JAX
package (its CLI passes none either).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ... import resolve_device
from ...config.loader import load_config
from ...utils.logger import get_logger
from ...utils.transform import quat_to_matrix

def evaluate(overrides=None, checkpoint: str = "saves/estimator_cabinet.ckpt",
             rounds: int = 12, img_size: int = 224, n_pts: int = 1024,
             est_overrides: dict | None = None, env=None, dtype=torch.bfloat16,
             device=None):
    log = get_logger()
    from ...train import prepare_env
    from .adapose import AdaPoseEstimator
    from .data import SimViewSampler

    device = resolve_device(device)
    cfg = load_config(overrides or [])
    if env is None:
        env = prepare_env(cfg["task"], cfg["dataset"], log=log,
                          seed=cfg.get("seed", 1234))
    est_cfg = {"name": "adapose_v5", "task_name": cfg["task"]["name"],
               "load": bool(checkpoint), "checkpoint_path": checkpoint,
               "img_size": img_size, "use_depth": True, "n_pts": n_pts,
               "direct_regression": True, "real_world": False,
               "volume_scale": 2, "warp_mode": "nearest"}
    est_cfg.update(est_overrides or {})
    est = AdaPoseEstimator(est_cfg, log, device=device, dtype=dtype)
    sampler = SimViewSampler(env, img_size=img_size, n_pts=n_pts,
                             seed=cfg.get("seed", 1234), reuse=1, device=device)

    center_errs, diag_errs, chamfers, n_valid, n_total = [], [], [], 0, 0
    rot_errs, trans_errs = [], []
    for rnd in range(rounds):
        entry = sampler._render_entry()
        if entry is None:
            continue
        img1, img2, frames = entry
        out = est.estimate_full(
            img1["Intrinsic"], img1["Color"], img1["Mask"],
            img1["Extrinsic"], img2["Color"], img2["Mask"],
            img2["Extrinsic"])
        bbox = out["bbox"]                                # (B, 8, 3) world
        gt = np.asarray(env.handle_bbox())                # (B, 8, 3) world
        for e in range(env.num_envs):
            n_total += 1
            pred = bbox[e]
            if not np.isfinite(pred).all() or np.abs(pred).max() > 8.0:
                continue  # sentinel / failure bbox
            n_valid += 1
            pc, gc = pred.mean(0), gt[e].mean(0)
            center_errs.append(float(np.linalg.norm(pc - gc)))
            pd = np.linalg.norm(pred.max(0) - pred.min(0))
            gd = np.linalg.norm(gt[e].max(0) - gt[e].min(0))
            diag_errs.append(float(abs(pd - gd)))
            d = np.linalg.norm(pred[:, None] - gt[e][None], axis=-1)
            chamfers.append(float((d.min(0).mean() + d.min(1).mean()) / 2))
            # explicit-pose metrics (reference network_v5.py:480-521 predicts
            # R/t/s): the gt NOCS->camera pose from the part frame captured
            # at render time (data.py _labels_for_view), the predicted pose
            # from the solve (estimate_full)
            part, center, _ext, _diag = frames[e]
            E = img1["Extrinsic"][e]
            R_lab = E[:3, :3] @ quat_to_matrix(part.q)
            c_world = part.transform_points(center[None])[0]
            t_lab = E[:3, :3] @ c_world + E[:3, 3]
            Rrel = out["R_cam"][e].T @ R_lab
            cosang = np.clip((np.trace(Rrel) - 1.0) / 2.0, -1.0, 1.0)
            rot_errs.append(float(np.degrees(np.arccos(cosang))))
            trans_errs.append(float(np.linalg.norm(out["t_cam"][e] - t_lab)))
        if (rnd + 1) % 4 == 0 and center_errs:
            log.info(f"round {rnd + 1}/{rounds}: center "
                     f"{np.mean(center_errs):.4f} m diag "
                     f"{np.mean(diag_errs):.4f} m chamfer "
                     f"{np.mean(chamfers):.4f} m rot "
                     f"{np.mean(rot_errs):.2f} deg trans "
                     f"{np.mean(trans_errs):.4f} m "
                     f"valid {n_valid}/{n_total}")
    stats = {
        "center_err_m": float(np.mean(center_errs)) if center_errs else float("nan"),
        "center_err_med_m": float(np.median(center_errs)) if center_errs else float("nan"),
        "diag_err_m": float(np.mean(diag_errs)) if diag_errs else float("nan"),
        "chamfer_m": float(np.mean(chamfers)) if chamfers else float("nan"),
        "rot_err_deg": float(np.mean(rot_errs)) if rot_errs else float("nan"),
        "rot_err_med_deg": float(np.median(rot_errs)) if rot_errs else float("nan"),
        "trans_err_m": float(np.mean(trans_errs)) if trans_errs else float("nan"),
        "trans_err_med_m": float(np.median(trans_errs)) if trans_errs else float("nan"),
        "valid_frac": n_valid / max(1, n_total),
    }
    log.info("FINAL " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    return stats


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    local = ("checkpoint", "rounds", "img_size", "n_pts", "volume_scale",
             "warp_mode", "backend", "n_depth", "volume_channels",
             "backbone_stride", "d_interval", "d_min", "device")
    overrides = [a for a in argv if "=" in a and a.split("=")[0] not in local]
    # architecture knobs must match the checkpoint being evaluated (same
    # parsing as train_estimator's CLI)
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
    return evaluate(overrides=overrides,
                    checkpoint=kv.get("checkpoint", "saves/estimator_cabinet.ckpt"),
                    rounds=int(kv.get("rounds", 12)),
                    img_size=int(kv.get("img_size", 224)),
                    n_pts=int(kv.get("n_pts", 1024)),
                    est_overrides=est_overrides, device=device)


if __name__ == "__main__":
    main()
