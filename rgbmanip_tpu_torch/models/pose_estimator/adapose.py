"""AdaPose estimator on PyTorch (counterpart of
``rgbmanip_tpu/models/pose_estimator/adapose.py``), direct-regression solve.

One call runs on the device for the whole env batch: preprocessing of both
views (kernel K1 on the card) -> ``StereoPoseNetWithDepth`` -> the
vectorised solve over B -> camera -> world. There is no per-env loop.
A view pair whose mask is empty, or whose solve is not finite, returns the
out-of-scene sentinel bbox (+10 offset).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ... import repo_path, resolve_device
from ...ops import geometry as G
from ...ops.preprocess import depth_hypotheses, prepare_model_input
from ...utils.checkpoint import load_checkpoint, write_msgpack
from ...utils.logger import get_logger
from .base_estimator import BasePoseEstimator
from .converter import load_jax_params, load_torch_state_dict, to_jax_params
from .nets.stereo import StereoPoseNetWithDepth, flax_init_

DEFAULT_BBOX = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
], dtype=np.float32) + 10.0

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1: 'the other estimator knobs and solves')"


class AdaPoseEstimator(BasePoseEstimator):
    def __init__(self, cfg: dict, logger=None, device=None, seed: int = 0):
        super().__init__(cfg, logger or get_logger())
        self.device = resolve_device(device)
        self.img_size = int(cfg.get("img_size", 224))
        self.n_pts = int(cfg.get("n_pts", 1024))
        self.n_depth = int(cfg.get("n_depth", 24))
        self.d_min = float(cfg.get("d_min", 0.1))
        self.d_interval = float(cfg.get("d_interval", 0.1))
        self.real_world = bool(cfg.get("real_world", False))
        if not bool(cfg.get("direct_regression", True)):
            raise NotImplementedError(f"direct_regression=False {_NOT_PORTED}")
        if cfg.get("arch", "with_depth") != "with_depth":
            raise NotImplementedError(f"arch={cfg.get('arch')!r} {_NOT_PORTED}")
        if self.n_depth % 8 != 0:
            raise ValueError(f"n_depth must be a multiple of 8 for the "
                             f"cost-regularization U-Net, got {self.n_depth}")
        # the initial weights come from ``seed``, drawn as the JAX package's
        # flax init draws them, so that two estimators of one configuration
        # and seed hold the same network; PyTorch's default init, drawn from
        # the global CPU generator and then overwritten, leaves that
        # generator as it was
        with torch.random.fork_rng(devices=[]):
            net = StereoPoseNetWithDepth(
                backend=cfg.get("backend", "resnet34"),
                backbone_stride=int(cfg.get("backbone_stride", 8)),
                volume_scale=int(cfg.get("volume_scale", 1)),
                warp_mode=cfg.get("warp_mode", "bilinear"),
                stereo_fusion=cfg.get("name", "adapose_v5") != "adapose_baseline",
                volume_channels=int(cfg.get("volume_channels", 0)),
                realworld_pts=self.real_world)
        self.model = flax_init_(net, torch.Generator().manual_seed(seed)).eval()
        if cfg.get("load") and cfg.get("checkpoint_path"):
            self.load(cfg["checkpoint_path"])
        else:
            self.logger.warning(
                "estimator running with RANDOM weights (load=%s, "
                "checkpoint_path=%s): estimates will be garbage",
                cfg.get("load"), cfg.get("checkpoint_path"))
        self.model.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _arch_meta(self) -> dict:
        """Knobs that change behaviour without changing parameter shapes: a
        checkpoint of one backbone stride (or warp, or volume scale) would
        load without complaint into a net of another, so ``load`` compares
        them with the checkpoint's metadata."""
        m = self.model
        return {"backend": m.backend, "backbone_stride": m.backbone_stride,
                "volume_scale": m.volume_scale, "warp_mode": m.warp_mode,
                "n_depth": self.n_depth, "d_min": self.d_min,
                "d_interval": self.d_interval, "img_size": self.img_size,
                "real_world": self.real_world}

    def load(self, path: str):
        """Load a checkpoint into the network, as the JAX package's
        ``AdaPoseEstimator.load`` does:
        - a flax msgpack checkpoint of either package, its architecture
          metadata validated against this estimator's knobs;
        - a reference ``.pth`` state dict (``converter.load_torch_state_dict``),
          which carries no metadata and is restored unvalidated;
        - a path that does not exist: a warning, and the estimator runs on
          its seeded initial weights (the reference's random init)."""
        path = repo_path(path)
        if not os.path.exists(path):
            self.logger.warning(f"checkpoint {path} not found; using random init")
            return
        if path.endswith(".pth"):
            missing, unknown = load_torch_state_dict(self.model, path)
            if unknown:
                self.logger.warning(f"converter: {len(unknown)} unmapped torch keys, "
                                    f"e.g. {unknown[:5]}")
            if missing:
                self.logger.warning(f"checkpoint {path} holds no value for "
                                    f"{len(missing)} parameters, e.g. {missing[:5]}; "
                                    f"they keep their initial values")
            self.logger.warning(f"checkpoint {path} has no architecture "
                                f"metadata; restoring unvalidated")
        else:
            tree, meta = load_checkpoint(path)
            mine = self._arch_meta()
            if meta:
                bad = {k: (meta[k], mine[k]) for k in mine
                       if k in meta and meta[k] != mine[k]}
                if bad:
                    raise ValueError(f"checkpoint {path} was trained with different "
                                     f"architecture knobs (saved vs current): {bad}")
            else:
                self.logger.warning(f"checkpoint {path} has no architecture "
                                    f"metadata; restoring unvalidated")
            load_jax_params(self.model, tree["params"], tree.get("batch_stats", {}))
        self.logger.info(f"loaded estimator checkpoint {path}")

    def save(self, path: str):
        """Write the JAX package's estimator checkpoint (``params``,
        ``batch_stats`` and the ``_arch_meta`` JSON) through a temporary file
        that is synced and renamed, so that the JAX package's
        ``AdaPoseEstimator.load`` reads a head trained here."""
        params, batch_stats = to_jax_params(self.model)
        write_msgpack(path, {"params": params, "batch_stats": batch_stats,
                             "meta": json.dumps(self._arch_meta())})

    @torch.inference_mode()
    def _estimate(self, K, rgb1, mask1, ext1, rgb2, mask2, ext2, rand1, rand2):
        """Tensors on the estimator's device; ``rand1``/``rand2`` are
        torch.Generators or the (B, S*S) uniform draws of each view's point
        sampling. Returns (bbox (B, 8, 3) world, valid (B,), pose dict)."""
        B = rgb1.shape[0]
        S, N = self.img_size, self.n_pts
        c1, choose1, _, newK1, _ = prepare_model_input(rgb1, mask1, K, rand1, S, N)
        c2, choose2, _, newK2, _ = prepare_model_input(rgb2, mask2, K, rand2, S, N)
        ok1 = mask1.reshape(B, -1).any(-1)
        ok2 = mask2.reshape(B, -1).any(-1)

        def full_proj(newK, ext):
            P = torch.eye(4, device=newK.device).repeat(B, 1, 1)
            P[:, :3, :] = newK @ ext[:, :3, :]
            return P

        depth_values = depth_hypotheses(B, self.d_min, self.d_interval,
                                        self.n_depth, device=rgb1.device)
        pred = self.model(c1, choose1, c2, choose2, full_proj(newK1, ext1),
                          full_proj(newK2, ext2), depth_values)
        nocs1 = pred["view1_nocs"].float()
        depth1 = pred["view1_depth"].float()
        R = pred["view1_r"].float()

        # direct-regression solve, vectorised over B
        pts_resized = torch.stack([(choose1 % S).float(),
                                   torch.div(choose1, S, rounding_mode="floor").float()],
                                  dim=-1)
        tt, ts = G.compute_scale_and_translation(depth1, nocs1, pts_resized,
                                                 newK1, R)
        size = 2.0 * nocs1.abs().max(dim=1).values * ts[:, None]
        sRT = torch.eye(4, device=R.device).repeat(B, 1, 1)
        sRT[:, :3, :3] = R
        sRT[:, :3, 3] = tt
        bbox_cam = G.transform_coordinates_3d(G.get_3d_bbox(size), sRT)  # (B, 3, 8)
        ok = torch.isfinite(ts) & torch.isfinite(bbox_cam).reshape(B, -1).all(-1)

        ex_inv = torch.linalg.inv_ex(ext1).inverse    # NaN, not an error, if singular
        bbox_world = (ex_inv[:, :3, :3] @ bbox_cam + ex_inv[:, :3, 3:4]).transpose(1, 2)
        valid = ok1 & ok2 & ok & torch.isfinite(bbox_world).reshape(B, -1).all(-1)
        default = torch.as_tensor(DEFAULT_BBOX, device=bbox_world.device)
        bbox = torch.where(valid[:, None, None], bbox_world, default)
        return bbox, valid, {"R_cam": R, "t_cam": tt, "scale": ts}

    def _call_estimate(self, camera_intrinsic, rgb1, mask1, ext1, rgb2, mask2, ext2):
        def dev(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=self.device)
        return self._estimate(dev(camera_intrinsic), dev(rgb1),
                              dev(mask1, torch.bool), dev(ext1), dev(rgb2),
                              dev(mask2, torch.bool), dev(ext2),
                              self.generator, self.generator)

    def estimate(self, camera_intrinsic, rgb1, mask1, ext1, rgb2, mask2, ext2):
        """Batched estimate -> (B, 8, 3) world bboxes (numpy). Inputs: K
        (B, 3, 3), rgb (B, H, W, 3) in [0, 1], mask (B, H, W) bool, ext
        (B, 4, 4) world -> camera; numpy arrays or tensors."""
        bbox, _, _ = self._call_estimate(camera_intrinsic, rgb1, mask1, ext1,
                                         rgb2, mask2, ext2)
        return bbox.cpu().numpy()

    def estimate_full(self, camera_intrinsic, rgb1, mask1, ext1, rgb2, mask2, ext2):
        """Batched estimate with the solved pose: dict of numpy arrays
        ``bbox`` (B, 8, 3) world, ``valid`` (B,), and the view-1 camera
        frame ``R_cam`` (B, 3, 3), ``t_cam`` (B, 3), ``scale`` (B,)."""
        bbox, valid, pose = self._call_estimate(camera_intrinsic, rgb1, mask1,
                                                ext1, rgb2, mask2, ext2)
        return {"bbox": bbox.cpu().numpy(), "valid": valid.cpu().numpy(),
                **{k: v.cpu().numpy() for k, v in pose.items()}}
