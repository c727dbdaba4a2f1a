"""AdaPose estimator on PyTorch (counterpart of
``rgbmanip_tpu/models/pose_estimator/adapose.py``).

One call runs on the device for the whole env batch: preprocessing of both
views (kernel K1 on the card) -> the network -> the vectorised solve over
B -> camera -> world. There is no per-env loop. A view pair whose mask is
empty, or whose solve is not finite, returns the out-of-scene sentinel bbox
(+10 offset).

The three solves, chosen by the configuration as in the JAX package:
``direct_regression`` (the network's rotation, scale and translation from
the predicted depth), ``use_depth`` (the predicted depth back-projected,
RANSAC-Umeyama), else NOCS-match triangulation for the scale and DLT PnP.
``arch="v1"`` is the original network, which pairs with the last.
``make_estimator`` maps the reference's interface generations onto them.

``dtype`` is the JAX package's compute dtype: the network runs in it (f32
parameters, ``nets/layers.py``), the crop comes out of K1 in it (its bf16
entry point rounds once to nearest-even, the JAX package's
``crop.astype(bf16)``), and the network's outputs are cast to f32 before
the solve. Checkpoints do not record it: a head loads in either dtype.
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
from ...utils.logger import count, get_logger, span
from .base_estimator import BasePoseEstimator
from .converter import load_jax_params, load_torch_state_dict, to_jax_params
from .nets.stereo import StereoPoseNetV1, StereoPoseNetWithDepth, flax_init_

DEFAULT_BBOX = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
], dtype=np.float32) + 10.0


class AdaPoseEstimator(BasePoseEstimator):
    def __init__(self, cfg: dict, logger=None, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__(cfg, logger or get_logger())
        self.device = resolve_device(device)
        self.dtype = dtype
        self.img_size = int(cfg.get("img_size", 224))
        self.n_pts = int(cfg.get("n_pts", 1024))
        self.direct_regression = bool(cfg.get("direct_regression", True))
        self.use_depth = bool(cfg.get("use_depth", True))
        self.n_depth = int(cfg.get("n_depth", 24))
        if self.use_depth and self.n_depth % 8 != 0:
            raise ValueError(f"n_depth must be a multiple of 8 for the "
                             f"cost-regularization U-Net, got {self.n_depth}")
        self.d_min = float(cfg.get("d_min", 0.1))
        self.d_interval = float(cfg.get("d_interval", 0.1))
        self.real_world = bool(cfg.get("real_world", False))
        self.arch = cfg.get("arch", "with_depth")
        # the initial weights come from ``seed``, drawn as the JAX package's
        # flax init draws them, so that two estimators of one configuration
        # and seed hold the same network; PyTorch's default init, drawn from
        # the global CPU generator and then overwritten, leaves that
        # generator as it was
        with torch.random.fork_rng(devices=[]):
            if self.arch == "v1":
                if self.use_depth or self.direct_regression or self.real_world:
                    raise ValueError(
                        "arch='v1' has no depth head: requires use_depth=False, "
                        "direct_regression=False, real_world=False "
                        "(triangulation+PnP solve, reference interface.py)")
                net = StereoPoseNetV1(backend=cfg.get("backend", "resnet34"),
                                      n_depth=self.n_depth, dtype=dtype)
            elif self.arch != "with_depth":
                raise ValueError(f"unknown estimator arch {self.arch!r}")
            else:
                # reg_impl picks the JAX package's execution plan of the
                # 3-D U-Net (banded 2-D or 3-D convolutions, one math and
                # one parameter tree); the port runs it as Conv3d
                net = StereoPoseNetWithDepth(
                    backend=cfg.get("backend", "resnet34"),
                    backbone_stride=int(cfg.get("backbone_stride", 8)),
                    volume_scale=int(cfg.get("volume_scale", 1)),
                    warp_mode=cfg.get("warp_mode", "bilinear"),
                    regress_pose=self.direct_regression,
                    stereo_fusion=cfg.get("name", "adapose_v5") != "adapose_baseline",
                    volume_channels=int(cfg.get("volume_channels", 0)),
                    realworld_pts=self.real_world, dtype=dtype)
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
        if self.arch == "v1":
            return {"arch": "v1", "backend": m.backend, "img_size": self.img_size,
                    "n_depth": self.n_depth, "d_min": self.d_min,
                    "d_interval": self.d_interval}
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

    def _solve(self, pred, choose1, newK1, pts2d1, pts2d2, K, ext1, ext2, rand3):
        """The configuration's solve over the batch -> (bbox (B, 3, 8) in the
        view-1 camera frame, ok (B,), R (B, 3, 3), t (B, 3), scale (B,))."""
        B = choose1.shape[0]
        S = self.img_size
        nocs1 = pred["view1_nocs"].float()
        eye4 = torch.eye(4, device=nocs1.device).repeat(B, 1, 1)
        pts_resized = torch.stack([(choose1 % S).float(),
                                   torch.div(choose1, S, rounding_mode="floor").float()],
                                  dim=-1)
        if self.direct_regression:
            R = pred["view1_r"].float()
            tt, ts = G.compute_scale_and_translation(pred["view1_depth"].float(), nocs1,
                                                     pts_resized, newK1, R)
            ok = torch.isfinite(ts)
        elif self.use_depth:
            cam_pts = G.backproject(pred["view1_depth"].float(), pts_resized, newK1)
            if isinstance(rand3, torch.Generator):
                rand3 = G.ransac_hypotheses(rand3, B, nocs1.shape[1], device=nocs1.device)
            ts, R, tt, ok = G.ransac_umeyama(nocs1, cam_pts, rand3.to(nocs1.device))
        else:
            P1, P2 = eye4.clone(), eye4.clone()
            P1[:, :3] = K @ ext1[:, :3]
            P2[:, :3] = K @ ext2[:, :3]
            with span("solve/match", triangulations=B * nocs1.shape[1]):
                ts, ok = G.depth_from_nocs_matches(pts2d1, nocs1, P1, ext1, pts2d2,
                                                   pred["view2_nocs"].float(), P2, ext2, K)
            with span("solve/pnp"):
                R, tt = G.pnp_dlt(nocs1 * ts[:, None, None], pts2d1, K)
        size = 2.0 * nocs1.abs().max(dim=1).values * ts[:, None]
        sRT = eye4
        sRT[:, :3, :3] = R
        sRT[:, :3, 3] = tt
        bbox_cam = G.transform_coordinates_3d(G.get_3d_bbox(size), sRT)  # (B, 3, 8)
        ok = ok & torch.isfinite(bbox_cam).reshape(B, -1).all(-1)
        return bbox_cam, ok, R, tt, ts

    @torch.inference_mode()
    def _estimate(self, K, rgb1, mask1, ext1, rgb2, mask2, ext2, rand1, rand2,
                  rand3=None):
        """Tensors on the estimator's device; ``rand1``/``rand2`` are
        torch.Generators or the (B, S*S) uniform draws of each view's point
        sampling, ``rand3`` (the RANSAC solve's) a torch.Generator or the
        (B, 128, 5) hypotheses' point indices, the estimator's own generator
        by default. Returns (bbox (B, 8, 3) world, valid (B,), pose dict)."""
        B = rgb1.shape[0]
        S, N = self.img_size, self.n_pts

        def full_proj(newK, ext):
            P = torch.eye(4, device=newK.device).repeat(B, 1, 1)
            P[:, :3, :] = newK @ ext[:, :3, :]
            return P

        with span("adapose/preprocess"):
            c1, choose1, pts2d1, newK1, _ = prepare_model_input(rgb1, mask1, K, rand1, S, N,
                                                                out_dtype=self.dtype)
            c2, choose2, pts2d2, newK2, _ = prepare_model_input(rgb2, mask2, K, rand2, S, N,
                                                                out_dtype=self.dtype)
            ok1 = mask1.reshape(B, -1).any(-1)
            ok2 = mask2.reshape(B, -1).any(-1)
            proj1, proj2 = full_proj(newK1, ext1), full_proj(newK2, ext2)
            depth_values = depth_hypotheses(B, self.d_min, self.d_interval,
                                            self.n_depth, device=rgb1.device)
        # the real-world pose branch takes the points' original-frame pixels
        extra = (pts2d1, pts2d2) if self.real_world else ()
        pred = self.model(c1, choose1, c2, choose2, proj1, proj2, depth_values, *extra)
        with span("adapose/solve"):
            bbox_cam, ok, R, tt, ts = self._solve(pred, choose1, newK1, pts2d1, pts2d2, K,
                                                  ext1, ext2,
                                                  self.generator if rand3 is None else rand3)
            ex_inv = torch.linalg.inv_ex(ext1).inverse    # NaN, not an error, if singular
            bbox_world = (ex_inv[:, :3, :3] @ bbox_cam + ex_inv[:, :3, 3:4]).transpose(1, 2)
            valid = ok1 & ok2 & ok & torch.isfinite(bbox_world).reshape(B, -1).all(-1)
            default = torch.as_tensor(DEFAULT_BBOX, device=bbox_world.device)
            bbox = torch.where(valid[:, None, None], bbox_world, default)
        return bbox, valid, {"R_cam": R, "t_cam": tt, "scale": ts}

    def append_picture(self, *args, **kwargs):
        """Multi-view accumulation is handled by the caller's view queue
        (``ControlInterface``); kept for API parity."""
        return None

    def _call_estimate(self, camera_intrinsic, rgb1, mask1, ext1, rgb2, mask2, ext2):
        def dev(x, dtype=torch.float32):
            y = torch.as_tensor(x, dtype=dtype, device=self.device)
            if y.is_cuda and not (torch.is_tensor(x) and x.is_cuda):
                count(h2d_bytes=y.nbytes)
            return y
        return self._estimate(dev(camera_intrinsic), dev(rgb1),
                              dev(mask1, torch.bool), dev(ext1), dev(rgb2),
                              dev(mask2, torch.bool), dev(ext2),
                              self.generator, self.generator)

    def estimate(self, camera_intrinsic, rgb1, mask1, ext1, rgb2, mask2, ext2):
        """Batched estimate -> (B, 8, 3) world bboxes (numpy). Inputs: K
        (B, 3, 3), rgb (B, H, W, 3) in [0, 1], mask (B, H, W) bool, ext
        (B, 4, 4) world -> camera; numpy arrays or tensors."""
        with span("adapose/estimate", pairs=len(rgb1), h2d_bytes=0):
            bbox, _, _ = self._call_estimate(camera_intrinsic, rgb1, mask1, ext1,
                                             rgb2, mask2, ext2)
            with span("adapose/readback", d2h_bytes=bbox.nbytes):
                return bbox.cpu().numpy()

    def estimate_full(self, camera_intrinsic, rgb1, mask1, ext1, rgb2, mask2, ext2):
        """Batched estimate with the solved pose: dict of numpy arrays
        ``bbox`` (B, 8, 3) world, ``valid`` (B,), and the view-1 camera
        frame ``R_cam`` (B, 3, 3), ``t_cam`` (B, 3), ``scale`` (B,)."""
        with span("adapose/estimate", pairs=len(rgb1), h2d_bytes=0):
            bbox, valid, pose = self._call_estimate(camera_intrinsic, rgb1, mask1,
                                                    ext1, rgb2, mask2, ext2)
            out = {"bbox": bbox, "valid": valid, **pose}
            with span("adapose/readback", d2h_bytes=sum(v.nbytes for v in out.values())):
                return {k: v.cpu().numpy() for k, v in out.items()}


def make_estimator(version: str, cfg: dict, logger=None, **kw) -> AdaPoseEstimator:
    """The reference's interface generations (AdaPose/interface*.py) as
    configurations of the one estimator, as the JAX package's
    ``make_estimator`` maps them:

      v1/v2: the original network (``arch="v1"``) with NOCS-match
             triangulation + PnP
      v3:    predicted-depth back-projection + RANSAC-Umeyama
      v4/v5: direct regression heads
      baseline: v5 without stereo fusion (``adapose_baseline``)
      realworld: v5 with the real-world pose branch over (px, py, depth)

    ``kw`` goes to ``AdaPoseEstimator`` (device, seed, dtype)."""
    cfg = dict(cfg)
    v = version.lower()
    if v in ("v1", "v2"):
        cfg.update(use_depth=False, direct_regression=False)
        cfg.setdefault("arch", "v1")
    elif v == "v3":
        cfg.update(use_depth=True, direct_regression=False)
    elif v in ("v4", "v5"):
        cfg.update(use_depth=True, direct_regression=True)
    elif v == "baseline":
        cfg.update(name="adapose_baseline")
    elif v == "realworld":
        cfg.update(use_depth=True, direct_regression=True, real_world=True)
    return AdaPoseEstimator(cfg, logger, **kw)
