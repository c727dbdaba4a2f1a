"""Estimator training data straight from the simulator (counterpart of
``rgbmanip_tpu/models/pose_estimator/data.py``).

For each sampled view pair the labels are exact, per point:

  - NOCS: part-local coordinates normalised by the part-bbox diagonal
  - depth: distance along the camera's forward axis (the renderer's Depth)
  - pose: rotation and translation of the NOCS frame in camera-cv
    coordinates and the NOCS extents (for the direct-regression heads)

The camera poses, the replay buffer's choices and the view augmentation come
from ``np.random.default_rng(seed)`` in the JAX package's order of calls, so
the two packages render the same views from one seed. The point-sampling
draws come from the sampler's ``torch.Generator`` on the device (``_draws``;
a test can supply the JAX package's). Preprocessing runs on the device (K1
on the card). The replay buffer keeps each view's colour (f16, as the JAX
package stores it) and mask on the device, so a replayed batch copies only
its labels and projections; the label maps (Position, Depth) stay on the
host, where the labels are read at the sampled points in f64 as in the JAX
package. ``h2d_bytes`` counts what the sampler copies to the device;
``timer`` splits its time into ``render`` (a fresh view pair: reset,
teleports, renders) and ``prepare`` (preprocessing and labels).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ... import resolve_device
from ...ops.preprocess import depth_hypotheses, prepare_model_input
from ...utils.logger import PhaseTimer
from ...utils.transform import Pose, lookat_quat, quat_to_matrix


class SimViewSampler:
    """Samples labelled view pairs from a running VecManipulationEnv."""

    def __init__(self, env, img_size: int = 224, n_pts: int = 1024, seed: int = 0,
                 pose_min=(-0.3, -0.3, 0.4), pose_max=(0.3, 0.3, 1.0),
                 reuse: int = 8, buffer_size: int = 32,
                 d_min: float = 0.1, d_interval: float = 0.1, n_depth: int = 24,
                 view_aug: str = "box", device=None):
        self.env = env
        self.img_size = img_size
        self.n_pts = n_pts
        # "box": independent positions in the policy box, exact handle
        # lookat (the collection distribution). "wide": view augmentation
        # toward the deployed RL scheduler's distribution: correlated
        # consecutive-view pairs with log-uniform baselines, off-centre
        # handle framing, a close-in position bias, and 10% duplicated
        # quasi-monocular pairs.
        self.view_aug = str(view_aug)
        self._pair_anchor = None
        # the depth hypotheses must be the trained estimator's
        self.d_min, self.d_interval, self.n_depth = d_min, d_interval, n_depth
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.pose_min = np.asarray(pose_min)
        self.pose_max = np.asarray(pose_max)
        # render replay: each rendered view pair is reused ``reuse`` times
        # with fresh point sampling (new choose indices and labels); only
        # one batch in ``reuse`` pays the render. reuse=1 disables it.
        self.reuse = max(1, int(reuse))
        self.buffer_size = int(buffer_size)
        self._buffer: list = []
        self._calls = 0
        self.h2d_bytes = 0
        self.timer = PhaseTimer()

    def _to_device(self, x, dtype=None):
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        self.h2d_bytes += t.numel() * t.element_size()
        return t.to(self.device)

    def _random_views(self):
        """Teleport the wrist camera toward the handle; return the render."""
        n = self.env.num_envs
        gt = self.env.handle_bbox()
        target = (gt[:, 0] + gt[:, 6]) / 2
        robot_root = self.env.robot_pose()[:, :3]
        pos = self.rng.uniform(self.pose_min, self.pose_max, size=(n, 3))
        look_target = target - robot_root
        if self.view_aug == "wide":
            close = self.rng.random(n) < 0.35
            # close-in bias: the policy's late views sit at the near-object
            # edge of its box
            pos[close, 0] = self.rng.uniform(
                (self.pose_min[0] + self.pose_max[0]) / 2, self.pose_max[0],
                size=int(close.sum()))
            if self._pair_anchor is not None:
                corr = self.rng.random(n) < 0.5
                # correlated pair: |delta| log-uniform in 3-50 cm around the
                # previous view's position
                mag = np.exp(self.rng.uniform(np.log(0.03), np.log(0.5), size=(n, 1)))
                d = self.rng.normal(size=(n, 3))
                d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-9
                cand = np.clip(self._pair_anchor + d * mag, self.pose_min, self.pose_max)
                pos[corr] = cand[corr]
            # off-centre framing: the policy's lookat is an action
            look_target = look_target + self.rng.normal(0.0, 0.08, (n, 3))
            self._pair_anchor = pos.copy()
        q = lookat_quat(look_target - pos)
        self.env.cam_move_to(np.concatenate([pos, q], -1), time=2, wait=0.5,
                             planner="path", robot_frame=True, skip_move=True,
                             no_collision_with_front=False)
        return self.env.get_image()["camera0"]

    def _part_frames(self):
        """Per-env (part pose, local centre, local extents, diagonal)."""
        out = []
        for e in range(self.env.num_envs):
            mn, mx = self.env.pool.part_aabb(e, self.env.obj_art[e],
                                             self.env.part_link[e], 129)
            link7 = self.env.pool.link_pose(e, self.env.obj_art[e], self.env.part_link[e])
            center = (mn + mx) / 2
            ext = mx - mn
            out.append((Pose(link7[:3], link7[3:]), center, ext,
                        float(np.linalg.norm(ext)) + 1e-9))
        return out

    def _labels_for_view(self, img, pts2d, frames=None):
        """Per-point NOCS/depth labels and per-env pose labels for one view.
        ``frames`` are the part frames captured at render time (the env may
        have been re-randomised since, when a buffered view is replayed)."""
        if frames is None:
            frames = self._part_frames()
        n, N = pts2d.shape[:2]
        H, W = img["Depth"].shape[1:3]
        px = np.clip(np.round(pts2d[..., 0]).astype(int), 0, W - 1)
        py = np.clip(np.round(pts2d[..., 1]).astype(int), 0, H - 1)
        nocs = np.zeros((n, N, 3), np.float32)
        depth = np.zeros((n, N), np.float32)
        R_lab = np.zeros((n, 3, 3), np.float32)
        t_lab = np.zeros((n, 3), np.float32)
        s_lab = np.zeros((n, 3), np.float32)
        for e in range(n):
            world = img["Position"][e][py[e], px[e]]          # (N, 3)
            depth[e] = img["Depth"][e][py[e], px[e]]
            part, center, ext, diag = frames[e]
            local = part.inv().transform_points(world.astype(np.float64))
            # clip: mask-resize aliasing can select pixels just off the part
            nocs[e] = np.clip((local - center) / diag, -1.0, 1.0).astype(np.float32)
            E = img["Extrinsic"][e]
            Rp = quat_to_matrix(part.q)
            R_lab[e] = (E[:3, :3] @ Rp).astype(np.float32)
            c_world = part.transform_points(center[None])[0]
            t_lab[e] = (E[:3, :3] @ c_world + E[:3, 3]).astype(np.float32)
            s_lab[e] = (ext / diag).astype(np.float32)
        return nocs, depth, R_lab, t_lab, s_lab

    _HOST = ("Depth", "Position", "Intrinsic", "Extrinsic")

    def _slim(self, im):
        """A buffered view: the colour (f16, as the JAX package stores it)
        and the mask on the device, the label maps and cameras on the
        host."""
        out = {k: im[k] for k in self._HOST}
        out["Color"] = self._to_device(np.asarray(im["Color"], np.float16))
        out["Mask"] = self._to_device(im["Mask"], torch.bool)
        return out

    def _entry(self, img1, img2):
        if img1["Mask"].sum() == 0 or img2["Mask"].sum() == 0:
            return None
        frames = self._part_frames()
        s1 = self._slim(img1)
        return (s1, s1 if img2 is img1 else self._slim(img2), frames)

    def _render_entry(self) -> Optional[tuple]:
        """Render one fresh view pair (resets the envs) -> buffered entry."""
        self.env.reset()
        self._pair_anchor = None  # view 1 always samples fresh
        img1 = self._random_views()
        if self.view_aug == "wide" and self.rng.random() < 0.1:
            # duplicated quasi-monocular pair: deployment estimates from a
            # lone valid view duplicated into both stereo slots
            img2 = img1
        else:
            img2 = self._random_views()
        return self._entry(img1, img2)

    def _draws(self, B: int):
        """The point-sampling draws of the two views: the generator itself
        (``prepare_model_input`` draws (B, S*S) uniforms from it)."""
        return self.generator, self.generator

    def sample_batch(self) -> Optional[Dict]:
        """One labelled training batch of device tensors. Renders a fresh
        view pair every ``reuse``-th call; otherwise replays a buffered
        render with fresh point sampling and labels."""
        self._calls += 1
        fresh = (self.reuse == 1 or not self._buffer
                 or (self._calls % self.reuse) == 1)
        if fresh:
            with self.timer.phase("render"):
                entry = self._render_entry()
            if entry is None:
                return None
            self._buffer.append(entry)
            if len(self._buffer) > self.buffer_size:
                self._buffer.pop(int(self.rng.integers(len(self._buffer) - 1)))
        else:
            entry = self._buffer[int(self.rng.integers(len(self._buffer)))]
        with self.timer.phase("prepare"):
            return self._prepare(entry)

    def _prepare(self, entry) -> Optional[Dict]:
        img1, img2, frames = entry
        B = self.env.num_envs
        rand1, rand2 = self._draws(B)
        K = self._to_device(img1["Intrinsic"], torch.float32)
        # the JAX package's sampler prepares every batch on its CPU backend,
        # where the crop clamps at the frame border: K1's clamping mode
        c1, choose1, pts2d1, newK1, ok1 = prepare_model_input(
            img1["Color"].float(), img1["Mask"], K, rand1, self.img_size, self.n_pts,
            border="clamp")
        c2, choose2, pts2d2, newK2, ok2 = prepare_model_input(
            img2["Color"].float(), img2["Mask"], K, rand2, self.img_size, self.n_pts,
            border="clamp")
        ok = (ok1 & ok2).cpu().numpy()
        if not ok.any():
            return None
        nocs1, depth1, r1, t1, s1 = self._labels_for_view(img1, pts2d1.cpu().numpy(), frames)
        nocs2, depth2, r2, t2, s2 = self._labels_for_view(img2, pts2d2.cpu().numpy(), frames)

        def proj(newK, ext):
            P = np.tile(np.eye(4, dtype=np.float32), (len(ext), 1, 1))
            P[:, :3, :] = np.einsum("bij,bjk->bik", newK.cpu().numpy(),
                                    ext[:, :3, :].astype(np.float32))
            return self._to_device(P)

        dev = self._to_device
        return {
            "img1": c1, "img2": c2, "choose1": choose1, "choose2": choose2,
            "P1": proj(newK1, img1["Extrinsic"]), "P2": proj(newK2, img2["Extrinsic"]),
            "depth_values": depth_hypotheses(B, self.d_min, self.d_interval,
                                             self.n_depth, device=self.device),
            "nocs1": dev(nocs1), "nocs2": dev(nocs2),
            "depth1": dev(depth1), "depth2": dev(depth2),
            "r1": dev(r1), "r2": dev(r2), "t1": dev(t1), "t2": dev(t2),
            "s1": dev(s1), "s2": dev(s2), "valid": dev(ok),
        }


class PolicyViewSampler(SimViewSampler):
    """DAgger-style view source: train on the views a trained RL camera
    scheduler visits instead of the collection box. Each fresh render runs
    one policy episode (teleported camera moves, no manipulation) and yields
    the policy's last two views, the pair ``ControlInterface.get_estimation``
    feeds the estimator at deployment; ``mix`` keeps a fraction of
    collection-box pairs."""

    def __init__(self, env, cfg, policy_ckpt: str, mix: float = 0.5,
                 noise: float = 0.15, pair_mode: str = "last", **kw):
        super().__init__(env, **kw)
        import copy
        from ..controller.rl_pose import ControlInterface
        from .groundtruth_estimator import GroundTruthPoseEstimator
        from ...algo.ppo import PPO

        ctrl_cfg = copy.deepcopy(cfg["controller"])
        # view sampling must never trigger manipulation mid-episode; the
        # reward block is read from the group-level dict
        ctrl_cfg.setdefault("reward", {})["success_coef"] = 0.0
        gt_est = GroundTruthPoseEstimator(env, {}, None)
        iface_cfg = {"controller": ctrl_cfg, "task": cfg.get("task", {})}
        self._iface = ControlInterface(env, gt_est, None, iface_cfg)
        self._ppo = PPO(self._iface, ctrl_cfg, seed=int(kw.get("seed", 0)),
                        device=self.device)
        self._ppo.load(policy_ckpt)
        self.mix = float(mix)
        self.noise = float(noise)
        self.pair_mode = str(pair_mode)

    def _grab(self):
        return self.env.get_image()["camera0"]

    def _render_entry(self):
        if self.rng.random() < self.mix:
            return super()._render_entry()
        iface = self._iface
        obs = iface.reset()  # env.reset + canonical initial view
        shots = [self._grab()]
        for _ in range(iface.max_steps - 1):
            act = self._ppo.act_inference(obs)
            if self.noise > 0:
                act = act + self.rng.normal(0.0, self.noise, act.shape)
            obs, _r, done, _info = iface.step(act, eval=False)
            shots.append(self._grab())
            if np.asarray(done).all():
                break
        if self.pair_mode == "any" and self.rng.random() < 0.1:
            # zero-baseline duplicate pair (10%), as deployment estimates
            # from a duplicated view when only one policy view frames the part
            j = len(shots) - 1 if len(shots) < 2 else \
                int(self.rng.integers(1, len(shots)))
            img1 = img2 = shots[j]
        elif self.pair_mode == "any" and len(shots) > 2:
            # any consecutive pair the policy visits, weighted toward late ones
            n_pairs = len(shots) - 1
            w = np.arange(1, n_pairs + 1, dtype=np.float64)
            j = int(self.rng.choice(n_pairs, p=w / w.sum()))
            img1, img2 = shots[j], shots[j + 1]
        else:
            img1, img2 = shots[-2], shots[-1]
        return self._entry(img1, img2)
