"""Data-collection controller (reference models/controller/collection.py:29-247).

Rejection-samples random camera poses around the gt handle center until the
handle mask is fully inside the frame, for two views per episode. target
"pose_estimator" saves cam poses + object configs; otherwise saves full obs +
a downsampled point cloud for external baseline methods.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .base_controller import BaseController
from ...utils.transform import lookat_quat


class CollectionController(BaseController):
    MAX_TRIES = 20

    def __init__(self, env, pose_estimator, manipulation, cfg, logger):
        super().__init__(env, pose_estimator, manipulation, cfg, logger)
        self.target = cfg.get("target", "pose_estimator")
        pe = cfg.get("pose_estimator", {})
        self.pose_min = np.asarray(pe.get("pose_min", [-0.3, -0.3, 0.4]))
        self.pose_max = np.asarray(pe.get("pose_max", [0.3, 0.3, 1.0]))
        self.save_dir = cfg.get("learn", {}).get("save_dir", "saves/collect")
        os.makedirs(self.save_dir, exist_ok=True)
        self._counter = 0
        self._rng = np.random.default_rng(0)

    def _sample_valid_view(self):
        """Random camera pose whose handle mask is strictly inside the frame
        for all envs (reference collection.py:51-126)."""
        n = self.env.num_envs
        gt = self.env.get_observation(gt=True)["handle_bbox"]
        handle_center = (gt[:, 0] + gt[:, 6]) / 2
        robot_root = self.env.robot_pose()[:, :3]
        for _ in range(self.MAX_TRIES):
            pos = self._rng.uniform(self.pose_min, self.pose_max, size=(n, 3))
            look = (handle_center - robot_root) - pos
            q = lookat_quat(look)
            pose = np.concatenate([pos, q], axis=-1)
            self.env.cam_move_to(pose, time=2, wait=0.5, planner="path",
                                 robot_frame=True, skip_move=True,
                                 no_collision_with_front=False)
            img = self.env.get_image()
            mask = img["camera0"]["Mask"]
            ok = True
            for e in range(n):
                ys, xs = np.nonzero(mask[e])
                if len(ys) == 0 or ys.min() == 0 or xs.min() == 0 \
                        or ys.max() == mask.shape[1] - 1 or xs.max() == mask.shape[2] - 1:
                    ok = False
                    break
            if ok:
                return img, self.env.camera_pose(robot_frame=True)
        return None, None

    def run(self, eval=False):
        views = []
        for _ in range(2):
            img, cam_pose = self._sample_valid_view()
            if img is None:
                self.logger.info("collection: no valid view found, skipping round")
                return
            views.append((img, cam_pose))

        n = self.env.num_envs
        obj_cfgs = self.env.get_attr("current_obj_config")
        robot_cfgs = self.env.get_attr("current_robot_config")
        gt = self.env.get_observation(gt=True)["handle_bbox"]

        for e in range(n):
            self._counter += 1
            out = os.path.join(self.save_dir, f"sample_{self._counter:06d}")
            if self.target == "pose_estimator":
                with open(out + ".pkl", "wb") as f:
                    pickle.dump({
                        "obj_config": obj_cfgs[e],
                        "robot_config": robot_cfgs[e],
                        "cam_poses": [v[1][e] for v in views],
                        "gt_bbox": gt[e],
                    }, f)
                np.savez_compressed(
                    out + ".npz",
                    rgb1=views[0][0]["camera0"]["Color"][e],
                    mask1=views[0][0]["camera0"]["Mask"][e],
                    extrinsic1=views[0][0]["camera0"]["Extrinsic"][e],
                    rgb2=views[1][0]["camera0"]["Color"][e],
                    mask2=views[1][0]["camera0"]["Mask"][e],
                    extrinsic2=views[1][0]["camera0"]["Extrinsic"][e],
                    intrinsic=views[0][0]["camera0"]["Intrinsic"][e],
                    gt_bbox=gt[e])
            else:
                # baselines: full obs + 10k-point cloud back-projected from depth
                cam = views[0][0]["camera0"]
                pos = cam["Position"][e].reshape(-1, 3)
                depth = cam["Depth"][e].reshape(-1)
                pts = pos[depth > 0]
                if len(pts) > 10000:
                    idx = self._rng.choice(len(pts), 10000, replace=False)
                    pts = pts[idx]
                with open(out + ".pkl", "wb") as f:
                    pickle.dump({
                        "obj_config": obj_cfgs[e],
                        "robot_config": robot_cfgs[e],
                        "point_cloud": pts,
                        "gt_bbox": gt[e],
                    }, f)
                np.savez_compressed(out + ".npz",
                                    rgb=cam["Color"][e], mask=cam["Mask"][e],
                                    depth=cam["Depth"][e],
                                    position=cam["Position"][e],
                                    intrinsic=cam["Intrinsic"][e],
                                    extrinsic=cam["Extrinsic"][e])
