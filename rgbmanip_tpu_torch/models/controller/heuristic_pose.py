"""Heuristic two-view controller (reference models/controller/heuristic_pose.py:25-81):
move the wrist camera to two fixed robot-frame viewpoints, estimate the part
bbox from the two views (or read gt), then run the manipulation skill.

The port's copy of ``rgbmanip_tpu/models/controller/heuristic_pose.py``. One
estimate per round for the whole env batch (K1 twice on the card); the
env's PhaseTimer records it as ``estimate`` and the skill as ``skill``."""

from __future__ import annotations

import numpy as np

from .base_controller import BaseController
from .gt_pose import bbox_to_center_axes
from ..pose_estimator.groundtruth_estimator import GroundTruthPoseEstimator
from ...utils.transform import lookat_quat


class HeuristicPoseController(BaseController):
    VIEW_1 = np.array([-0.1, 0.0, 0.8])
    VIEW_2 = np.array([-0.0, 0.5, 0.7])
    TARGET = np.array([0.5, 0.0, 0.5])

    def run(self, eval=False):
        n = self.env.num_envs
        q1 = lookat_quat(self.TARGET - self.VIEW_1)
        q2 = lookat_quat(self.TARGET - self.VIEW_2)
        pose1 = np.tile(np.concatenate([self.VIEW_1, q1]), (n, 1))
        pose2 = np.tile(np.concatenate([self.VIEW_2, q2]), (n, 1))

        self.env.cam_move_to(pose1, time=2, wait=1, planner="path",
                             robot_frame=True, no_collision_with_front=False)
        img_1 = self.env.get_image()
        self.env.cam_move_to(pose2, time=2, wait=1, planner="path",
                             robot_frame=True, no_collision_with_front=False)
        img_2 = self.env.get_image()

        mask_1 = img_1["camera0"]["Mask"]
        mask_2 = img_2["camera0"]["Mask"]
        if mask_1.sum() == 0 or mask_2.sum() == 0:
            self.logger.info("No mask detected")
            return

        with self.env.timer.phase("estimate"):
            if isinstance(self.pose_estimator, GroundTruthPoseEstimator):
                bbox = np.asarray(self.pose_estimator.estimate())
            else:
                bbox = np.asarray(self.pose_estimator.estimate(
                    img_1["camera0"]["Intrinsic"],
                    img_1["camera0"]["Color"], mask_1, img_1["camera0"]["Extrinsic"],
                    img_2["camera0"]["Color"], mask_2, img_2["camera0"]["Extrinsic"],
                ))
        # Corner read kept at the reference's (1, 7) (heuristic_pose.py:69-81).
        # NOTE (measured): in the shared corner ordering (lib/utils.py:
        # 40-58) these are not an opposite pair — their midpoint is the box
        # center MINUS half-extent along part-local z. An A/B in the JAX package with
        # the true (0, 7) box center DROPPED mug success 37.5 -> 26.9 (104 eps): the
        # skill's approach geometry is empirically calibrated to the (1, 7)
        # read (the offset lands the grip nearer the handle bar plane), so
        # the reference behavior is also the better-performing one.
        center, direction = bbox_to_center_axes(bbox, center_corners=(1, 7))
        with self.env.timer.phase("skill"):
            self.manipulation.plan_pathway(center, direction, eval)
