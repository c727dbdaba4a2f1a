"""Ground-truth pose controller (reference models/controller/gt_pose.py:14-40):
no camera moves — read the gt bbox, derive the grasp frame, run the skill."""

from __future__ import annotations

import numpy as np

from .base_controller import BaseController
from ..pose_estimator.groundtruth_estimator import GroundTruthPoseEstimator


def bbox_to_center_axes(bbox: np.ndarray, center_corners=(0, 7)):
    """Grasp center + 3-axis frame from an 8-corner bbox (reference
    gt_pose.py:31-44 / heuristic_pose.py:69-81)."""
    center = (bbox[:, center_corners[0]] + bbox[:, center_corners[1]]) / 2
    direction = np.zeros((bbox.shape[0], 3, 3))
    direction[:, 0] = bbox[:, 1] - bbox[:, 0]
    direction[:, 1] = bbox[:, 0] - bbox[:, 2]
    direction[:, 2] = bbox[:, 4] - bbox[:, 0]
    d_norm = np.linalg.norm(direction, axis=-1, keepdims=True)
    fallback = np.tile(np.eye(3), (bbox.shape[0], 1, 1))
    direction = np.where(d_norm > 1e-8, direction / (d_norm + 1e-8), fallback)
    return center, direction


class GtPoseController(BaseController):
    def run(self, eval=False):
        if not isinstance(self.pose_estimator, GroundTruthPoseEstimator):
            raise NotImplementedError("gt_pose controller needs the gt estimator")
        bbox = np.asarray(self.pose_estimator.estimate())
        center, direction = bbox_to_center_axes(bbox, center_corners=(0, 7))
        self.manipulation.plan_pathway(center, direction, eval)
