"""Ground-truth oracle estimator (reference
models/pose_estimator/groundtruth_estimator.py:6-17): returns the env's gt
handle bbox, isolating controller+manipulation from perception."""

from __future__ import annotations

from .base_estimator import BasePoseEstimator


class GroundTruthPoseEstimator(BasePoseEstimator):
    def __init__(self, env, cfg: dict, logger):
        super().__init__(cfg, logger)
        self.env = env

    def estimate(self, *args, **kwargs):
        return self.env.get_observation(gt=True)["handle_bbox"]
