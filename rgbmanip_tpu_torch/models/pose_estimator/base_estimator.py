"""Abstract pose estimator (counterpart of
``rgbmanip_tpu/models/pose_estimator/base_estimator.py``)."""

from __future__ import annotations


class BasePoseEstimator:
    def __init__(self, cfg: dict, logger):
        self.cfg = cfg
        self.logger = logger

    def estimate(self, *args, **kwargs):
        """Return (B, 8, 3) world-frame bbox corners of the target part."""
        raise NotImplementedError

    def append_picture(self, *args, **kwargs):
        raise NotImplementedError
