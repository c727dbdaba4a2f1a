"""Base controller (reference models/controller/base_controller.py:8-59)."""

from __future__ import annotations


class BaseController:
    def __init__(self, env, pose_estimator, manipulation, cfg: dict, logger):
        self.env = env
        self.pose_estimator = pose_estimator
        self.manipulation = manipulation
        self.cfg = cfg
        self.logger = logger

    def run(self, eval=False):
        raise NotImplementedError

    def train_controller(self, *args, **kwargs):
        return self.learn(*args, **kwargs)

    def train_manipulation(self, *args, **kwargs):
        return self.manipulation.learn(*args, **kwargs)

    def learn(self, *args, **kwargs):
        raise NotImplementedError

    def save(self, path):
        pass

    def load(self, path):
        pass
