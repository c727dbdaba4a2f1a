"""Abstract manipulation skill (reference models/manipulation/base_manipulation.py:6-16)."""

from __future__ import annotations


class BaseManipulation:
    def __init__(self, env, cfg: dict, logger):
        self.env = env
        self.cfg = cfg
        self.logger = logger

    def plan_pathway(self, center, axis, eval=False):
        raise NotImplementedError

    def learn(self):
        raise NotImplementedError
