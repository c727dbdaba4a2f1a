"""Baseline replay controller (reference models/controller/baseline.py:12-39):
replay an offline action (grasp point + direction) against a loaded task
setting, mapping the direction to the per-skill axis convention."""

from __future__ import annotations

import numpy as np

from .base_controller import BaseController


class BaselineController(BaseController):
    def run(self, setting, action, eval=False):
        """setting: {obj_config, robot_config}; action: (6,) point+direction."""
        self.env.load(setting)
        n = self.env.num_envs
        point = np.tile(np.asarray(action[:3], np.float64), (n, 1))
        direction = np.asarray(action[3:6], np.float64)
        direction = direction / (np.linalg.norm(direction) + 1e-9)

        # per-skill axis convention (reference baseline.py:17-38): build the
        # 3-axis frame the skill expects from the predicted direction
        name = self.manipulation.__class__.__name__.lower()
        axes = np.zeros((n, 3, 3))
        if "pot" in name or "mug" in name:
            axes[:, 0] = [0, 0, -1]
            horiz = direction.copy()
            horiz[2] = 0
            if np.linalg.norm(horiz) < 1e-8:
                horiz = np.array([0, 1.0, 0])
            axes[:, 1] = horiz / np.linalg.norm(horiz)
            axes[:, 2] = np.cross(axes[0, 0], axes[0, 1])
        else:
            axes[:, 0] = -direction
            axes[:, 1] = np.cross([0, 0, 1.0], -direction)
            axes[:, 2] = [0, 0, 1]
        self.manipulation.plan_pathway(point, axes, eval)
