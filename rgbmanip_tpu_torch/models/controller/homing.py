"""Homing controller (reference models/controller/homing.py:25-35): move the
hand to one fixed pose (real-robot homing)."""

from __future__ import annotations

import numpy as np

from .base_controller import BaseController
from ...utils.transform import lookat_quat


class HomingController(BaseController):
    HOME_POS = np.array([0.3, 0.0, 0.6])
    HOME_LOOK = np.array([1.0, 0.0, -0.5])

    def run(self, eval=False):
        n = self.env.num_envs
        q = lookat_quat(self.HOME_LOOK)
        pose = np.tile(np.concatenate([self.HOME_POS, q]), (n, 1))
        self.env.hand_move_to(pose, time=2, wait=1, planner="path",
                              robot_frame=True, no_collision_with_front=False)
