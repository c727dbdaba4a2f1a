"""Open-pot scripted skill (reference models/manipulation/open_pot.py:14-72):
top-down grasp of the lid, then vertical lift by step_sizes."""

from __future__ import annotations

import numpy as np

from .base_manipulation import BaseManipulation
from .open_cabinet import batch_frame_quats


class OpenPotManipulation(BaseManipulation):

    def plan_pathway(self, center, axis, eval=False):
        center = np.asarray(center, dtype=np.float64)
        axis = np.asarray(axis, dtype=np.float64)
        batch = center.shape[0]
        z_ = np.tile([0.0, 0.0, 1.0], (batch, 1))

        pre_grasp_axis = -z_
        pre_grasp_p = center - pre_grasp_axis * 0.08
        pre_grasp_y = np.cross(pre_grasp_axis, axis[:, 1])
        pre_grasp_y /= np.linalg.norm(pre_grasp_y, axis=-1, keepdims=True) + 1e-9
        pre_grasp_x = -np.cross(pre_grasp_axis, pre_grasp_y)
        pre_grasp_x /= np.linalg.norm(pre_grasp_x, axis=-1, keepdims=True) + 1e-9
        pre_grasp_z = pre_grasp_axis
        pre_grasp_q = batch_frame_quats(pre_grasp_x, pre_grasp_y, pre_grasp_z)
        pre_grasp_pose = np.concatenate([pre_grasp_p, pre_grasp_q], axis=-1)

        grasp_p = center + pre_grasp_axis * 0.03
        grasp_pose = np.concatenate([grasp_p, pre_grasp_q], axis=-1)

        self.env.class_method("toggle_gripper", open=True)
        self.env.gripper_move_to(pre_grasp_pose, time=2, wait=1, planner="path")
        self.env.class_method("toggle_gripper", open=True)
        self.env.gripper_move_to(grasp_pose, time=2, wait=1, planner="ik")
        self.env.class_method("toggle_gripper", open=False)

        last_dir = -pre_grasp_axis  # lift straight up
        gripper_p = self.env.gripper_pose()[:, :3]
        for step_size in self.cfg["step_sizes"]:
            next_p = gripper_p + last_dir / (
                np.linalg.norm(last_dir, axis=-1, keepdims=True) + 1e-4) * step_size
            next_pose = np.concatenate([next_p, pre_grasp_q], axis=-1)
            self.env.gripper_move_to(next_pose, time=2, wait=1, planner="ik")
            gripper_p = self.env.gripper_pose()[:, :3]
