"""Open-cabinet scripted skill (reference models/manipulation/open_cabinet.py:14-116).

Batched over all envs through the vec-env surface. The closed-loop variant
advances toward the handle in 6 cm increments, stopping per-env when contact
blocks progress (hand-position error > 1 cm), then pulls along a direction
that is re-estimated from the achieved gripper motion after each pull step
(the reflection update cur_dir += 2*delta*dot).
"""

from __future__ import annotations

import numpy as np

from ...utils.transform import frame_quat, normalize
from .base_manipulation import BaseManipulation


def batch_frame_quats(x, y, z):
    n = x.shape[0]
    basis = np.eye(3)
    return np.stack([
        frame_quat(basis, np.stack([x[i], y[i], z[i]])) for i in range(n)
    ])


class OpenCabinetManipulation(BaseManipulation):

    GRIP_X_SIGN = -1.0   # gripper x = -z world (vertical handle grip)

    def _pre_grasp_frame(self, pre_grasp_axis, batch):
        z_ = np.tile([0.0, 0.0, 1.0], (batch, 1))
        pre_grasp_x = self.GRIP_X_SIGN * z_
        pre_grasp_z = pre_grasp_axis
        pre_grasp_y = np.cross(pre_grasp_z, pre_grasp_x)
        return batch_frame_quats(pre_grasp_x, pre_grasp_y, pre_grasp_z)

    def plan_pathway(self, center, axis, eval=False):
        center = np.asarray(center, dtype=np.float64)
        axis = np.asarray(axis, dtype=np.float64)
        batch = center.shape[0]
        y_ = np.tile([0.0, 1.0, 0.0], (batch, 1))
        z_ = np.tile([0.0, 0.0, 1.0], (batch, 1))

        # pre-grasp: approach along the horizontal projection of axis[0]
        pre_grasp_axis = axis[:, 0].copy()
        pre_grasp_axis -= z_ * (pre_grasp_axis * z_).sum(-1, keepdims=True)
        norm = np.linalg.norm(pre_grasp_axis, axis=-1, keepdims=True)
        pre_grasp_axis = np.where(norm < 1e-8, y_, pre_grasp_axis / (norm + 1e-8))
        pre_grasp_p = center - pre_grasp_axis * 0.2
        pre_grasp_q = self._pre_grasp_frame(pre_grasp_axis, batch)
        pre_grasp_pose = np.concatenate([pre_grasp_p, pre_grasp_q], axis=-1)

        self.env.class_method("toggle_gripper", open=True)
        self.env.hand_move_to(pre_grasp_pose, time=2, wait=2, planner="path",
                              no_collision_with_front=True)

        proceed = np.ones(batch, dtype=bool)
        grasp_p = pre_grasp_p.copy()

        if self.cfg["closed_loop"]:
            for _ in range(3):
                grasp_p = grasp_p + pre_grasp_axis * 0.06 * proceed[:, None]
                grasp_pose = np.concatenate([grasp_p, pre_grasp_q], axis=-1)
                self.env.hand_move_to(grasp_pose, time=2, wait=1, planner="ik")
                self.env.class_method("_release_target")
                error = np.linalg.norm(self.env.hand_pose()[:, :3] - grasp_p, axis=-1)
                proceed = proceed & (error < 0.01)
            grasp_p = grasp_p - pre_grasp_axis * 0.01
            grasp_pose = np.concatenate([grasp_p, pre_grasp_q], axis=-1)
            self.env.hand_move_to(grasp_pose, time=2, wait=1, planner="ik")
        else:
            grasp_p = grasp_p + pre_grasp_axis * 0.18
            grasp_pose = np.concatenate([grasp_p, pre_grasp_q], axis=-1)
            self.env.hand_move_to(grasp_pose, time=2, wait=1, planner="path")
            self.env.class_method("_release_target")

        self.env.class_method("toggle_gripper", open=False)

        cur_dir = -pre_grasp_axis
        for step_size in self.cfg["step_sizes"]:
            cur_p = self.env.gripper_pose()[:, :3]
            pred_p = cur_p + cur_dir * step_size
            next_x = self.GRIP_X_SIGN * z_
            next_z = -cur_dir
            next_y = np.cross(next_z, next_x)
            pred_q = batch_frame_quats(next_x, next_y, next_z)
            pred_pose = np.concatenate([pred_p, pred_q], axis=-1)
            self.env.gripper_move_to(
                pred_pose, time=step_size * 10, wait=step_size * 5,
                planner="ik" if self.cfg["closed_loop"] else "path")
            new_p = self.env.gripper_pose()[:, :3]
            new_dir = new_p - cur_p
            new_dir[:, 2] = 0.0
            new_dir = normalize(new_dir)
            delta = new_dir - cur_dir
            dot = np.clip((new_dir * cur_dir).sum(-1, keepdims=True), -1, 1)
            cur_dir = normalize(cur_dir + 2 * delta * dot)
