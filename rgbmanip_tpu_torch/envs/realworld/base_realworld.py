"""Real-robot environment (reference env/realworld_envs/base_realworld.py:12-135).

Duck-types the vec-env surface (get_image / cam_move_to / hand_move_to /
gripper_move_to / toggle_gripper) for a physical Franka arm with a wrist
RealSense camera, using Segment-Anything for the mask in place of the sim's
segmentation ids. The robot/camera/SAM drivers are hardware-bound and not
part of this repository; each is injected via a driver object so the stack
stays API-compatible and unit-testable with fakes.

(The port's copy of ``rgbmanip_tpu/envs/realworld/base_realworld.py``;
its estimator is the port's ``make_estimator("realworld")``.)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import yaml

from ...utils.logger import get_logger
from ...utils.transform import Pose, quat_to_axis

CALIB_FILE = os.path.join(os.path.dirname(__file__),
                          "panda_rs_handeyecalibration_eye_on_hand.yaml")


class BaseRealworldEnv:
    num_envs = 1

    def __init__(self, robot_driver=None, camera_driver=None, segmenter=None,
                 calibration_path: Optional[str] = None, logger=None):
        self.logger = logger or get_logger()
        self.robot = robot_driver      # Franka impedance-control driver
        self.camera = camera_driver    # RealSense capture
        self.segmenter = segmenter     # SAM-style mask predictor
        self.hand_cam_pose = self._load_calibration(calibration_path or CALIB_FILE)
        self.last_action = np.zeros((1, 8), np.float32)
        self.total_move_distance = np.zeros(1)

    def _load_calibration(self, path: str) -> Pose:
        """Hand-eye calibration: camera pose in the hand frame."""
        if os.path.exists(path):
            with open(path) as f:
                data = yaml.safe_load(f)
            t = data.get("transformation", data)
            return Pose([t["x"], t["y"], t["z"]],
                        [t["qw"], t["qx"], t["qy"], t["qz"]])
        self.logger.warning(f"no hand-eye calibration at {path}; using defaults")
        return Pose([0.1, 0, 0.1], [0.70710678, 0, -0.70710678, 0])

    def _require(self, driver, name):
        if driver is None:
            raise RuntimeError(
                f"real-world {name} driver not configured — construct "
                f"BaseRealworldEnv with the hardware drivers to run on a robot")
        return driver

    # --- vec-env surface ---
    def hand_pose(self, robot_frame=False) -> np.ndarray:
        return np.asarray(self._require(self.robot, "robot").hand_pose())[None]

    def camera_pose(self, robot_frame=False) -> np.ndarray:
        hp = Pose.from_7d(self.hand_pose()[0])
        return (hp * self.hand_cam_pose).to_7d()[None]

    def gripper_pose(self, robot_frame=False) -> np.ndarray:
        hp = self.hand_pose()
        open_dir = quat_to_axis(hp[:, 3:], 2) * 0.105
        return np.concatenate([hp[:, :3] + open_dir, hp[:, 3:]], axis=-1)

    def get_image(self, mask="handle", indices=None):
        cam = self._require(self.camera, "camera")
        rgb, depth, K = cam.capture()
        seg = self._require(self.segmenter, "segmenter").predict(rgb)
        cp = Pose.from_7d(self.camera_pose()[0])
        from ..vec_env import camera_extrinsic_matrix
        return {"camera0": {
            "Color": rgb[None].astype(np.float32),
            "Depth": depth[None].astype(np.float32),
            "Position": np.zeros((1,) + rgb.shape[:2] + (3,), np.float32),
            "Norm": np.zeros((1,) + rgb.shape[:2] + (3,), np.float32),
            "Mask": seg[None].astype(bool),
            "Intrinsic": K[None].astype(np.float32),
            "Extrinsic": camera_extrinsic_matrix(cp)[None].astype(np.float32),
        }}

    def hand_move_to(self, poses, time=2, wait=1, planner="ik", robot_frame=False,
                     skip_move=False, no_collision_with_front=True, indices=None):
        robot = self._require(self.robot, "robot")
        robot.move_to(np.asarray(poses).reshape(-1)[:7], duration=time + wait)
        return np.ones(1, bool)

    def cam_move_to(self, poses, **kw):
        poses = np.asarray(poses).reshape(1, 7)
        inv_cam = self.hand_cam_pose.inv()
        hand = (Pose.from_7d(poses[0]) * inv_cam).to_7d()
        return self.hand_move_to(hand[None], **kw)

    def gripper_move_to(self, poses, **kw):
        poses = np.asarray(poses).reshape(1, 7)
        open_dir = quat_to_axis(poses[:, 3:], 2) * 0.105
        hand = np.concatenate([poses[:, :3] - open_dir, poses[:, 3:]], axis=-1)
        return self.hand_move_to(hand, **kw)

    def toggle_gripper(self, open=True, indices=None):
        self._require(self.robot, "robot").set_gripper(0.04 if open else 0.0)

    def class_method(self, name, *args, indices=None, **kwargs):
        return getattr(self, name)(*args, **kwargs)

    def robot_pose(self):
        return np.tile(Pose().to_7d(), (1, 1))

    def get_observation(self, gt=False):
        return {"hand_pose": self.hand_pose().astype(np.float32),
                "gripper_pose": self.gripper_pose().astype(np.float32),
                "last_action": self.last_action,
                "total_move_distance": self.total_move_distance.astype(np.float32)}

    def reset(self, gt=False, indices=None):
        return self.get_observation(gt)

    def close(self):
        pass
