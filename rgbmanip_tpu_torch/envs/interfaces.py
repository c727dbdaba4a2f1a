"""Gym / dm_env-style adapters for external baselines
(reference env/sapien_envs/interfaces.py:15-169: GymManipulationEnv with
image observations driving gripper_move_to over 4-step episodes, and
DMCManipulationEnv with dm_env specs and 84x84 observations — used by DrQ-v2
style baselines, not by the main pipeline)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from ..utils.tools import Box
from ..utils.transform import lookat_quat


class GymManipulationEnv:
    """Pose actions -> gripper_move_to; image observations; 4-step episodes."""

    def __init__(self, env, max_episode_steps: int = 4, image_size: int = 84):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self.image_size = image_size
        self.action_space = Box(-1.0, 1.0, shape=(7,))
        self.observation_space = Box(0.0, 1.0, shape=(image_size, image_size, 3))
        self._t = 0

    def _obs(self):
        img = self.env.get_image()["camera0"]["Color"]
        # nearest-subsample to the requested size
        H, W = img.shape[1:3]
        ys = (np.arange(self.image_size) * H // self.image_size)
        xs = (np.arange(self.image_size) * W // self.image_size)
        return img[:, ys][:, :, xs]

    def reset(self):
        self.env.reset()
        self._t = 0
        return self._obs()

    def step(self, action):
        action = np.asarray(action).reshape(self.env.num_envs, -1)
        xyz = action[:, :3]
        q = lookat_quat(action[:, 3:6] + 1e-6)
        pose = np.concatenate([xyz, q], axis=-1)
        self.env.gripper_move_to(pose, time=1, wait=0.5, planner="ik")
        self._t += 1
        obs = self.env.get_observation()
        reward = self.env.get_reward(action)
        done = np.full(self.env.num_envs, self._t >= self.max_episode_steps)
        return self._obs(), reward, done, {"success": obs.get("success")}


@dataclass
class TimeStep:
    step_type: int  # 0 first, 1 mid, 2 last
    reward: Any
    discount: float
    observation: Any

    def first(self):
        return self.step_type == 0

    def last(self):
        return self.step_type == 2


class DMCManipulationEnv:
    """dm_env-style wrapper (84x84 pixels, action/observation specs)."""

    def __init__(self, env, max_episode_steps: int = 4, image_size: int = 84):
        self.gym = GymManipulationEnv(env, max_episode_steps, image_size)
        self._t = 0

    def observation_spec(self) -> Dict[str, Any]:
        return {"pixels": {"shape": (self.gym.image_size, self.gym.image_size, 3),
                           "dtype": np.float32}}

    def action_spec(self) -> Dict[str, Any]:
        return {"shape": (7,), "dtype": np.float32, "minimum": -1.0, "maximum": 1.0}

    def reset(self) -> TimeStep:
        obs = self.gym.reset()
        self._t = 0
        return TimeStep(0, None, 1.0, {"pixels": obs})

    def step(self, action) -> TimeStep:
        obs, reward, done, info = self.gym.step(action)
        self._t += 1
        st = 2 if bool(np.asarray(done).all()) else 1
        return TimeStep(st, reward, 1.0 if st != 2 else 0.0, {"pixels": obs})
