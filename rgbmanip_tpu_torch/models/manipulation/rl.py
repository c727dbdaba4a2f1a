"""RL low-level manipulation (counterpart of
``rgbmanip_tpu/models/manipulation/rl.py``; reference
models/manipulation/rl.py:12-27): PPO directly on the env's joint-space
action interface, the policy on ``device``.

Neither package's config tree has a manipulation group with the ``learn``
and ``policy`` blocks that ``PPO`` reads; pass them with the group, e.g.
those of ``controller/rl.yaml`` as flow mappings:
``manipulation.name=rl manipulation.learn={...} manipulation.policy={...}``.
"""

from __future__ import annotations

import numpy as np

from .base_manipulation import BaseManipulation
from ...utils.tools import Box, flatten_obs


class FlatEnvAdapter:
    """Adapts the dict-obs vec env to PPO's flat-array interface."""

    def __init__(self, env):
        self.env = env
        self.num_envs = env.num_envs
        obs = env.get_observation()
        state = env.get_state()
        self.obs_keys = sorted(k for k in obs if k != "image")
        self.state_keys = sorted(k for k in state if k != "image")
        self.observation_space = Box(-np.inf, np.inf,
                                     shape=(flatten_obs(obs).shape[-1],))
        self.state_space = Box(-np.inf, np.inf,
                               shape=(flatten_obs(state).shape[-1],))
        self.action_space = env.action_space

    def reset(self):
        return flatten_obs(self.env.reset())

    def step(self, action):
        obs, rew, done, info = self.env.step(action)
        return flatten_obs(obs), rew, done, info

    def get_state(self):
        return flatten_obs(self.env.get_state())

    def get_success(self):
        return self.env.get_success()


class RLManipulation(BaseManipulation):
    def __init__(self, env, cfg: dict, logger, writer=None, device=None):
        super().__init__(env, cfg, logger)
        from ...algo.ppo import PPO

        self.adapter = FlatEnvAdapter(env)
        self.algo = PPO(self.adapter, cfg, writer=writer, device=device)

    def learn(self, steps=600, *args, **kwargs):
        self.algo.run(steps)

    def plan_pathway(self, center, axis, eval=False):
        self.algo.play()
