"""PPO policy inference (counterpart of the ``ActorCritic`` and
``act_inference`` parts of ``rgbmanip_tpu/algo/ppo.py``).

Separate actor and critic MLPs with a learned global ``log_std``. The
policy holder reads ``params/params/{actor,critic}`` and ``log_std`` from a
flax ``ppo_rl_*.ckpt`` and gives the deterministic action (the actor's mean).
Training is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import repo_path, resolve_device
from ..utils.checkpoint import read_msgpack

def _mlp(in_dim: int, hidden: Sequence[int], out_dim: int, activation: str):
    if activation != "elu":
        raise NotImplementedError(
            f"activation {activation!r} is not ported yet (ROADMAP.md, Queue 1: "
            f"'PPO and estimator training'); every committed policy uses elu")
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), nn.ELU()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int,
                 pi_hid: Sequence[int] = (96, 96, 32),
                 vf_hid: Sequence[int] = (96, 96, 32), activation: str = "elu",
                 init_noise_std: float = 0.6):
        super().__init__()
        self.actor = _mlp(obs_dim, pi_hid, action_dim, activation)
        self.critic = _mlp(obs_dim, vf_hid, 1, activation)
        self.log_std = nn.Parameter(torch.full((action_dim,), math.log(init_noise_std)))

    def forward(self, obs):
        """obs (B, obs_dim) -> (mean (B, A), std (A,), value (B,))."""
        return self.actor(obs), torch.exp(self.log_std), self.critic(obs)[..., 0]


def load_flax_actor_critic(model: ActorCritic, params: dict) -> None:
    """Copy the flax ``ActorCritic`` tree (``{actor, critic}/Dense_i`` and
    ``log_std``) into ``model``; raises on a missing or left-over leaf or a
    shape mismatch."""
    state = model.state_dict()
    new = {"log_std": np.asarray(params["log_std"])}
    for net in ("actor", "critic"):
        dense = params[net]
        n_linear = sum(isinstance(m, nn.Linear) for m in getattr(model, net))
        if sorted(dense) != sorted(f"Dense_{i}" for i in range(n_linear)):
            raise ValueError(f"{net}: checkpoint has {sorted(dense)}, the port "
                             f"has {n_linear} Linear layers")
        for i in range(n_linear):
            new[f"{net}.{2 * i}.weight"] = np.asarray(dense[f"Dense_{i}"]["kernel"]).T
            new[f"{net}.{2 * i}.bias"] = np.asarray(dense[f"Dense_{i}"]["bias"])
    if sorted(params) != ["actor", "critic", "log_std"] or sorted(new) != sorted(state):
        raise ValueError(f"checkpoint leaves {sorted(params)} do not match the "
                         f"port's {sorted(state)}")
    with torch.no_grad():
        for k, w in new.items():
            if tuple(w.shape) != tuple(state[k].shape):
                raise ValueError(f"{k}: checkpoint shape {w.shape}, port "
                                 f"{tuple(state[k].shape)}")
            state[k].copy_(torch.from_numpy(np.ascontiguousarray(w, np.float32)))


class PPOPolicy:
    """Inference holder for a trained camera-scheduling policy."""

    def __init__(self, model: ActorCritic, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path: str, policy_cfg: Optional[dict] = None,
                        device=None) -> "PPOPolicy":
        """Build from a flax ``ppo_rl_*.ckpt``; the observation and action
        widths come from the checkpoint, the hidden sizes and activation
        from ``policy_cfg`` (the ``policy`` block of controller/rl.yaml)."""
        device = resolve_device(device)
        cfg = policy_cfg or {}
        params = read_msgpack(repo_path(path))["params"]["params"]
        model = ActorCritic(
            obs_dim=params["actor"]["Dense_0"]["kernel"].shape[0],
            action_dim=params["log_std"].shape[0],
            pi_hid=tuple(cfg.get("pi_hid_sizes", (96, 96, 32))),
            vf_hid=tuple(cfg.get("vf_hid_sizes", (96, 96, 32))),
            activation=cfg.get("activation", "elu"))
        load_flax_actor_critic(model, params)
        return cls(model, device)

    @torch.inference_mode()
    def act_inference(self, obs):
        """Deterministic action (the actor's mean) for obs (B, obs_dim);
        numpy in, numpy out."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        return self.model.actor(obs).cpu().numpy()
