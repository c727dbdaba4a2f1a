"""PPO for the camera-scheduling policy (counterpart of
``rgbmanip_tpu/algo/ppo.py``; reference algo/ppo/ppo/{ppo,module,storage}.py).

Separate actor and critic MLPs with a learned global ``log_std``; rollouts
through the host-side env into numpy staging buffers, one copy to the
device per iteration; GAE; the 8-epoch x 4-minibatch clipped-surrogate
update with the adaptive-KL learning rate. The update follows the JAX
package's optax chain (``clip_by_global_norm`` then ``inject_hyperparams(
adam)``) step for step:

- each minibatch is a sequential slice of the (T*N) flattening, no shuffle;
- the KL of that minibatch, taken at the parameters before its step, picks
  the new learning rate (/1.5 down to ``min_lr``, *1.5 up to ``max_lr``,
  rounded in f32 as XLA does), which that same step then uses;
- the gradients are clipped by optax's rule: scaled by ``max_norm / norm``
  only when the global norm (``log_std`` included) is at least ``max_norm``;
- ``torch.optim.Adam`` (eps 1e-8) takes the step.

With a ``mesh`` (``parallel.mesh.make_mesh``) each rank updates on its dp
block of the envs, as the JAX package's update runs a rollout sharded on
its env axis, and every value the update reads is the global one: each
minibatch is the rank's rows of the global minibatch (a band of time steps
across all envs), each loss term is the rank's share of the minibatch's
mean, and the gradients with the metrics are summed over the dp sub-group
before the KL picks the rate and the global norm clips. The parameters stay
replicated, as in the JAX dryrun.

Checkpoints are the JAX package's file (``model_<it>.ckpt``, flax msgpack):
``params/params/...``, the optax ``opt_state`` with the Adam moments and
``lr``; each package resumes from the other's, moments included.
``PPOPolicy`` holds a trained actor for the evaluation path.
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from .. import repo_path, resolve_device
from ..parallel.mesh import shard_batch
from ..utils.checkpoint import read_msgpack, write_msgpack
from ..utils.logger import MetricsWriter, PhaseTimer, get_logger

_ACTIVATIONS = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh, "selu": nn.SELU,
                # flax's nn.gelu is the tanh approximation; nn.swish is SiLU
                "gelu": lambda: nn.GELU(approximate="tanh"), "swish": nn.SiLU}
_ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def get_activation(name: str) -> nn.Module:
    return _ACTIVATIONS[name]()


def _mlp(in_dim: int, hidden: Sequence[int], out_dim: int, activation: str):
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), get_activation(activation)]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


def _orthogonal_init_(mlp: nn.Sequential, out_gain: float, generator: torch.Generator):
    """flax's init of the JAX ``MLP``: orthogonal kernels, gain sqrt(2) on the
    hidden layers and ``out_gain`` on the last; zero biases."""
    linears = [m for m in mlp if isinstance(m, nn.Linear)]
    with torch.no_grad():
        for i, lin in enumerate(linears):
            gain = out_gain if i == len(linears) - 1 else math.sqrt(2.0)
            nn.init.orthogonal_(lin.weight, gain, generator=generator)
            lin.bias.zero_()


class ActorCritic(nn.Module):
    """Separate actor and critic MLPs and a learned global ``log_std``
    (reference module.py:8-107). The critic reads ``state`` when
    ``asymmetric``. The initial weights are drawn from ``generator`` as the
    JAX package's flax init draws them (their distribution, not their
    numbers); the global generator is left as it was."""

    def __init__(self, obs_dim: int, action_dim: int,
                 pi_hid: Sequence[int] = (96, 96, 32),
                 vf_hid: Sequence[int] = (96, 96, 32), activation: str = "elu",
                 init_noise_std: float = 0.6, state_dim: Optional[int] = None,
                 asymmetric: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.asymmetric = asymmetric
        with torch.random.fork_rng(devices=[]):
            self.actor = _mlp(obs_dim, pi_hid, action_dim, activation)
            self.critic = _mlp(state_dim if asymmetric else obs_dim, vf_hid, 1, activation)
        self.log_std = nn.Parameter(torch.full((action_dim,), math.log(init_noise_std)))
        generator = generator or torch.Generator().manual_seed(0)
        _orthogonal_init_(self.actor, 0.01, generator)
        _orthogonal_init_(self.critic, 1.0, generator)

    def forward(self, obs, state=None):
        """obs (B, obs_dim) -> (mean (B, A), std (A,), value (B,))."""
        critic_in = state if (self.asymmetric and state is not None) else obs
        return self.actor(obs), torch.exp(self.log_std), self.critic(critic_in)[..., 0]

    @torch.inference_mode()
    def act_inference(self, obs):
        """Deterministic action (the actor's mean) for obs (B, obs_dim);
        numpy in, numpy out."""
        dev = self.log_std.device
        return self.actor(torch.as_tensor(obs, dtype=torch.float32, device=dev)).cpu().numpy()


def _linears(model: ActorCritic, net: str):
    return [i for i, m in enumerate(getattr(model, net)) if isinstance(m, nn.Linear)]


def flax_to_state(model: ActorCritic, params: dict) -> Dict[str, np.ndarray]:
    """The flax ``ActorCritic`` tree (``{actor, critic}/Dense_i`` and
    ``log_std``) as arrays under the names of ``model.state_dict()``; raises
    on a missing or left-over leaf or a shape mismatch."""
    state = model.state_dict()
    new = {"log_std": np.asarray(params["log_std"])}
    for net in ("actor", "critic"):
        dense = params[net]
        idx = _linears(model, net)
        if sorted(dense) != sorted(f"Dense_{i}" for i in range(len(idx))):
            raise ValueError(f"{net}: checkpoint has {sorted(dense)}, the port "
                             f"has {len(idx)} Linear layers")
        for i, j in enumerate(idx):
            new[f"{net}.{j}.weight"] = np.asarray(dense[f"Dense_{i}"]["kernel"]).T
            new[f"{net}.{j}.bias"] = np.asarray(dense[f"Dense_{i}"]["bias"])
    if sorted(params) != ["actor", "critic", "log_std"] or sorted(new) != sorted(state):
        raise ValueError(f"checkpoint leaves {sorted(params)} do not match the "
                         f"port's {sorted(state)}")
    for k, w in new.items():
        if tuple(w.shape) != tuple(state[k].shape):
            raise ValueError(f"{k}: checkpoint shape {w.shape}, port "
                             f"{tuple(state[k].shape)}")
    return {k: np.array(w, np.float32, order="C") for k, w in new.items()}


def state_to_flax(model: ActorCritic, tensors: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``flax_to_state``: tensors named as ``model``'s
    parameters -> the flax tree of numpy arrays."""
    out = {}
    for net in ("actor", "critic"):
        out[net] = {f"Dense_{i}": {
            "bias": tensors[f"{net}.{j}.bias"].detach().cpu().numpy().copy(),
            "kernel": tensors[f"{net}.{j}.weight"].detach().cpu().numpy().T.copy()}
            for i, j in enumerate(_linears(model, net))}
    out["log_std"] = tensors["log_std"].detach().cpu().numpy().copy()
    return out


def load_flax_actor_critic(model: ActorCritic, params: dict) -> None:
    """Copy the flax ``ActorCritic`` tree into ``model`` in place."""
    new = flax_to_state(model, params)
    state = model.state_dict()
    with torch.no_grad():
        for k, w in new.items():
            state[k].copy_(torch.from_numpy(w))


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

    def act_inference(self, obs):
        return self.model.act_inference(obs)


def gaussian_logprob(mean, std, action):
    var = std ** 2
    return (-0.5 * ((action - mean) ** 2 / var + torch.log(2 * math.pi * var))).sum(-1)


def gaussian_entropy(std):
    log_2pi = torch.log(torch.tensor(2 * math.pi, dtype=std.dtype, device=std.device))
    return (0.5 + 0.5 * log_2pi + torch.log(std)).sum(-1)


class RolloutStorage:
    """Host-side (T, N, ...) staging buffers (reference storage.py:5-86);
    shipped to the device as one batch per update."""

    def __init__(self, T, N, obs_dim, state_dim, act_dim):
        self.T, self.N = T, N
        self.obs = np.zeros((T, N, obs_dim), np.float32)
        self.states = np.zeros((T, N, state_dim), np.float32)
        self.actions = np.zeros((T, N, act_dim), np.float32)
        self.rewards = np.zeros((T, N), np.float32)
        self.dones = np.zeros((T, N), np.float32)
        self.values = np.zeros((T, N), np.float32)
        self.logprobs = np.zeros((T, N), np.float32)
        self.mu = np.zeros((T, N, act_dim), np.float32)
        self.sigma = np.zeros((T, N, act_dim), np.float32)
        self.step = 0

    def add(self, obs, state, action, reward, done, value, logprob, mu, sigma):
        t = self.step
        self.obs[t] = obs
        self.states[t] = state
        self.actions[t] = action
        self.rewards[t] = reward
        self.dones[t] = done
        self.values[t] = value
        self.logprobs[t] = logprob
        self.mu[t] = mu
        self.sigma[t] = sigma
        self.step += 1

    def clear(self):
        self.step = 0


def compute_gae(rewards, dones, values, last_value, gamma: float, lam: float):
    """(T, N) GAE returns and normalised advantages (reference
    storage.py:50-64), a reverse loop over T. The advantages are normalised
    by the population std, as ``jnp.std``."""
    advs = torch.empty_like(rewards)
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(rewards.shape[0])):
        not_done = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * not_done - values[t]
        next_adv = delta + gamma * lam * not_done * next_adv
        advs[t] = next_adv
        next_value = values[t]
    returns = advs + values
    advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    return returns, advs


def _sum_of_squares(g):
    """sum(g * g) over the whole tensor: a DTensor's local sum of squares
    is summed over each mesh dim it is sharded on."""
    if not isinstance(g, DTensor):
        return (g * g).sum()
    s = (g.to_local() ** 2).sum()
    for dim, placement in enumerate(g.placements):
        if placement.is_shard():
            dist.all_reduce(s, group=g.device_mesh.get_group(dim))
    return s


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: unchanged below ``max_norm``, else ``g / norm * max_norm``. A
    gradient that is a sharded DTensor enters the norm whole. Returns the
    norm (a device tensor; nothing waits for it)."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(_sum_of_squares(g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g = g.to_local() if isinstance(g, DTensor) else g
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class PPO:
    """On-policy trainer (reference algo/ppo/ppo/ppo.py:55-551) on ``device``
    (the card unless the caller asks for the CPU). ``seed`` draws the
    initial weights (CPU generator) and the action noise (a generator on the
    device). ``action_source``, when set, is called at each rollout step for
    the actions to take instead of drawn ones (the log-probabilities and
    values are the policy's own at those actions); parity runs set it to
    replay another run's actions. ``mesh``: update each rank on its dp block
    of the envs (module docstring); ``vec_env`` is the whole env, and
    ``run`` steps it whole on every rank."""

    def __init__(self, vec_env, cfg: dict, writer: Optional[MetricsWriter] = None,
                 seed: int = 0, device=None, mesh=None):
        self.env = vec_env
        self.cfg = cfg
        ctrl = cfg.get("controller")
        nested = isinstance(ctrl, dict)
        learn = ctrl["learn"] if nested and "learn" in ctrl else cfg["learn"]
        pol = ctrl["policy"] if nested and "policy" in ctrl else cfg["policy"]
        self.learn_cfg = learn
        self.log = get_logger()
        self.writer = writer
        self.device = resolve_device(device)
        self.mesh = mesh
        self.save_dir = learn.get("save_dir", "saves/ppo")

        self.num_transitions = int(learn["num_transitions_per_env"])
        self.num_envs = vec_env.num_envs
        self.gamma = float(learn["gamma"])
        self.lam = float(learn["lam"])
        self.clip_range = float(learn["clip_range"])
        self.epochs = int(learn["num_learning_epochs"])
        self.minibatches = int(learn["num_mini_batches"])
        self.value_coef = float(learn["value_loss_coef"])
        self.entropy_coef = float(learn["entropy_coef"])
        self.max_grad_norm = float(learn["max_grad_norm"])
        self.desired_kl = float(learn.get("desired_kl", 0.016))
        self.adaptive = learn.get("schedule", "adaptive") == "adaptive"
        self.min_lr = float(learn.get("min_lr", 2e-4))
        self.max_lr = float(learn.get("max_lr", 5e-3))
        self.use_clipped_value = bool(learn.get("use_clipped_value_loss", True))
        self.asymmetric = bool(learn.get("asymmetric", False))

        obs_dim = int(np.prod(vec_env.observation_space.shape))
        state_dim = int(np.prod(vec_env.state_space.shape))
        act_dim = int(np.prod(vec_env.action_space.shape))
        self.obs_dim, self.state_dim, self.act_dim = obs_dim, state_dim, act_dim

        self.model = ActorCritic(
            obs_dim, act_dim, pi_hid=tuple(pol["pi_hid_sizes"]),
            vf_hid=tuple(pol["vf_hid_sizes"]), activation=pol.get("activation", "elu"),
            init_noise_std=float(learn.get("init_noise_std", 0.6)),
            state_dim=state_dim, asymmetric=self.asymmetric,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        # the learning rate lives in f32, as the JAX package's injected
        # hyperparameter does
        self.lr = float(np.float32(learn["learning_rate"]))
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                          betas=(_ADAM["b1"], _ADAM["b2"]),
                                          eps=_ADAM["eps"])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.action_source: Optional[Callable[[], np.ndarray]] = None
        self.update_lrs: list = []

        self.storage = RolloutStorage(self.num_transitions, self.num_envs,
                                      obs_dim, state_dim, act_dim)
        self.current_learning_iteration = 0
        self.tot_timesteps = 0
        self.history: list = []   # per iteration: collect and learn seconds, metrics
        inner = getattr(vec_env, "env", vec_env)
        self.timer = getattr(inner, "timer", None) or PhaseTimer()

    # --- policy ---
    @torch.no_grad()
    def _act(self, obs, state, action=None):
        """(action, logprob, mean, sigma, value) at obs/state (device
        tensors); the action is drawn from the trainer's generator unless
        given."""
        mean, std, value = self.model(obs, state)
        if action is None:
            noise = torch.randn(mean.shape, generator=self.generator, device=self.device)
            action = mean + std * noise
        logprob = gaussian_logprob(mean, std, action)
        return action, logprob, mean, std * torch.ones_like(mean), value

    def act_inference(self, obs):
        return self.model.act_inference(obs)

    # --- update: epochs x minibatches with the adaptive-KL learning rate ---
    def _loss(self, mb, count: Optional[int] = None):
        """(loss, [surrogate, value loss, entropy, kl]) of one minibatch;
        with ``count``, the global minibatch's row count when ``mb`` is this
        rank's share of it, each a share of the global mean."""
        def mean(x):
            return x.mean() if count is None else x.sum() / count

        mean_, std, value = self.model(mb["obs"], mb["states"])
        logprob = gaussian_logprob(mean_, std, mb["actions"])
        ratio = torch.exp(logprob - mb["logprobs"])
        adv = mb["advantages"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - self.clip_range, 1 + self.clip_range) * adv
        surrogate = -mean(torch.minimum(surr1, surr2))
        if self.use_clipped_value:
            v_clipped = mb["values"] + torch.clamp(value - mb["values"],
                                                   -self.clip_range, self.clip_range)
            v_loss = mean(torch.maximum((value - mb["returns"]) ** 2,
                                        (v_clipped - mb["returns"]) ** 2))
        else:
            v_loss = mean((mb["returns"] - value) ** 2)
        entropy = gaussian_entropy(std)    # one value for every row
        entropy = entropy.mean() if count is None else entropy * (adv.shape[0] / count)
        loss = surrogate + self.value_coef * v_loss - self.entropy_coef * entropy
        # KL between the old and the new gaussians (reference ppo.py:480-488)
        kl = mean((torch.log(std / mb["sigma"] + 1e-5)
                   + (mb["sigma"] ** 2 + (mb["mu"] - mean_) ** 2) / (2 * std ** 2)
                   - 0.5).sum(-1))
        return loss, [surrogate, v_loss, entropy, kl.detach()]

    def _next_lr(self, lr: np.float32, kl: float) -> np.float32:
        kl = np.float32(kl)
        if kl > np.float32(self.desired_kl * 2.0):
            return np.maximum(lr / np.float32(1.5), np.float32(self.min_lr))
        if kl < np.float32(self.desired_kl / 2.0):
            return np.minimum(lr * np.float32(1.5), np.float32(self.max_lr))
        return lr

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update from a (T, N, ...) batch of device tensors (``obs``,
        ``states``, ``actions``, ``logprobs``, ``values``, ``returns``,
        ``advantages``, ``mu``, ``sigma``; with a mesh this rank's block of
        the envs, ``shard_batch(..., dim=1)``). Returns the mean over all
        steps of [loss, surrogate, value loss, entropy, kl]; ``self.lr`` is
        the last step's rate and ``self.update_lrs`` each step's."""
        T, n = batch["obs"].shape[:2]
        total = T * self.num_envs if self.mesh is not None else T * n
        mb_size = total // self.minibatches
        flat = {k: v.reshape(T * n, *v.shape[2:]) for k, v in batch.items()}
        rows = self._minibatch_rows(T, n, mb_size)
        params = list(self.model.parameters())
        lr = np.float32(self.lr)
        metrics, self.update_lrs = [], []
        for _ in range(self.epochs):
            for i in range(self.minibatches):
                if rows is None:
                    mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in flat.items()}
                    loss, parts = self._loss(mb)
                else:
                    mb = {k: v.index_select(0, rows[i]) for k, v in flat.items()}
                    loss, parts = self._loss(mb, count=mb_size)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if rows is not None:
                    loss, parts = self._reduce(params, loss, parts)
                if self.adaptive:
                    lr = self._next_lr(lr, parts[3].item())
                clip_by_global_norm_(params, self.max_grad_norm)
                for group in self.optimizer.param_groups:
                    group["lr"] = float(lr)
                self.optimizer.step()
                metrics.append(torch.stack([loss.detach()] + [p.detach() for p in parts]))
                self.update_lrs.append(float(lr))
        self.lr = float(lr)
        return torch.stack(metrics).mean(0)

    def _minibatch_rows(self, T: int, n: int, mb_size: int):
        """With a mesh, per minibatch the rows of this rank's (T * n) flat
        block that fall in the global minibatch, a slice of the global
        (T * N) flattening: row t * N + offset + j holds step t of the
        rank's env j. None without a mesh."""
        if self.mesh is None:
            return None
        if n * self.mesh.size(0) != self.num_envs:
            raise ValueError(f"the batch holds {n} envs; a dp block of {self.num_envs} "
                             f"envs over dp={self.mesh.size(0)} holds "
                             f"{self.num_envs // self.mesh.size(0)}")
        offset = self.mesh.get_local_rank("dp") * n
        g = (torch.arange(T, device=self.device)[:, None] * self.num_envs + offset
             + torch.arange(n, device=self.device)[None, :]).reshape(-1)
        return [torch.nonzero((g >= i * mb_size) & (g < (i + 1) * mb_size))[:, 0]
                for i in range(self.minibatches)]

    def _reduce(self, params, loss, parts):
        """Sum the gradients, the loss and its parts over the dp sub-group
        in one all-reduce; returns the global (loss, parts)."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)] + [x.detach().reshape(1) for x in parts])
        dist.all_reduce(flat, group=self.mesh.get_group("dp"))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset], list(flat[offset + 1:])

    def _batch(self, returns, advantages) -> Dict[str, torch.Tensor]:
        s = self.storage
        dev = _on_device(self.device)
        return {"obs": dev(s.obs), "states": dev(s.states), "actions": dev(s.actions),
                "logprobs": dev(s.logprobs), "values": dev(s.values),
                "returns": returns, "advantages": advantages,
                "mu": dev(s.mu), "sigma": dev(s.sigma)}

    # --- rollout / training loop (reference ppo.py:204-306) ---
    def run(self, num_learning_iterations, log_interval=1, save_interval=None):
        save_interval = save_interval or int(self.learn_cfg.get("save_interval", 25) or 25)
        dev = _on_device(self.device)
        current_obs = np.asarray(self.env.reset(), np.float32)
        current_state = np.asarray(self.env.get_state(), np.float32)

        ep_rewards = np.zeros(self.num_envs, np.float32)
        ep_lengths = np.zeros(self.num_envs, np.int64)
        reward_hist, len_hist = [], []
        info_accum: Dict[str, list] = {}

        start_it = self.current_learning_iteration
        for it in range(start_it, start_it + num_learning_iterations):
            t0 = time.time()
            self.storage.clear()
            for _ in range(self.num_transitions):
                with self.timer.phase("policy"):
                    given = None if self.action_source is None else dev(self.action_source())
                    out = self._act(dev(current_obs), dev(current_state), given)
                    action, logprob, mu, sigma, value = (x.cpu().numpy() for x in out)
                next_obs, rewards, dones, infos = self.env.step(action)
                next_state = np.asarray(self.env.get_state(), np.float32)
                self.storage.add(current_obs, current_state, action,
                                 np.asarray(rewards, np.float32),
                                 np.asarray(dones, np.float32), value, logprob, mu, sigma)
                # per-key episode infos: one dict of batched arrays or a
                # list of per-env dicts (reference ppo.py:366-406)
                if isinstance(infos, dict):
                    for k, v in infos.items():
                        info_accum.setdefault(k, []).append(np.mean(np.asarray(v)))
                elif isinstance(infos, (list, tuple)) and infos and \
                        isinstance(infos[0], dict):
                    for k in infos[0]:
                        vals = [np.asarray(d[k], np.float64) for d in infos if k in d]
                        if vals and all(np.issubdtype(v.dtype, np.number) for v in vals):
                            info_accum.setdefault(k, []).append(
                                float(np.mean([np.mean(v) for v in vals])))
                ep_rewards += np.asarray(rewards, np.float32)
                ep_lengths += 1
                done_mask = np.asarray(dones, bool)
                if done_mask.any():
                    reward_hist.extend(ep_rewards[done_mask].tolist())
                    len_hist.extend(ep_lengths[done_mask].tolist())
                    ep_rewards[done_mask] = 0
                    ep_lengths[done_mask] = 0
                current_obs = np.asarray(next_obs, np.float32)
                current_state = next_state
            collection_time = time.time() - t0

            t1 = time.time()
            with self.timer.phase("learn"):
                with torch.no_grad():
                    last_value = self.model(dev(current_obs), dev(current_state))[2]
                    returns, advantages = compute_gae(
                        dev(self.storage.rewards), dev(self.storage.dones),
                        dev(self.storage.values), last_value, self.gamma, self.lam)
                batch = self._batch(returns, advantages)
                if self.mesh is not None:
                    batch = shard_batch(batch, self.mesh, dim=1)
                metrics = self._update(batch).cpu().numpy()
            learn_time = time.time() - t1
            self.tot_timesteps += self.num_transitions * self.num_envs
            self.history.append({"it": it, "collect_s": collection_time,
                                 "learn_s": learn_time, "metrics": metrics})

            if it % log_interval == 0:
                m = metrics
                fps = self.num_transitions * self.num_envs / max(
                    collection_time + learn_time, 1e-9)
                mean_rew = float(np.mean(reward_hist[-100:])) if reward_hist else 0.0
                mean_len = float(np.mean(len_hist[-100:])) if len_hist else 0.0
                self.log.info(
                    f"it {it}: loss {m[0]:.4f} surr {m[1]:.4f} vloss {m[2]:.4f} "
                    f"kl {m[4]:.4f} lr {self.lr:.2e} rew {mean_rew:.2f} "
                    f"len {mean_len:.1f} fps {fps:.0f} "
                    f"(collect {collection_time:.2f}s learn {learn_time:.2f}s)")
                if self.writer:
                    for tag, v in (("loss", m[0]), ("surrogate", m[1]),
                                   ("value_loss", m[2]), ("entropy", m[3]), ("kl", m[4]),
                                   ("lr", self.lr), ("mean_reward", mean_rew), ("fps", fps)):
                        self.writer.add_scalar(f"ppo/{tag}", v, it)
                    for k, vals in info_accum.items():
                        self.writer.add_scalar(f"ppo_info/{k}", np.mean(vals), it)
                info_accum.clear()

            if (it + 1) % save_interval == 0:
                self.save(os.path.join(self.save_dir, f"model_{it + 1}"))
        self.current_learning_iteration += num_learning_iterations
        self.save(os.path.join(self.save_dir, f"model_{self.current_learning_iteration}"))

    def play(self, num_steps=None):
        """Greedy inference rollout (reference ppo.py:142-151)."""
        num_steps = num_steps or self.num_transitions
        obs = np.asarray(self.env.reset(), np.float32)
        for _ in range(num_steps):
            obs, _, _, _ = self.env.step(self.act_inference(obs))
            obs = np.asarray(obs, np.float32)

    def eval(self, rounds=16):
        """Greedy eval with success accounting (reference ppo.py:153-199)."""
        successes, episodes = 0.0, 0
        obs = np.asarray(self.env.reset(), np.float32)
        for _ in range(rounds):
            while True:
                obs, rew, dones, infos = self.env.step(self.act_inference(obs))
                obs = np.asarray(obs, np.float32)
                if np.asarray(dones).any():
                    break
            if hasattr(self.env, "get_success"):
                successes += float(np.asarray(self.env.get_success()).sum())
            episodes += self.num_envs
        rate = successes / max(episodes, 1)
        self.log.info(f"eval: success {rate * 100:.2f}% over {episodes} episodes")
        return rate

    # --- checkpoints: the JAX package's tree, Adam moments included ---
    def _moments(self):
        """(count, mu, nu) of the Adam state, named as the parameters;
        zeros before the first step."""
        count, mu, nu = 0, {}, {}
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p, {})
            count = int(st["step"]) if "step" in st else count
            mu[name] = st.get("exp_avg", torch.zeros_like(p))
            nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        return count, mu, nu

    def state_tree(self) -> dict:
        """The JAX package's checkpoint tree of this trainer, as
        ``read_msgpack`` gives it back: ``params``, the optax chain's state
        (``clip_by_global_norm``'s empty state, then ``inject_hyperparams(
        adam)``'s, the tuples as maps keyed "0", "1") and ``lr``."""
        named = dict(self.model.named_parameters())
        count, mu, nu = self._moments()
        f32 = np.float32
        hyper = {k: np.asarray(v, f32) for k, v in _ADAM.items()}
        hyper["learning_rate"] = np.asarray(self.lr, f32)
        adam = {"count": np.asarray(count, np.int32),
                "mu": {"params": state_to_flax(self.model, mu)},
                "nu": {"params": state_to_flax(self.model, nu)}}
        inject = {"count": np.asarray(count, np.int32), "hyperparams": hyper,
                  "hyperparams_states": {}, "inner_state": {"0": adam, "1": {}}}
        return {"params": {"params": state_to_flax(self.model, named)},
                "opt_state": {"0": {}, "1": inject}, "lr": float(f32(self.lr))}

    def save(self, path):
        write_msgpack(path + ".ckpt", self.state_tree())
        self.log.info(f"saved checkpoint {path}.ckpt")

    def load(self, path):
        """Restore a checkpoint of either package: the weights, ``lr`` and,
        where the file holds them, the Adam moments and step count. A file
        written before the JAX package saved ``opt_state`` restores weights
        and ``lr`` only, with a warning, as the JAX package's ``load``."""
        self.load_tree(read_msgpack(repo_path(path)), path)
        m = re.search(r"model_(\d+)", os.path.basename(path))
        if m:
            self.current_learning_iteration = int(m.group(1))
        self.log.info(f"loaded {path} (resume at it {self.current_learning_iteration})")

    def load_tree(self, tree: dict, name: str = "checkpoint"):
        """``load`` from a checkpoint tree (``state_tree``'s form)."""
        load_flax_actor_critic(self.model, tree["params"]["params"])
        self.optimizer.state.clear()
        try:
            adam = tree["opt_state"]["1"]["inner_state"]["0"]
            mu = flax_to_state(self.model, adam["mu"]["params"])
            nu = flax_to_state(self.model, adam["nu"]["params"])
            count = float(np.asarray(adam["count"]))
        except (KeyError, TypeError, ValueError):
            self.log.warning(f"{name}: no opt_state in checkpoint; Adam moments reset")
        else:
            for pname, p in self.model.named_parameters():
                self.optimizer.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": torch.from_numpy(mu[pname]).to(p.device),
                    "exp_avg_sq": torch.from_numpy(nu[pname]).to(p.device)}
        self.lr = float(np.float32(tree["lr"]))


def _on_device(device):
    """The function that copies a numpy array to ``device`` as f32."""
    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    return dev
