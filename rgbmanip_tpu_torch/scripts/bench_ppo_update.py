"""The PPO update alone at ``BASELINE.json``'s shape (T=16, N=64, 93
observations, 7 actions): 8 epochs x 4 minibatches with the adaptive-KL
learning rate (counterpart of the JAX package's
``scripts/bench_ppo_update.py``).

    python -m rgbmanip_tpu_torch.scripts.bench_ppo_update [--iters 4] [--reps 3]

It times ``PPO._update(batch)`` of ``algo/ppo.py``, the update the trainer
runs: 32 optimizer steps, each with one ``.item()`` for the adaptive rate,
which is part of its cost. The batch's keys are the JAX script's, drawn
from a seeded generator on the card (``sigma`` ones). The update changes
the weights and Adam's state in place, so each call starts from the state
the last one left, as the JAX script's scan chains its iterations. Timing
is ``perfutil.bench``'s (CUDA events, a fresh copy of ``obs`` per rep).
Prints ms per update and transitions per second, then the same two numbers
as one JSON object on the last line. Without a card it raises.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..algo.ppo import PPO
from ..utils.tools import Box
from . import perfutil

T, N, OBS, ACT = 16, 64, 93, 7
CFG = {
    "learn": {"num_transitions_per_env": T, "num_learning_epochs": 8,
              "num_mini_batches": 4, "clip_range": 0.2, "gamma": 0.98,
              "lam": 0.98, "init_noise_std": 1.0, "value_loss_coef": 1.0,
              "entropy_coef": 0.0, "learning_rate": 3e-4,
              "max_grad_norm": 1.0, "desired_kl": 0.008,
              "schedule": "adaptive", "save_dir": "saves/ppo_bench"},
    "policy": {"pi_hid_sizes": [96, 96, 32], "vf_hid_sizes": [96, 96, 32],
               "activation": "elu"},
}
SHAPES = {"obs": (T, N, OBS), "states": (T, N, OBS), "actions": (T, N, ACT),
          "logprobs": (T, N), "values": (T, N), "returns": (T, N),
          "advantages": (T, N), "mu": (T, N, ACT)}


class FakeEnv:
    """The spaces of an N-env batch without a simulator behind them."""
    num_envs = N
    observation_space = Box(-1.0, 1.0, shape=(OBS,))
    state_space = Box(-1.0, 1.0, shape=(OBS,))
    action_space = Box(-1.0, 1.0, shape=(ACT,))


def make_batch(seed: int, device) -> dict:
    """The JAX script's batch: every key standard normal, from a generator
    on ``device`` seeded with ``seed``, and ``sigma`` ones."""
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {k: torch.randn(s, generator=g, device=device) for k, s in SHAPES.items()}
    batch["sigma"] = torch.ones(T, N, ACT, device=device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = perfutil.require_card("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(perfutil.card_line(), flush=True)
    ppo = PPO(FakeEnv(), CFG, seed=0, device=dev)
    batch = make_batch(0, dev)

    def one_update(obs):
        return ppo._update({**batch, "obs": obs})

    ms = perfutil.bench(one_update, batch["obs"], iters=args.iters, reps=args.reps)
    steps = T * N
    print(f"PPO update (T={T}, N={N}, 8 epochs x 4 mb): {ms:7.2f} ms "
          f"-> {steps/ms*1e3:9.0f} transitions/s update throughput", flush=True)
    out = {"ms": ms, "transitions_per_s": steps / ms * 1e3}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
