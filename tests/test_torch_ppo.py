"""The port's PPO policy against the JAX ActorCritic on the committed
policies: the deterministic action (the actor's mean)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.algo.ppo import PPOPolicy
from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.utils.checkpoint import read_msgpack

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICIES = ["ppo_rl_coadapt_model_165.ckpt", "ppo_rl_adapose_model_125.ckpt",
            "ppo_rl_drawer_rl_model_195.ckpt"]


@pytest.mark.parametrize("name", POLICIES)
def test_act_inference_matches_jax(name):
    from rgbmanip_tpu.algo.ppo import ActorCritic

    path = os.path.join(REPO, "checkpoints", name)
    params = read_msgpack(path)["params"]
    obs = np.random.default_rng(0).normal(size=(8, 60)).astype(np.float32)
    mean, std, value = ActorCritic(action_dim=12).apply(params, jnp.asarray(obs))
    policy = PPOPolicy.from_checkpoint(path, load_group("controller", "rl")["policy"],
                                       device="cpu")
    act = policy.act_inference(obs)
    assert act.shape == (8, 12)
    # a 60-96-96-32-12 f32 MLP: the two sides sum in another order
    np.testing.assert_allclose(act, np.asarray(mean), rtol=0, atol=1e-5)
    with torch.no_grad():
        m, s, v = policy.model(torch.from_numpy(obs))
    np.testing.assert_allclose(s.numpy(), np.asarray(std), rtol=1e-6, atol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(value), rtol=0, atol=1e-5)


def test_leftover_leaf_raises():
    from rgbmanip_tpu_torch.algo.ppo import ActorCritic, load_flax_actor_critic

    params = read_msgpack(os.path.join(REPO, "checkpoints", POLICIES[0]))["params"]["params"]
    params["actor"]["Dense_4"] = params["actor"]["Dense_3"]
    with pytest.raises(ValueError):
        load_flax_actor_critic(ActorCritic(60, 12), params)
