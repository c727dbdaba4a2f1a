"""``RLManipulation`` in the port (``rgbmanip_tpu_torch/models/manipulation/
rl.py``: ``FlatEnvAdapter`` and PPO on the env's joint-space actions)
against the JAX package's, both on the CPU, on ``open_cabinet`` at 2 envs.

Neither package's config tree has a manipulation group with the ``learn``
and ``policy`` blocks that ``PPO`` reads; both take those of
``controller/rl.yaml`` as overrides (``MANIP_RL``).

- ``FlatEnvAdapter``: the spaces (obs 41, state 42, action 8) and the flat
  observation and state after a reset, equal.
- One lock-step iteration of 2 transitions: the port starts from the JAX
  policy's initial weights (the two packages draw a fresh policy from
  different generators) and takes the JAX run's actions
  (``PPO.action_source``). Its storage equals the JAX run's (the simulator
  is bit-equal); the policy's means, values and log-probabilities at those
  actions within f32 rounding; after the update the parameters and Adam's
  moments within the bounds of tests/test_torch_ppo_train.py (actor 2e-6,
  critic 2e-5; first moments 2e-5 of their largest, plus 1e-4 for the
  critic; second moments 2e-4 of their largest) and the step count and
  learning rate equal.
- ``train.train_manipulation=true`` through ``main`` trains the skill for
  one iteration and writes its checkpoint.
"""

import json

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.config.loader import load_group

torch.set_num_threads(2)

N_ENVS, T_STEPS = 2, 2
RL = load_group("controller", "rl")


def manip_rl(save_dir, T=T_STEPS):
    """The overrides that make ``manipulation=rl`` with the learn and policy
    blocks of ``controller/rl.yaml``."""
    learn = dict(RL["learn"], num_transitions_per_env=T, save_dir=str(save_dir))
    return ["manipulation.name=rl", f"manipulation.learn={json.dumps(learn)}",
            f"manipulation.policy={json.dumps(RL['policy'])}"]


def run_args(save_dir):
    return ["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
            f"task.num_envs={N_ENVS}", "seed=11"] + manip_rl(save_dir)


def build(pkg, cfg, log, **kw):
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    return env, pkg.prepare_manipulation(env, cfg["manipulation"], log, **kw)


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    import jax

    from rgbmanip_tpu import train as jax_train
    from rgbmanip_tpu.config import load_config as jax_load_config
    from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
    from rgbmanip_tpu_torch import train as port_train
    from rgbmanip_tpu_torch.algo.ppo import load_flax_actor_critic
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.utils.logger import get_logger

    jdir, pdir = tmp_path_factory.mktemp("jax_rl"), tmp_path_factory.mktemp("port_rl")
    out = {}
    jenv, jm = build(jax_train, jax_load_config(run_args(jdir)), jax_get_logger())
    try:
        out["jax_flat"] = (jm.adapter.reset(), jm.adapter.get_state())
        jp = jm.algo
        init = jax.tree_util.tree_map(np.asarray, jp.params["params"])
        jm.learn(1)
    finally:
        jenv.close()
    penv, pm = build(port_train, load_config(run_args(pdir) + ["device=cpu"]), get_logger(),
                     device="cpu")
    try:
        out["port_flat"] = (pm.adapter.reset(), pm.adapter.get_state())
        pp = pm.algo
        load_flax_actor_critic(pp.model, init)
        actions = iter(jp.storage.actions.copy())
        pp.action_source = lambda: next(actions)
        pm.learn(1)
    finally:
        penv.close()
    out.update(jax=(jm, jp), port=(pm, pp), dirs=(jdir, pdir))
    return out


def test_the_flat_env_adapter_matches_jax(lockstep):
    (jm, _), (pm, _) = lockstep["jax"], lockstep["port"]
    ja, pa = jm.adapter, pm.adapter
    assert ja.observation_space.shape == pa.observation_space.shape == (41,)
    assert ja.state_space.shape == pa.state_space.shape == (42,)
    assert ja.action_space.shape == pa.action_space.shape == (8,)
    assert ja.obs_keys == pa.obs_keys and ja.state_keys == pa.state_keys
    for j, p in zip(lockstep["jax_flat"], lockstep["port_flat"]):
        assert p.dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p, j)


def test_one_iteration_runs_lock_step_with_jax(lockstep):
    (_, jp), (_, pp) = lockstep["jax"], lockstep["port"]
    js, ps = jp.storage, pp.storage
    for k in ("obs", "states", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k), err_msg=k)
    np.testing.assert_allclose(ps.mu, js.mu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ps.sigma, js.sigma, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ps.values, js.values, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.logprobs, js.logprobs, rtol=0, atol=1e-4)


def test_the_update_matches_jax(lockstep):
    from test_torch_ppo_train import actor_of, as_state, critic_of, max_diff

    (_, jp), (_, pp) = lockstep["jax"], lockstep["port"]
    params = {n: p.detach() for n, p in pp.model.named_parameters()}
    ref = as_state(pp, jp.params["params"])
    assert max_diff(actor_of(params), ref) <= 2e-6
    assert max_diff(critic_of(params), ref) <= 2e-5
    adam = jp.opt_state[1].inner_state[0]
    count, mu, nu = pp._moments()
    assert count == int(adam.count) == 8 * 4
    mu_j, nu_j = as_state(pp, adam.mu["params"]), as_state(pp, adam.nu["params"])
    mu_scale = max(float(v.abs().max()) for v in mu_j.values())
    assert max_diff(actor_of(mu), mu_j) <= 2e-5 * mu_scale
    assert max_diff(critic_of(mu), mu_j) <= 2e-5 * mu_scale + 1e-4
    assert max_diff(nu, nu_j) <= 2e-4 * max(float(v.abs().max()) for v in nu_j.values())
    assert pp.lr == float(np.float32(jp.lr))
    jdir, pdir = lockstep["dirs"]
    assert (jdir / "model_1.ckpt").exists() and (pdir / "model_1.ckpt").exists()


def test_train_manipulation_runs_through_main(tmp_path):
    """``train=controller train.train_controller=false
    train.train_manipulation=true``: one PPO iteration of the skill (2 envs
    x 2 transitions), its checkpoint written; then ``train=test`` plays it
    (the skill's ``plan_pathway`` is a greedy rollout)."""
    from rgbmanip_tpu_torch.train import main

    args = run_args(tmp_path / "ckpt") + [
        "train=controller", "train.train_controller=false",
        "train.train_manipulation=true", "train.iterations_per_epoch=1",
        f"train.log_dir={tmp_path / 'logs'}", f"train.save_dir={tmp_path / 'saves'}",
        "device=cpu"]
    assert main(args) is None
    assert (tmp_path / "ckpt" / "model_1.ckpt").exists()
    res = main(run_args(tmp_path / "ckpt") + [
        "train=test", "train.total_round=2", f"train.log_dir={tmp_path / 'logs'}",
        f"train.save_dir={tmp_path / 'saves'}", "device=cpu"])
    assert res["rounds"] == 2 and 0.0 <= res["success_rate"] <= 100.0
