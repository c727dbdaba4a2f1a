"""PPO training in the port (``rgbmanip_tpu_torch/algo/ppo.py``) against the
JAX package's (``rgbmanip_tpu/algo/ppo.py``), both on the CPU: GAE, the
Gaussian log-probability and entropy, the 8-epoch x 4-minibatch update with
the adaptive-KL learning rate and optax's global-norm clipping, the
initialisation of a fresh policy, every activation, checkpoints both ways,
and one lock-step iteration of ``train=controller`` through the simulator
and the estimator.

The update starts from the committed ``ppo_rl_coadapt_model_165.ckpt`` with
its Adam state (count 5280), so the first step is not Adam's step 1, where
``m / sqrt(v)`` is +-1 per element and a gradient near 0 flips its sign with
rounding. The committed critic's values reach 40-70, where one f32 ulp is
3.8e-6 to 7.6e-6; the value loss's derivative 2 (value - return) carries
that rounding of each package's value into every critic gradient (1.3e-5
seen, against gradients of 0.04 in the unclipped batch), so the critic is
held more loosely than the actor. Tolerances, each from the largest
difference seen times three to ten:
- gradients of the first minibatch: 2e-6 of the largest gradient (XLA and
  PyTorch sum the 32-row minibatch in other orders), plus 5e-5 for the
  critic;
- the learning rate after every minibatch: equal (both round in f32; the
  batches keep every KL far from the two thresholds);
- parameters after the 32 steps (each moves a parameter by up to one
  learning rate, 2e-4 to 3e-4): actor 2e-6, critic 2e-5;
- Adam's first moments 2e-5 of their largest value (the clipped batch's
  steps divide by a norm that the critic's rounding enters; 6e-6 seen),
  plus 1e-4 for the critic (ten steps' worth of its gradient rounding); second moments 2e-4
  of their largest value; the step count equal;
- the update's mean metrics: 1e-5 relative, plus 5e-6 absolute for the
  value loss's rounding, 2 |value - return| ulp(value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu.algo import ppo as J
from rgbmanip_tpu_torch import repo_path
from rgbmanip_tpu_torch.algo import ppo as P
from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.utils.checkpoint import read_msgpack, write_msgpack
from rgbmanip_tpu_torch.utils.tools import Box
from test_torch_rl_loop import jax_pallas_crop, keep_keys, replay_draws

torch.set_num_threads(2)

CKPT = "checkpoints/ppo_rl_coadapt_model_165.ckpt"
T, N, OBS, STATE, ACT = 16, 8, 60, 75, 12


class Spaces:
    """The control interface's spaces (rl.yaml: max_steps 4) without a
    simulator behind them."""
    num_envs = N
    observation_space = Box(-1.5, 1.5, shape=(OBS,))
    state_space = Box(-1.5, 1.5, shape=(STATE,))
    action_space = Box(-1.5, 1.5, shape=(ACT,))


def rl_cfg(save_dir, **learn):
    cfg = load_group("controller", "rl")
    cfg["learn"].update(save_dir=str(save_dir), **learn)
    return cfg


def trainers(save_dir, load=CKPT):
    jp = J.PPO(Spaces(), rl_cfg(save_dir), seed=0)
    pp = P.PPO(Spaces(), rl_cfg(save_dir), seed=0, device="cpu")
    if load:
        jp.load(load)
        pp.load(load)
    return jp, pp


class Recorder:
    """Wraps the JAX trainer's optax chain: keeps the raw gradients and the
    injected learning rate of every minibatch step as the jitted update
    runs."""

    def __init__(self, tx):
        self.tx, self.grads, self.lrs = tx, [], []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, opt_state, params):
        jax.debug.callback(self.keep, grads, opt_state[1].hyperparams["learning_rate"],
                           ordered=True)
        return self.tx.update(grads, opt_state, params)

    def keep(self, grads, lr):
        self.grads.append(jax.tree.map(np.asarray, grads))
        self.lrs.append(float(lr))


def seeded_batch(jp, clipped: bool):
    """A (16, 8) batch of observations inside the spaces' box, at the JAX
    policy's own action distribution. The old means
    of minibatches 2 and 4 are shifted by 0.3, so their KL exceeds twice
    ``desired_kl`` and the rate falls, while minibatches 1 and 3 start at a
    KL near 0 and the rate rises. ``clipped``: GAE of unit rewards, whose
    value loss puts the gradient norm far above ``max_grad_norm``; else the
    returns stand 0.05 from the values and the advantages are 1e-3, and the
    norm stays below it."""
    rng = np.random.default_rng(1 if clipped else 2)
    obs = rng.uniform(-1, 1, size=(T, N, OBS)).astype(np.float32)
    states = rng.uniform(-1, 1, size=(T, N, STATE)).astype(np.float32)
    mean, std, value = (np.asarray(x) for x in
                        jp.model.apply(jp.params, jnp.asarray(obs), jnp.asarray(states)))
    sigma = np.broadcast_to(std, mean.shape).astype(np.float32).copy()
    mu = mean.copy().reshape(T * N, ACT)
    mu[32:64] += 0.3
    mu[96:128] += 0.3
    mu = mu.reshape(T, N, ACT)
    actions = (mean + std * rng.normal(size=mean.shape)).astype(np.float32)
    logprobs = np.asarray(J.gaussian_logprob(jnp.asarray(mu), jnp.asarray(sigma),
                                             jnp.asarray(actions)))
    if clipped:
        rewards = rng.normal(size=(T, N)).astype(np.float32)
        dones = (rng.random((T, N)) < 0.25).astype(np.float32)
        returns, advs = (np.asarray(x) for x in J.compute_gae(
            jnp.asarray(rewards), jnp.asarray(dones), jnp.asarray(value),
            jnp.asarray(value[-1]), gamma=0.98, lam=0.98))
    else:
        returns = (value + 0.05 * rng.normal(size=(T, N))).astype(np.float32)
        advs = (1e-3 * rng.normal(size=(T, N))).astype(np.float32)
    return {"obs": obs, "states": states, "actions": actions, "logprobs": logprobs,
            "values": value, "returns": returns, "advantages": advs, "mu": mu,
            "sigma": sigma}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def updates(tmp_path_factory):
    """One update of each batch in both packages from the committed
    checkpoint."""
    save_dir = tmp_path_factory.mktemp("ppo")
    jp, _ = trainers(save_dir)
    rec = Recorder(jp.tx)
    jp.tx = rec
    update = jax.jit(jp._update)
    out = {}
    for clipped in (True, False):
        _, pp = trainers(save_dir)
        batch = seeded_batch(jp, clipped)
        rec.grads, rec.lrs = [], []
        jparams, jopt, jlr, jm = update(jp.params, jp.opt_state,
                                        jnp.asarray(jp.lr, jnp.float32),
                                        {k: jnp.asarray(v) for k, v in batch.items()})
        jax.effects_barrier()
        tb = torch_batch(batch)
        # the first minibatch's gradients, before the update
        mb = {k: v.reshape(T * N, *v.shape[2:])[:32] for k, v in tb.items()}
        loss, _ = pp._loss(mb)
        pp.optimizer.zero_grad()
        loss.backward()
        grads0 = {n: p.grad.clone() for n, p in pp.model.named_parameters()}
        pm = pp._update(tb)
        out[clipped] = dict(jax=(jparams, jopt, float(jlr), np.asarray(jm), rec.grads[0],
                                 list(rec.lrs)), port=pp, port_metrics=pm.numpy(),
                            grads0=grads0, batch=batch)
    return out


def as_state(pp, tree):
    return {k: torch.from_numpy(v.copy()) for k, v in P.flax_to_state(pp.model, tree).items()}


def max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def actor_of(tensors):
    """The actor's tensors and ``log_std``."""
    return {k: v for k, v in tensors.items() if not k.startswith("critic.")}


def critic_of(tensors):
    return {k: v for k, v in tensors.items() if k.startswith("critic.")}


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(16, 8)).astype(np.float32)
    dones = (rng.random((16, 8)) < 0.2).astype(np.float32)
    values = rng.normal(size=(16, 8)).astype(np.float32)
    last = rng.normal(size=8).astype(np.float32)
    jr, ja = J.compute_gae(*(jnp.asarray(x) for x in (rewards, dones, values, last)),
                           gamma=0.98, lam=0.98)
    pr, pa = P.compute_gae(*(torch.from_numpy(x) for x in (rewards, dones, values, last)),
                           0.98, 0.98)
    # a 16-step recursion in f32; the normalisation uses the population std
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=2e-6)
    assert abs(float(pa.std(correction=0)) - 1.0) < 1e-5


def test_gaussian_logprob_and_entropy_match_jax():
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(32, ACT)).astype(np.float32)
    std = np.exp(rng.normal(size=ACT) * 0.5).astype(np.float32)
    action = (mean + std * rng.normal(size=mean.shape)).astype(np.float32)
    jl = J.gaussian_logprob(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(action))
    pl = P.gaussian_logprob(*(torch.from_numpy(x) for x in (mean, std, action)))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-5)
    je = J.gaussian_entropy(jnp.asarray(std))
    pe = P.gaussian_entropy(torch.from_numpy(std))
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("clipped", [True, False], ids=["clipped", "unclipped"])
def test_first_minibatch_gradients_match_jax(updates, clipped):
    u = updates[clipped]
    pp, grads = u["port"], u["grads0"]
    ref = as_state(pp, u["jax"][4]["params"])
    scale = max(float(g.abs().max()) for g in ref.values())
    assert max_diff(actor_of(grads), ref) <= 2e-6 * scale
    assert max_diff(critic_of(grads), ref) <= 2e-6 * scale + 5e-5
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    # the regime the case is named for: optax's rule scales by 1/norm at or
    # above max_grad_norm (1.0) only
    assert (norm >= 1.0) == clipped, norm


@pytest.mark.parametrize("clipped", [True, False], ids=["clipped", "unclipped"])
def test_learning_rate_after_every_minibatch_equals_jax(updates, clipped):
    u = updates[clipped]
    jlrs = u["jax"][5]
    assert len(jlrs) == len(u["port"].update_lrs) == 32
    assert u["port"].update_lrs == jlrs
    # the adaptive rate rose and fell within the update
    steps = np.diff([2e-4] + jlrs)
    assert (steps > 0).any() and (steps < 0).any()
    assert u["port"].lr == u["jax"][2]


@pytest.mark.parametrize("clipped", [True, False], ids=["clipped", "unclipped"])
def test_parameters_and_adam_moments_after_the_update_match_jax(updates, clipped):
    u = updates[clipped]
    pp = u["port"]
    jparams, jopt = u["jax"][0], u["jax"][1]
    params = {n: p.detach() for n, p in pp.model.named_parameters()}
    ref = as_state(pp, jparams["params"])
    assert max_diff(actor_of(params), ref) <= 2e-6
    assert max_diff(critic_of(params), ref) <= 2e-5
    adam = jopt[1].inner_state[0]
    count, mu, nu = pp._moments()
    assert count == int(adam.count) == int(jopt[1].count) == 5280 + 32
    mu_j, nu_j = as_state(pp, adam.mu["params"]), as_state(pp, adam.nu["params"])
    mu_scale = max(float(v.abs().max()) for v in mu_j.values())
    assert max_diff(actor_of(mu), mu_j) <= 2e-5 * mu_scale
    assert max_diff(critic_of(mu), mu_j) <= 2e-5 * mu_scale + 1e-4
    assert max_diff(nu, nu_j) <= 2e-4 * max(float(v.abs().max()) for v in nu_j.values())


@pytest.mark.parametrize("clipped", [True, False], ids=["clipped", "unclipped"])
def test_update_metrics_match_jax(updates, clipped):
    u = updates[clipped]
    np.testing.assert_allclose(u["port_metrics"], u["jax"][3], rtol=1e-5, atol=5e-6)


def orthogonal_ok(w, gain):
    """flax's orthogonal init of a (in, out) kernel: orthonormal columns
    when in >= out, rows otherwise, times the gain; ``w`` is the kernel."""
    k = np.asarray(w, np.float64)
    g = k.T @ k if k.shape[0] >= k.shape[1] else k @ k.T
    return np.abs(g - gain ** 2 * np.eye(len(g))).max() <= 1e-5 * max(1.0, gain ** 2)


def test_a_fresh_policy_is_drawn_as_flax_draws_it(tmp_path):
    jp = J.PPO(Spaces(), rl_cfg(tmp_path), seed=4)
    pp = P.PPO(Spaces(), rl_cfg(tmp_path), seed=4, device="cpu")
    for name, tree in (("jax", jp.params["params"]),
                       ("port", P.state_to_flax(pp.model, dict(pp.model.named_parameters())))):
        for net, out_gain in (("actor", 0.01), ("critic", 1.0)):
            layers = sorted(tree[net])
            assert layers == [f"Dense_{i}" for i in range(4)], (name, layers)
            for i, layer in enumerate(layers):
                gain = out_gain if i == len(layers) - 1 else np.sqrt(2.0)
                assert orthogonal_ok(tree[net][layer]["kernel"], gain), (name, net, layer)
                assert not np.asarray(tree[net][layer]["bias"]).any(), (name, net, layer)
        np.testing.assert_array_equal(np.asarray(tree["log_std"]),
                                      np.full(ACT, np.log(0.6), np.float32))
    # the draws come from the seed alone
    again = P.PPO(Spaces(), rl_cfg(tmp_path), seed=4, device="cpu").model.state_dict()
    other = P.PPO(Spaces(), rl_cfg(tmp_path), seed=5, device="cpu").model.state_dict()
    mine = pp.model.state_dict()
    assert all(torch.equal(mine[k], again[k]) for k in mine)
    assert not torch.equal(mine["actor.0.weight"], other["actor.0.weight"])


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "selu", "gelu", "swish"])
def test_every_activation_matches_flax(activation):
    model = J.ActorCritic(action_dim=ACT, activation=activation)
    rng = np.random.default_rng(5)
    obs = (2.0 * rng.normal(size=(16, OBS))).astype(np.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS)))
    mean, std, value = model.apply(params, jnp.asarray(obs))
    port = P.ActorCritic(OBS, ACT, activation=activation)
    P.load_flax_actor_critic(port, params["params"])
    with torch.no_grad():
        m, s, v = port(torch.from_numpy(obs))
    np.testing.assert_allclose(m.numpy(), np.asarray(mean), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(value), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(std), rtol=1e-6, atol=0)
    # and the function itself, over the range the layers see
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    ref = np.asarray(J.get_activation(activation)(jnp.asarray(x)))
    with torch.no_grad():
        got = P.get_activation(activation)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_the_asymmetric_critic_reads_the_state():
    model = J.ActorCritic(action_dim=ACT, asymmetric=True)
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(8, OBS)).astype(np.float32)
    state = rng.normal(size=(8, STATE)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, OBS)), jnp.zeros((1, STATE)))
    _, _, value = model.apply(params, jnp.asarray(obs), jnp.asarray(state))
    port = P.ActorCritic(OBS, ACT, state_dim=STATE, asymmetric=True)
    P.load_flax_actor_critic(port, params["params"])
    assert port.critic[0].in_features == STATE
    with torch.no_grad():
        _, _, v = port(torch.from_numpy(obs), torch.from_numpy(state))
    np.testing.assert_allclose(v.numpy(), np.asarray(value), rtol=0, atol=1e-5)


def warnings_of(log):
    seen = []
    log.warning = lambda msg, *a, **k: seen.append(str(msg))
    return seen


def test_the_ports_checkpoint_restores_in_jax_with_its_adam_moments(updates, tmp_path):
    pp = updates[True]["port"]
    pp.save(str(tmp_path / "model_166"))
    jp = J.PPO(Spaces(), rl_cfg(tmp_path), seed=9)
    seen = warnings_of(jp.log)
    jp.load(str(tmp_path / "model_166.ckpt"))
    assert not [w for w in seen if "Adam moments reset" in w], seen
    assert jp.current_learning_iteration == 166
    params = {n: p.detach() for n, p in pp.model.named_parameters()}
    assert max_diff(params, as_state(pp, jp.params["params"])) == 0.0
    adam = jp.opt_state[1].inner_state[0]
    count, mu, nu = pp._moments()
    assert int(adam.count) == int(jp.opt_state[1].count) == count
    assert max_diff(mu, as_state(pp, adam.mu["params"])) == 0.0
    assert max_diff(nu, as_state(pp, adam.nu["params"])) == 0.0
    assert jp.lr == pp.lr
    assert float(jp.opt_state[1].hyperparams["learning_rate"]) == pp.lr


def test_the_jax_checkpoint_restores_in_the_port_with_its_adam_moments(updates, tmp_path):
    jparams, jopt, jlr = updates[True]["jax"][:3]
    jp = J.PPO(Spaces(), rl_cfg(tmp_path), seed=9)
    jp.params, jp.opt_state, jp.lr = jparams, jopt, jlr
    jp.save(str(tmp_path / "model_166"))
    pp = P.PPO(Spaces(), rl_cfg(tmp_path), seed=9, device="cpu")
    seen = warnings_of(pp.log)
    pp.load(str(tmp_path / "model_166.ckpt"))
    assert not seen
    assert pp.current_learning_iteration == 166 and pp.lr == jlr
    params = {n: p.detach() for n, p in pp.model.named_parameters()}
    assert max_diff(params, as_state(pp, jparams["params"])) == 0.0
    adam = jopt[1].inner_state[0]
    count, mu, nu = pp._moments()
    assert count == int(adam.count)
    assert max_diff(mu, as_state(pp, adam.mu["params"])) == 0.0
    assert max_diff(nu, as_state(pp, adam.nu["params"])) == 0.0
    # and the port writes back the file the JAX package wrote, byte for byte
    pp.save(str(tmp_path / "again"))
    assert (tmp_path / "again.ckpt").read_bytes() == (tmp_path / "model_166.ckpt").read_bytes()


def test_a_checkpoint_without_opt_state_warns_and_resets_the_moments(tmp_path):
    tree = read_msgpack(repo_path(CKPT))
    path = str(tmp_path / "model_40.ckpt")
    write_msgpack(path, {"params": tree["params"], "lr": tree["lr"]})
    for trainer in (J.PPO(Spaces(), rl_cfg(tmp_path), seed=0),
                    P.PPO(Spaces(), rl_cfg(tmp_path), seed=0, device="cpu")):
        seen = warnings_of(trainer.log)
        trainer.load(path)
        assert any("Adam moments reset" in w for w in seen), seen
        assert trainer.current_learning_iteration == 40
        assert float(trainer.lr) == float(np.float32(tree["lr"]))
    assert trainer._moments()[0] == 0
    ref = P.flax_to_state(trainer.model, tree["params"]["params"])
    assert all(np.array_equal(p.detach().numpy(), ref[n])
               for n, p in trainer.model.named_parameters())


# ---------------------------------------------------------------- lock-step --
LOCK_ENVS, LOCK_T = 2, 4


def controller_run(tmp):
    """``train=controller`` on the flagship stack, resumed from the committed
    policy: one iteration of 4 transitions at 2 envs (one episode)."""
    return ["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
            "controller=rl", f"controller.load={CKPT}",
            "pose_estimator=adapose_cabinet_fast",
            "pose_estimator.checkpoint_path=checkpoints/estimator_fast_cabinet_aug_r5.ckpt",
            "train=controller", "train.iterations_per_epoch=1",
            f"task.num_envs={LOCK_ENVS}", "seed=11",
            f"controller.learn.num_transitions_per_env={LOCK_T}",
            f"controller.learn.save_dir={tmp}"]


def train_one_iteration(pkg, cfg, log, drive=None, **kw):
    """One PPO iteration through ``pkg``'s ``prepare_*`` functions, recorded
    step by step. With ``drive`` (the JAX run's record) the port takes the
    JAX run's actions (``PPO.action_source``) and estimator draws, and its
    storage takes the JAX run's rewards, while the record keeps its own."""
    rec = {"rewards": [], "terms": [], "views": [], "keys": []}
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = pkg.prepare_manipulation(env, cfg["manipulation"], log)
        est = pkg.prepare_pose_estimator(env, cfg["pose_estimator"], log, **kw)
        ctrl = pkg.prepare_controller(env, est, manip, cfg["controller"], cfg, log, **kw)
        iface, ppo = ctrl.control_interface, ctrl.controller
        if drive is None:
            keep_keys(est, rec["keys"])
        else:
            replay_draws(est, drive["keys"])
            actions = iter(drive["storage"]["actions"])
            ppo.action_source = lambda: next(actions)
        step = iface.step

        def rec_step(action, eval=False):
            obs, reward, done, info = step(action, eval=eval)
            rec["rewards"].append(np.array(reward))
            rec["terms"].append({k: np.array(v) for k, v in info.items()})
            rec["views"].append(iface.available.sum(0).copy())
            if drive is not None:
                reward = drive["rewards"][len(rec["rewards"]) - 1]
            return obs, reward, done, info
        iface.step = rec_step
        ctrl.train_controller(int(cfg["train"]["iterations_per_epoch"]))
        s = ppo.storage
        rec["storage"] = {k: getattr(s, k).copy() for k in (
            "obs", "states", "actions", "rewards", "dones", "values", "logprobs", "mu",
            "sigma")}
        rec["ppo"] = ppo
    finally:
        env.close()
    return rec


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    from rgbmanip_tpu import train as jax_train
    from rgbmanip_tpu.config import load_config as jax_load_config
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
    from rgbmanip_tpu_torch import train as port_train
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.utils.logger import get_logger

    jdir, pdir = tmp_path_factory.mktemp("jax_ppo"), tmp_path_factory.mktemp("port_ppo")
    orig = StereoPoseNetWithDepth.init

    def jitted(self, rngs, *args, **kw):   # the same weights, traced once
        return jax.jit(lambda r, *a: orig(self, r, *a, **kw))(rngs, *args)
    StereoPoseNetWithDepth.init = jitted
    try:
        with jax_pallas_crop():
            ref = train_one_iteration(jax_train, jax_load_config(controller_run(jdir)),
                                      jax_get_logger())
    finally:
        StereoPoseNetWithDepth.init = orig
    out = train_one_iteration(port_train, load_config(controller_run(pdir) + ["device=cpu"]),
                              get_logger(), drive=ref, device="cpu")
    return ref, out, jdir, pdir


def test_one_training_iteration_runs_lock_step_with_jax(lockstep):
    """The storage: observations, states and dones bit for bit (the
    simulator is bit-equal and the port moves by the JAX actions), the
    policy's means, values and log-probabilities at those actions within
    f32 rounding (values near 60: 1e-4), the rewards within 1e-4 where every
    env's estimate came from two views and each term that does not read the
    estimate within 1e-4 (tests/test_torch_rl_loop.py: duplicated views make
    the two packages' estimates part by centimetres)."""
    ref, out, _, _ = lockstep
    js, ps = ref["storage"], out["storage"]
    assert len(out["rewards"]) == len(ref["rewards"]) == LOCK_T
    for k in ("obs", "states", "dones", "actions"):
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)
    assert ps["dones"][-1].all() and not ps["dones"][:-1].any()
    np.testing.assert_allclose(ps["mu"], js["mu"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ps["sigma"], js["sigma"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(ps["values"], js["values"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps["logprobs"], js["logprobs"], rtol=0, atol=1e-4)
    for t, (tp, tj) in enumerate(zip(out["terms"], ref["terms"])):
        for k in tj:
            if k.startswith("REW:") and k not in ("REW:center_rew", "REW:open_rew"):
                assert np.abs(tp[k] - tj[k]).max() <= 1e-4, (t + 1, k)
    two_views = np.stack(ref["views"]) >= 2
    np.testing.assert_array_equal(np.stack(out["views"]), np.stack(ref["views"]))
    assert two_views.sum() >= 2, "too few two-view estimates to compare"
    diff = np.abs(np.stack(out["rewards"]) - np.stack(ref["rewards"]))
    print("max |reward diff| on two-view estimates:", diff[two_views].max())
    assert diff[two_views].max() <= 1e-4


def test_the_iterations_update_and_checkpoint_match_jax(lockstep):
    """After the update on the same batch (the JAX rewards), the parameters
    as in the update tests above (actor 2e-6, critic 2e-5), the learning
    rate equal, and ``model_166.ckpt`` written by each package into its
    ``save_dir``, the port's read back by the JAX package with its Adam
    moments."""
    ref, out, jdir, pdir = lockstep
    jp, pp = ref["ppo"], out["ppo"]
    params = {n: p.detach() for n, p in pp.model.named_parameters()}
    ref_params = as_state(pp, jp.params["params"])
    assert max_diff(actor_of(params), ref_params) <= 2e-6
    assert max_diff(critic_of(params), ref_params) <= 2e-5
    assert pp.lr == float(jp.lr)
    assert pp.current_learning_iteration == jp.current_learning_iteration == 166
    assert (jdir / "model_166.ckpt").exists() and (pdir / "model_166.ckpt").exists()
    back = J.PPO(Spaces(), rl_cfg(jdir), seed=0)
    seen = warnings_of(back.log)
    back.load(str(pdir / "model_166.ckpt"))
    assert not seen
    assert max_diff(params, as_state(pp, back.params["params"])) == 0.0


def test_the_checkpoint_writer_writes_flax_bytes(tmp_path):
    """``to_msgpack`` writes what ``flax.serialization.to_bytes`` writes
    (arrays, 0-d arrays, numpy scalars, tuples as "0", "1" maps, empty maps,
    Python numbers and strings), and the reader reads a numpy scalar back
    (flax packs it as ext 3 of (shape, dtype, buffer))."""
    from flax import serialization

    from rgbmanip_tpu_torch.utils.checkpoint import to_msgpack

    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "count": np.asarray(3, np.int32)},
            "empty": {}, "pair": (np.float32(1.5), [np.zeros(2), {}]), "lr": 2e-4,
            "meta": "{}"}
    assert to_msgpack(tree) == serialization.to_bytes(tree)
    path = tmp_path / "t.ckpt"
    path.write_bytes(serialization.to_bytes(tree))
    back = read_msgpack(str(path))
    assert back["pair"]["0"] == np.float32(1.5) and back["pair"]["0"].dtype == np.float32
    assert back["a"]["count"].shape == () and int(back["a"]["count"]) == 3
    assert back["empty"] == {} and back["lr"] == 2e-4 and back["meta"] == "{}"
    # the committed checkpoints read and write back byte for byte
    for name in ("ppo_rl_coadapt_model_165.ckpt", "estimator_fast_cabinet_aug_r5.ckpt"):
        raw = open(repo_path(f"checkpoints/{name}"), "rb").read()
        assert to_msgpack(read_msgpack(repo_path(f"checkpoints/{name}"))) == raw


def test_train_controller_through_main_writes_checkpoint_and_profile(tmp_path, monkeypatch):
    """``python -m rgbmanip_tpu_torch.train ... train=controller device=cpu``
    at 2 envs and 4 transitions: one iteration from the committed policy
    writes ``model_166.ckpt``, and ``RGBMANIP_PROFILE`` a trace holding the
    rollout's ``policy`` and ``estimate`` ranges and the update's ``learn``,
    and the spans' summary, the estimate's stages inside its phase."""
    import json

    from rgbmanip_tpu_torch import train as port_train

    monkeypatch.setenv("RGBMANIP_PROFILE", str(tmp_path / "profile"))
    over = controller_run(tmp_path / "ckpt") + [
        "device=cpu", f"train.save_dir={tmp_path}", f"train.log_dir={tmp_path}"]
    assert port_train.main(over) is None
    assert (tmp_path / "ckpt" / "model_166.ckpt").exists()
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"policy", "estimate", "learn"} <= names
    with open(tmp_path / "profile" / "spans.json") as f:
        spans = json.load(f)
    stages = {"adapose/estimate", "adapose/preprocess", "stereo/backbone", "stereo/warp",
              "stereo/cost_reg", "stereo/heads", "adapose/solve", "adapose/readback"}
    assert {"policy", "estimate", "learn"} | stages <= set(spans) <= names
    assert spans["adapose/estimate"]["calls"] == spans["adapose/solve"]["calls"] >= 1
