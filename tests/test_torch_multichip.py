"""Sharded training in the port (``PPO(..., mesh=...)``,
``EstimatorTrainer(..., mesh=...)``, ``graft_entry.dryrun_multichip``) on
four ``gloo`` ranks of the CPU, against the port's own single-process steps
and the JAX package's sharded steps on its virtual devices.

- (a) The PPO update at dp=4 (``tests/test_multichip.py``'s setup: T=4,
  N=8, obs 12) from the JAX package's seeded policy equals the port's
  unsharded update at 1e-5, and the JAX package's dp-sharded update at
  ``tests/test_torch_ppo_train.py``'s tolerances (metrics 1e-5 relative
  plus 5e-6; parameters: actor 2e-6, critic 2e-5). A second case takes 3
  minibatches of T=4 steps x 8 envs over 2 epochs with the adaptive rate:
  each global minibatch (10 rows of the 32) holds 2 to 4 rows of each rank,
  so the ranks' shares are unequal.
- (b) One estimator step at dp=2, tp=2 (B=4, S=32, N=64, D=8, resnet18 at
  the JAX module's defaults) equals the port's step on the whole batch in
  one process: the loss and its parts at 1e-5 relative, the BatchNorm
  running statistics (taken over the whole dp batch) at 1e-4 relative plus
  1e-5, the parameters per element within two learning rates and rounding
  (2.1 lr: Adam's first step moves each by +-lr, and an element whose
  gradient is near 0 may take either sign;
  ``tests/test_torch_estimator_train.py``). The JAX package's sharded step
  on the same weights and batch gives the same loss at 1e-5 relative.
- (c) ``dryrun_multichip(4, device="cpu")`` runs whole, the production-shape
  step included, and its estimator loss and PPO metrics equal the same
  steps run unsharded in one process.

The ranks import this module by name (``torch.multiprocessing``'s spawn),
so the JAX package is imported inside the fixtures, not at the top.
"""

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch import graft_entry
from rgbmanip_tpu_torch.algo import ppo as P
from rgbmanip_tpu_torch.models.pose_estimator.converter import to_jax_params
from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import (FlaxBatchNorm3d,
                                                                  StereoPoseNetWithDepth,
                                                                  flax_init_)
from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer, synthetic_batch
from rgbmanip_tpu_torch.parallel.launch import run_ranks
from rgbmanip_tpu_torch.parallel.mesh import (apply_shardings, full_parameters, make_mesh,
                                              param_shardings, shard_batch)
from rgbmanip_tpu_torch.utils.tools import Box

torch.set_num_threads(2)

WORLD = 4
T, N, OBS, ACT = 4, 8, 12, 4
LR = 1e-4
B, S, N_PTS, D = 4, 32, 64, 8
KNOBS = dict(backend="resnet18", backbone_stride=8, volume_scale=1, warp_mode="bilinear")
LEARN = {"num_transitions_per_env": T, "num_learning_epochs": 1, "num_mini_batches": 1,
         "clip_range": 0.2, "gamma": 0.98, "lam": 0.98, "init_noise_std": 0.6,
         "value_loss_coef": 1.0, "entropy_coef": 0.0, "learning_rate": 1e-3,
         "max_grad_norm": 1.0, "use_clipped_value_loss": True, "schedule": "fixed",
         "desired_kl": 0.016, "max_lr": 5e-3, "min_lr": 2e-4}
CASES = {"divides": {},
         "does_not_divide": {"num_mini_batches": 3, "num_learning_epochs": 2,
                             "schedule": "adaptive"}}


class Spaces:
    num_envs = N
    observation_space = Box(-1, 1, shape=(OBS,))
    state_space = Box(-1, 1, shape=(OBS,))
    action_space = Box(-1, 1, shape=(ACT,))


def ppo_cfg(case):
    return {"policy": {"pi_hid_sizes": [16], "vf_hid_sizes": [16], "activation": "elu"},
            "learn": dict(LEARN, **CASES[case])}


def ppo_batch():
    """tests/test_multichip.py's rollout."""
    rng = np.random.default_rng(0)
    return {
        "obs": rng.normal(size=(T, N, OBS)).astype(np.float32),
        "states": rng.normal(size=(T, N, OBS)).astype(np.float32),
        "actions": rng.normal(size=(T, N, ACT)).astype(np.float32),
        "logprobs": rng.normal(size=(T, N)).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "returns": rng.normal(size=(T, N)).astype(np.float32),
        "advantages": rng.normal(size=(T, N)).astype(np.float32),
        "mu": rng.normal(size=(T, N, ACT)).astype(np.float32),
        "sigma": (np.abs(rng.normal(size=(T, N, ACT))) + 0.5).astype(np.float32),
    }


def port_update(case, state, mesh=None):
    """(metrics, parameters) of the port's update from ``state``."""
    pp = P.PPO(Spaces(), ppo_cfg(case), seed=0, device="cpu", mesh=mesh)
    pp.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    batch = {k: torch.from_numpy(v) for k, v in ppo_batch().items()}
    if mesh is not None:
        batch = shard_batch(batch, mesh, dim=1)
    metrics = pp._update(batch)
    return metrics, {k: v.detach().clone() for k, v in pp.model.state_dict().items()}


def estimator():
    model = StereoPoseNetWithDepth(regress_pose=True, **KNOBS)
    return flax_init_(model, torch.Generator().manual_seed(0))


def estimator_step(mesh=None):
    """(total, parts, BatchNorm running statistics, parameters) after one
    step on the seeded batch (this rank's block of it with a mesh)."""
    model = estimator()
    batch = synthetic_batch(torch.Generator().manual_seed(0), B, S, N_PTS, n_depth=D)
    if mesh is not None:
        apply_shardings(model, param_shardings(model, mesh))
        batch = shard_batch(batch, mesh)
    total, parts = EstimatorTrainer(model, lr=LR, mesh=mesh).step(batch)
    stats = {f"{n}.{b}": getattr(m, b).clone() for n, m in model.named_modules()
             if isinstance(m, FlaxBatchNorm3d) for b in ("running_mean", "running_var")}
    params = {n: p.detach().clone() for n, p in full_parameters(model).items()}
    return total, parts, stats, params


def sharded_rank(rank, world, states):
    out = {"ppo": {}}
    mesh = make_mesh(world, tp=1)
    for case in CASES:
        out["ppo"][case] = port_update(case, states[case], mesh)
    out["estimator"] = estimator_step(make_mesh(world, tp=2))
    return out


@pytest.fixture(scope="module")
def ppo_jax(tmp_path_factory):
    """Per case the JAX package's seeded policy as the port's state, and
    the JAX package's update at dp=4 on tests/test_multichip.py's
    sharding."""
    import jax
    import jax.numpy as jnp

    from rgbmanip_tpu.algo.ppo import PPO as JaxPPO
    from rgbmanip_tpu.parallel.mesh import make_mesh as jax_make_mesh

    sharding = jax.sharding.NamedSharding(jax_make_mesh(WORLD, tp=1),
                                          jax.sharding.PartitionSpec(None, "dp"))
    out = {}
    for case in CASES:
        cfg = ppo_cfg(case)
        cfg["learn"]["save_dir"] = str(tmp_path_factory.mktemp("ppo"))   # made at init
        jp = JaxPPO(Spaces(), cfg, seed=0)
        state = P.flax_to_state(P.PPO(Spaces(), ppo_cfg(case), device="cpu").model,
                                jp.params["params"])
        batch = {k: jax.device_put(jnp.asarray(v), sharding) for k, v in ppo_batch().items()}
        params, _, _, metrics = jp._update_fn(jp.params, jp.opt_state,
                                              jnp.float32(jp.lr), batch)
        out[case] = (state, np.asarray(metrics), jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def sharded(ppo_jax):
    return run_ranks(sharded_rank, WORLD, "cpu", {c: v[0] for c, v in ppo_jax.items()})


@pytest.mark.parametrize("case", CASES)
def test_sharded_ppo_update_equals_the_unsharded_update(sharded, ppo_jax, case):
    metrics, params = port_update(case, ppo_jax[case][0])
    for out in sharded:
        m, p = out["ppo"][case]
        np.testing.assert_allclose(m.numpy(), metrics.detach().numpy(), rtol=0, atol=1e-5)
        for k in params:
            np.testing.assert_allclose(p[k].numpy(), params[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_sharded_ppo_update_equals_the_jax_sharded_update(sharded, ppo_jax, case):
    _, jmetrics, jparams = ppo_jax[case]
    m, p = sharded[0]["ppo"][case]
    np.testing.assert_allclose(m.numpy(), jmetrics, rtol=1e-5, atol=5e-6)
    model = P.PPO(Spaces(), ppo_cfg(case), device="cpu").model
    ref = P.flax_to_state(model, jparams["params"])
    for k, v in ref.items():
        tol = 2e-5 if k.startswith("critic.") else 2e-6
        np.testing.assert_allclose(p[k].numpy(), v, rtol=0, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def single():
    return estimator_step()


def test_sharded_estimator_step_loss_equals_the_single_process_step(sharded, single):
    total, parts = single[:2]
    for out in sharded:
        t, pt = out["estimator"][:2]
        assert sorted(pt) == sorted(parts)
        for k in parts:
            np.testing.assert_allclose(pt[k], parts[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(t, total, rtol=1e-5)


def test_sharded_batchnorm_statistics_are_the_whole_batchs(sharded, single):
    stats = single[2]
    assert len(stats) == 20
    for out in sharded:
        for k, v in stats.items():
            np.testing.assert_allclose(out["estimator"][2][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    # the statistics moved from their initial (0, 1)
    assert max(float(v.abs().max()) for k, v in stats.items() if "mean" in k) > 1e-3


def test_sharded_estimator_parameters_within_two_learning_rates(sharded, single):
    """Per element within 2.1 lr. Most elements agree far closer: 0.18% of
    them part by more than 1e-3 lr (1% allowed), elements whose gradient
    is near 0, where the order of a sum decides the sign (this net's
    single-process gradients on 1 and on 4 threads part by up to 0.8% of a
    tensor's largest, in the transposed convolutions)."""
    params = single[3]
    n_loose = n_total = 0
    for out in sharded:
        for k, v in params.items():
            d = (out["estimator"][3][k] - v).abs()
            assert float(d.max()) <= 2.1 * LR, k
            n_loose += int((d > 1e-3 * LR).sum())
            n_total += d.numel()
    assert n_loose <= 1e-2 * n_total


def test_sharded_estimator_loss_equals_the_jax_sharded_step(sharded):
    import jax
    import jax.numpy as jnp

    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth as JaxNet
    from rgbmanip_tpu.models.pose_estimator.training import EstimatorTrainer as JaxTrainer
    from rgbmanip_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(WORLD, tp=2)
    params, stats = to_jax_params(estimator())
    params = jmesh.apply_shardings(params, jmesh.param_shardings(params, mesh))
    stats = jmesh.apply_shardings(stats, jax.tree.map(lambda _: jmesh.replicated(mesh), stats))
    batch = synthetic_batch(torch.Generator().manual_seed(0), B, S, N_PTS, n_depth=D)
    batch = jmesh.shard_batch({k: jnp.asarray(v.numpy()) for k, v in batch.items()}, mesh)
    trainer = JaxTrainer(JaxNet(backend="resnet18", regress_pose=True), params, stats,
                         lr=LR, mesh=mesh)
    total, parts = trainer.step(batch)
    t, pt = sharded[0]["estimator"][:2]
    for k in parts:
        np.testing.assert_allclose(pt[k], parts[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(t, total, rtol=1e-5)


def test_dryrun_multichip_runs_on_four_cpu_ranks(capsys):
    out = graft_entry.dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out
    assert (out["dp"], out["tp"]) == (2, 2)
    assert "dryrun production-shape (224px/r34/24-depth) dp=2 tp=2: loss" in printed
    assert "dryrun_multichip OK: mesh dp=2 tp=2, estimator loss" in printed
    assert np.isfinite(out["production_loss"])
    ref = graft_entry.dryrun_steps(2, 1, device="cpu")
    np.testing.assert_allclose(out["estimator_loss"], ref["estimator_loss"], rtol=1e-5)
    np.testing.assert_allclose(out["ppo_metrics"], ref["ppo_metrics"], rtol=1e-5)


def test_the_card_paths_raise_without_a_card():
    """``dryrun_multichip`` runs on the card unless asked for the CPU, and
    ``scripts/mesh_step_cost.py`` only on the card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from rgbmanip_tpu_torch.scripts import mesh_step_cost

    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="card"):
        mesh_step_cost.main(["--reps", "1"])
