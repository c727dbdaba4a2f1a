"""The port's mesh (``rgbmanip_tpu_torch/parallel/mesh.py``) on four ``gloo``
ranks of the CPU, against the JAX package's ``parallel/mesh.py`` on its
virtual devices: the (dp, tp) mesh, the tensor-parallel rule on the tiny
resnet18 estimator (the parameters it shards are, through the converter's
key map, the flax paths the JAX rule shards), the placed shards, each
rank's batch block, and the global-norm clip over tp-sharded gradients.

The ranks import this module by name (``torch.multiprocessing``'s spawn),
so the JAX package is imported inside the tests, not at the top.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from rgbmanip_tpu_torch.algo.ppo import clip_by_global_norm_
from rgbmanip_tpu_torch.models.pose_estimator.converter import model_key_map, to_jax_params
from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import (StereoPoseNetWithDepth,
                                                                  flax_init_)
from rgbmanip_tpu_torch.parallel.launch import run_ranks
from rgbmanip_tpu_torch.parallel.mesh import (apply_shardings, batch_sharding, make_mesh,
                                              param_shardings, replicated, shard_batch)

torch.set_num_threads(2)

WORLD, TP = 4, 2
# the JAX dryrun's tiny estimator: resnet18 at the JAX module's defaults
KNOBS = dict(backend="resnet18", backbone_stride=8, volume_scale=1, warp_mode="bilinear")


def tiny_net():
    """The same weights on every rank (``distribute_tensor`` takes rank 0's)."""
    model = StereoPoseNetWithDepth(regress_pose=True, **KNOBS)
    return flax_init_(model, torch.Generator().manual_seed(0))


def mesh_rank(rank, world):
    """What one rank sees of the port's mesh functions."""
    out = {}
    try:
        make_mesh(world, tp=3)
    except ValueError as e:
        out["tp3"] = str(e)
    mesh = make_mesh(world, tp=TP)
    out["shape"] = {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    out["coords"] = [mesh.get_local_rank("dp"), mesh.get_local_rank("tp")]
    out["placements"] = [str(p) for p in batch_sharding(mesh) + replicated(mesh)]

    model = tiny_net()
    shardings = param_shardings(model, mesh)
    out["sharded"] = {n: [p.dim for p in pl if isinstance(p, Shard)][0]
                      for n, (_, pl) in shardings.items() if pl != replicated(mesh)}
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    # rank 0's values everywhere: a shard as a DTensor, a replicated
    # parameter as a plain tensor
    for p in model.parameters():
        with torch.no_grad():
            p.add_(rank)
    apply_shardings(model, shardings)
    out["shards_equal"] = all(
        isinstance(p, DTensor) and p.placements == tuple(shardings[n][1])
        and torch.equal(p.to_local(), full[n].tensor_split(TP, out["sharded"][n])[
            out["coords"][1]])
        if n in out["sharded"] else
        not isinstance(p, DTensor) and torch.equal(p.detach(), full[n])
        for n, p in model.named_parameters())

    out["rows"] = shard_batch(torch.arange(8 * 3).reshape(8, 3), mesh)[:, 0].tolist()
    rollout = {"r": torch.arange(4 * 8).reshape(4, 8)}      # (T, N)
    out["envs"] = shard_batch(rollout, mesh, dim=1)["r"][0].tolist()

    # the global-norm clip with one gradient sharded over tp and one replicated
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(6, 4, generator=g), torch.randn(5, generator=g)]
    params = []
    for grad, placements in zip(grads, ([Replicate(), Shard(0)], [Replicate(), Replicate()])):
        p = torch.nn.Parameter(distribute_tensor(torch.zeros_like(grad), mesh, placements))
        p.grad = distribute_tensor(grad.clone(), mesh, placements)
        params.append(p)
    norm = clip_by_global_norm_(params, 1.0)
    out["norm"] = float(norm)
    out["clipped"] = [p.grad.full_tensor() for p in params]
    out["grads"] = grads
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(mesh_rank, WORLD, "cpu")


def test_make_mesh_over_four_gloo_ranks_is_two_by_two(ranks):
    for r, out in enumerate(ranks):
        assert out["shape"] == {"dp": 2, "tp": 2}
        assert out["coords"] == [r // TP, r % TP]
        assert out["tp3"] == "4 devices not divisible by tp=3"
        assert out["placements"] == ["S(0)", "R", "R", "R"]


def test_the_tp_rule_shards_the_flax_paths_that_jax_shards(ranks):
    import jax

    from rgbmanip_tpu.parallel import mesh as jmesh

    model = tiny_net()
    params, _ = to_jax_params(model)
    jspecs = jmesh.param_shardings(params, jmesh.make_mesh(WORLD, tp=TP))
    jax_sharded = {tuple(k.key for k in path) for path, s in
                   jax.tree_util.tree_flatten_with_path(jspecs)[0] if "tp" in s.spec}
    kmap = model_key_map(model)
    sharded = ranks[0]["sharded"]
    assert {kmap[n][1] for n in sharded} == jax_sharded
    assert len(jax_sharded) > 10
    # the sharded dim is the output features: dim 1 of a transposed conv
    deconv = {n for n in sharded if kmap[n][2] == "deconv3d"}
    assert all(sharded[n] == (1 if n in deconv else 0) for n in sharded)
    assert all(out["sharded"] == sharded for out in ranks)


def test_apply_shardings_places_each_ranks_shard(ranks):
    assert all(out["shards_equal"] for out in ranks)


def test_shard_batch_gives_each_rank_its_rows(ranks):
    for r, out in enumerate(ranks):
        dp = r // TP
        assert out["rows"] == [3 * i for i in range(4 * dp, 4 * dp + 4)]
        assert out["envs"] == list(range(4 * dp, 4 * dp + 4))


def test_the_global_norm_clip_sums_over_tp_shards(ranks):
    grads = ranks[0]["grads"]
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    assert norm > 1.0
    for out in ranks:
        np.testing.assert_allclose(out["norm"], norm, rtol=1e-6)
        for got, g in zip(out["clipped"], grads):
            np.testing.assert_allclose(got.numpy(), (g / norm).numpy(), rtol=1e-6, atol=1e-7)
