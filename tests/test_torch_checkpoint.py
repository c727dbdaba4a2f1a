"""Every leaf of the committed checkpoints maps onto a parameter or buffer
of the port, with the right shape and nothing left over; metadata that
does not match the estimator's knobs raises."""

import os

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.algo.ppo import PPOPolicy
from rgbmanip_tpu_torch.models.pose_estimator.converter import (load_jax_params,
                                                                torch_key_map)
from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
from rgbmanip_tpu_torch.utils.checkpoint import flatten, load_checkpoint

torch.set_num_threads(2)

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints")
ESTIMATORS = ["estimator_fast_cabinet_aug_r5.ckpt", "estimator_fast_cabinet_dagger_r3.ckpt",
              "estimator_fast_cabinet_r2.ckpt", "estimator_fast_drawer_r3.ckpt",
              "estimator_fast_mug_fine_r5.ckpt", "estimator_fast_pot_r3.ckpt"]
POLICIES = ["ppo_rl_adapose_model_125.ckpt", "ppo_rl_coadapt_model_165.ckpt",
            "ppo_rl_drawer_rl_model_195.ckpt"]


def net_for(meta):
    return StereoPoseNetWithDepth(backend=meta["backend"],
                                  backbone_stride=meta["backbone_stride"],
                                  volume_scale=meta["volume_scale"],
                                  warp_mode=meta["warp_mode"])


@pytest.mark.parametrize("name", ESTIMATORS)
def test_estimator_checkpoint_maps_leaf_for_leaf(name):
    tree, meta = load_checkpoint(os.path.join(CKPT_DIR, name))
    net = net_for(meta)
    load_jax_params(net, tree["params"], tree["batch_stats"])
    # every leaf landed where the key map says, unchanged up to its layout
    state = net.state_dict()
    leaves = {"params": flatten(tree["params"]), "batch_stats": flatten(tree["batch_stats"])}
    kmap = torch_key_map()
    assert {(c, fp) for c, fp, _ in kmap.values()} == {
        (c, fp) for c, t in leaves.items() for fp in t}
    for k, (coll, fp, kind) in kmap.items():
        w = leaves[coll][fp]
        assert state[k].numel() == w.size, k
        np.testing.assert_array_equal(np.sort(state[k].numpy().ravel()),
                                      np.sort(w.ravel()), err_msg=k)


def test_missing_and_leftover_leaves_raise():
    tree, meta = load_checkpoint(os.path.join(CKPT_DIR, ESTIMATORS[0]))
    params = tree["params"]
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="map to no torch entry"):
        load_jax_params(net_for(meta), extra, tree["batch_stats"])
    short = {k: v for k, v in params.items() if k != "nocs_head"}
    with pytest.raises(ValueError, match="no flax leaf"):
        load_jax_params(net_for(meta), short, tree["batch_stats"])


def test_shape_mismatch_raises():
    tree, meta = load_checkpoint(os.path.join(CKPT_DIR, ESTIMATORS[0]))
    tree["params"]["instance_color"]["dense_0"]["kernel"] = np.zeros((16, 64), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(net_for(meta), tree["params"], tree["batch_stats"])


def test_estimator_metadata_is_the_fast_architecture():
    for name in ESTIMATORS:
        _, meta = load_checkpoint(os.path.join(CKPT_DIR, name))
        assert meta["backend"] == "resnet18" and meta["backbone_stride"] == 32
        assert meta["img_size"] == 192 and meta["n_depth"] == 16


@pytest.mark.parametrize("name", POLICIES)
def test_policy_checkpoint_loads(name):
    policy = PPOPolicy.from_checkpoint(os.path.join(CKPT_DIR, name), device="cpu")
    state = policy.model.state_dict()
    assert state["actor.0.weight"].shape == (96, 60)
    assert state["actor.6.weight"].shape == (12, 32)
    assert state["critic.6.weight"].shape == (1, 32)
    assert state["log_std"].shape == (12,)
