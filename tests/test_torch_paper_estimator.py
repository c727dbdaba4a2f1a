"""The paper-size AdaPose configuration (``adapose_cabinet``: resnet34 at
backbone stride 8, ``volume_scale`` 2, 24 depth hypotheses at 0.1 m, nearest
warp) in the port against the JAX package, at a reduced image.

The released weights of this configuration are not in the repo, so both
sides run weights made from a seed with numpy (kernels with the variance
of flax's lecun_normal init; BatchNorm and PReLU leaves away from their
trivial values, so that the mapping of every leaf matters), carried into
the port by ``load_jax_params``. The parameter shapes come from
``jax.eval_shape`` of the flax init: running the init itself at resnet34
and stride 8 costs half a minute on a CPU.

Tolerances: both sides compute in f32 and the convolutions sum in another
order (XLA's CPU kernels and its banded plan of the 3-D U-Net against
oneDNN's Conv3d), so features and network outputs of order 1 agree to 1e-4
absolute (6e-6 was seen for PSPNet at stride 8); the world bbox, which the
solve scales by the predicted depth, to 1e-3 m (expected ~1e-6 m).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.models.pose_estimator import adapose as port_adapose
from rgbmanip_tpu_torch.models.pose_estimator.converter import (FLAX_TO_TORCH,
                                                                load_jax_params,
                                                                torch_key_map)
from rgbmanip_tpu_torch.models.pose_estimator.nets import pspnet as port_pspnet
from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo as port_stereo
from rgbmanip_tpu_torch.utils.checkpoint import flatten

from test_torch_estimator import scene
from test_torch_stereo import projections, randomise

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_FAST = os.path.join(REPO, "checkpoints", "estimator_fast_cabinet_aug_r5.ckpt")
S, NPTS, D, B = 64, 128, 24, 2
PAPER = dict(backend="resnet34", backbone_stride=8, volume_scale=2)
ATOL = 1e-4


def jax_cfg(**over):
    with open(os.path.join(REPO, "rgbmanip_tpu", "config", "cfg", "pose_estimator",
                           "adapose_cabinet.yaml")) as f:
        return {**yaml.safe_load(f), **over}


def seeded_tree(shapes, rng):
    """numpy leaves for a tree of ShapeDtypeStructs: kernels normal with
    variance 1 / fan-in (that of flax's lecun_normal), the other leaves as
    ``randomise`` sets them (biases of convolutions and dense layers small)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0.0, np.sqrt(1.0 / fan_in), s.shape).astype(np.float32)
        return rng.normal(0.0, 0.05, s.shape).astype(np.float32)
    return randomise(jax.tree_util.tree_map_with_path(leaf, shapes), rng)


def init_shapes_only(module, key, *args, **kwargs):
    """Stands in for ``Module.init``: the variables' shapes, not values."""
    from flax import linen as nn
    return jax.eval_shape(functools.partial(nn.Module.init, module, **kwargs), key, *args)


@pytest.fixture(scope="module")
def jax_estimator():
    """The JAX estimator at the paper configuration with a 64 px image, on
    seeded weights."""
    from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu.utils.logger import get_logger

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
        jest = AdaPoseEstimator(jax_cfg(img_size=S), get_logger())
    rng = np.random.default_rng(0)
    jest.params = seeded_tree(jest.params, rng)
    jest.batch_stats = seeded_tree(jest.batch_stats, rng)
    return jest


def psp_state(params, backend):
    """The port PSPNet's state_dict from a flax PSPNet tree, through the
    converter's key map and layouts; every flax leaf is used once."""
    kmap = {k[len("img_extractor."):]: v for k, v in torch_key_map(backend).items()
            if k.startswith("img_extractor.")}
    flat = flatten(params)
    assert {fp[1:] for _, fp, _ in kmap.values()} == set(flat)
    return {k: torch.from_numpy(np.ascontiguousarray(FLAX_TO_TORCH[kind](flat[fp[1:]])))
            for k, (_, fp, kind) in kmap.items()}


@pytest.mark.parametrize("backbone_stride", [8, 16, 32])
@pytest.mark.parametrize("backend", ["resnet34", "resnet18", "resnet10s"])
def test_pspnet_matches_flax(backend, backbone_stride):
    """Every (backend, stride) pair of the JAX module's tables: block counts,
    widths, the slim 1x1 up_1, the dilated layers at strides 8 and 16."""
    from rgbmanip_tpu.models.pose_estimator.nets.pspnet import PSPNet

    model = PSPNet(backend=backend, backbone_stride=backbone_stride)
    shapes = init_shapes_only(model, jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params = seeded_tree(shapes["params"], np.random.default_rng(1))
    x = np.random.default_rng(2).normal(size=(B, S, S, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    net = port_pspnet.PSPNet(backend, backbone_stride)
    net.load_state_dict(psp_state(params, backend))
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    fs = backbone_stride // 8
    assert out.shape == ref.shape == (B, S // fs, S // fs, 32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_stereo_net_paper_knobs_match_jax(jax_estimator):
    """The whole network at the paper's knobs: a 32 x 32 x 24 volume at
    64 px, 128 points, against the module as the JAX estimator builds it."""
    jest = jax_estimator
    rng = np.random.default_rng(1)
    img1, img2 = (rng.normal(size=(B, S, S, 3)).astype(np.float32) for _ in range(2))
    ch1, ch2 = (rng.integers(0, S * S, size=(B, NPTS)).astype(np.int32) for _ in range(2))
    P1, P2 = projections(S, 1)
    dv = np.broadcast_to(0.1 + 0.1 * np.arange(D, dtype=np.float32), (B, D)).copy()
    x = (img1, ch1, img2, ch2, P1, P2, dv)
    apply = jax.jit(functools.partial(jest.model.apply, train=False))
    ref = apply({"params": jest.params, "batch_stats": jest.batch_stats},
                *(jnp.asarray(a) for a in x))
    net = port_stereo.StereoPoseNetWithDepth(warp_mode="nearest", **PAPER).eval()
    load_jax_params(net, jest.params, jest.batch_stats)
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in x))
    assert set(out) == set(ref)
    assert out["view1_depth"].shape == (B, NPTS)
    for k in sorted(ref):
        r = np.asarray(ref[k])
        assert out[k].shape == r.shape, k
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def estimates(jax_estimator):
    """The JAX and the port estimator's (bbox, valid) on the same views and
    point-sampling draws; the JAX crop runs through its Pallas kernel in
    interpret mode, the crop its main path ran on the chip."""
    import rgbmanip_tpu.ops.pallas_preprocess as jpal
    import rgbmanip_tpu.ops.preprocess as jpre

    jest = jax_estimator
    K, rgb, mask, ext = scene()
    n = K.shape[0]
    key = jax.random.PRNGKey(7)
    k1, k2, _ = jax.random.split(key, 3)
    u1 = np.array(jax.random.uniform(k1, (n, S * S)))
    u2 = np.array(jax.random.uniform(k2, (n, S * S)))
    orig_use, orig_crop = jpre._use_pallas, jpal.crop_resize_normalize
    jax.clear_caches()
    jpre._use_pallas = lambda: True
    jpal.crop_resize_normalize = functools.partial(orig_crop, interpret=True)
    try:
        bbox, valid, _ = jest._estimate_fn(jest.params, jest.batch_stats, K, rgb[0],
                                           mask[0], ext[0], rgb[1], mask[1], ext[1], key)
        ref = (np.asarray(bbox), np.asarray(valid))
    finally:
        jpre._use_pallas, jpal.crop_resize_normalize = orig_use, orig_crop
        jax.clear_caches()

    pest = port_adapose.AdaPoseEstimator(
        load_group("pose_estimator", "adapose_cabinet", {"img_size": S}), device="cpu")
    load_jax_params(pest.model, jest.params, jest.batch_stats)
    t = torch.from_numpy
    bbox, valid, _ = pest._estimate(t(K), t(rgb[0]), t(mask[0]), t(ext[0]), t(rgb[1]),
                                    t(mask[1]), t(ext[1]), t(u1), t(u2))
    return ref, (bbox.numpy(), valid.numpy())


def test_paper_estimate_valid_flags_equal(estimates):
    ref, out = estimates
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[1], [True, True, False])


def test_paper_estimate_world_bbox_within_a_millimetre(estimates):
    ref, out = estimates
    print("max |bbox diff| (m):", np.abs(out[0] - ref[0]).max())
    assert np.isfinite(out[0]).all()
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-3)


def test_paper_configuration_defaults_come_through():
    est = port_adapose.AdaPoseEstimator(load_group("pose_estimator", "adapose_cabinet"),
                                        device="cpu")
    assert (est.img_size, est.n_pts, est.n_depth, est.d_interval) == (224, 1024, 24, 0.1)
    meta = est._arch_meta()
    assert (meta["backend"], meta["backbone_stride"], meta["volume_scale"],
            meta["warp_mode"]) == ("resnet34", 8, 2, "nearest")
    layer4 = est.model.img_extractor.feats.layer4
    assert len(layer4) == 3 and layer4[1].conv1.dilation == (4, 4)
    assert layer4[0].conv1.stride == (1, 1)


def test_seeded_weights_are_reproducible():
    cfg = load_group("pose_estimator", "adapose_cabinet", {"img_size": S})
    a, b, c = (port_adapose.AdaPoseEstimator(cfg, device="cpu", seed=s) for s in (3, 3, 4))
    wa, wb, wc = (e.model.cost_regularization.conv0.conv.weight for e in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)


def test_a_checkpoint_of_another_stride_is_refused():
    """resnet18 at stride 16 has the parameter shapes of the committed
    stride-32 checkpoint, so only its metadata can refuse it."""
    cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                     {"checkpoint_path": CKPT_FAST, "backbone_stride": 16})
    with pytest.raises(ValueError, match="backbone_stride"):
        port_adapose.AdaPoseEstimator(cfg, device="cpu")
