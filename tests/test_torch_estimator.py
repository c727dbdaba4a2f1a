"""The whole slice: the port's AdaPoseEstimator against the JAX one at the
flagship width (``adapose_cabinet_fast``, 192 px, 1024 points, 16 depth
hypotheses) with the flagship checkpoint, on the same views and the same
point-sampling draws.

The JAX side's crop runs through its Pallas kernel in interpret mode, the
crop the main path ran on its chip (see tests/test_torch_preprocess.py).
Building the JAX estimator at this width takes about a minute on a CPU,
almost all in flax's init, so the file builds it once.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.models.pose_estimator import adapose as port_adapose

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "estimator_fast_cabinet_aug_r5.ckpt")
H, W = 480, 640
K_CAM = np.array([[439.3, 0, 320], [0, 439.3, 240], [0, 0, 1]], np.float32)


def look_at(eye, target):
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, -1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, y, z])
    E[:3, 3] = -E[:3, :3] @ eye
    return E.astype(np.float32)


def scene(seed=0):
    """Three envs, two views each: a centred object, an object in the frame
    corner, and an env whose second view lost the object (empty mask)."""
    rng = np.random.default_rng(seed)
    B = 3
    rgb = rng.uniform(0.2, 0.6, size=(2, B, H, W, 3)).astype(np.float32)
    mask = np.zeros((2, B, H, W), bool)
    boxes = [[(170, 310, 250, 400), (180, 320, 230, 380)],
             [(0, 70, 0, 90), (5, 80, 0, 100)],
             [(200, 330, 300, 420), None]]
    for b, views in enumerate(boxes):
        colour = rng.uniform(0.0, 1.0, size=3).astype(np.float32)
        for v, box in enumerate(views):
            if box is None:
                continue
            y0, y1, x0, x1 = box
            mask[v, b, y0:y1, x0:x1] = True
            tex = rng.normal(0.0, 0.08, size=(y1 - y0, x1 - x0, 3))
            rgb[v, b, y0:y1, x0:x1] = np.clip(colour + tex, 0.0, 1.0)
    ext = np.stack([np.stack([look_at(np.array([0.1 * v - 0.05, -0.9, 0.5])
                                      + rng.normal(scale=0.03, size=3),
                                      [0.0, 0.0, 0.3]) for b in range(B)])
                    for v in range(2)])
    K = np.repeat(K_CAM[None], B, axis=0)
    return K, rgb, mask, ext


@pytest.fixture(scope="module")
def results():
    import rgbmanip_tpu.ops.pallas_preprocess as jpal
    import rgbmanip_tpu.ops.preprocess as jpre
    from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu.utils.logger import get_logger

    with open(os.path.join(REPO, "rgbmanip_tpu", "config", "cfg", "pose_estimator",
                           "adapose_cabinet_fast.yaml")) as f:
        jcfg = yaml.safe_load(f)
    jcfg["checkpoint_path"] = CKPT
    jest = AdaPoseEstimator(jcfg, get_logger())
    S = jest.img_size

    K, rgb, mask, ext = scene()
    B = K.shape[0]
    key = jax.random.PRNGKey(7)
    k1, k2, _ = jax.random.split(key, 3)
    u1 = np.array(jax.random.uniform(k1, (B, S * S)))
    u2 = np.array(jax.random.uniform(k2, (B, S * S)))

    orig_use, orig_crop = jpre._use_pallas, jpal.crop_resize_normalize
    jax.clear_caches()
    jpre._use_pallas = lambda: True
    jpal.crop_resize_normalize = functools.partial(orig_crop, interpret=True)
    try:
        bbox, valid, pose = jest._estimate_fn(
            jest.params, jest.batch_stats, K, rgb[0], mask[0], ext[0], rgb[1],
            mask[1], ext[1], key)
        ref = {"bbox": np.asarray(bbox), "valid": np.asarray(valid),
               **{k: np.asarray(v) for k, v in pose.items()}}
    finally:
        jpre._use_pallas, jpal.crop_resize_normalize = orig_use, orig_crop
        jax.clear_caches()

    pcfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": CKPT})
    pest = port_adapose.AdaPoseEstimator(pcfg, device="cpu")
    t = torch.from_numpy
    bbox, valid, pose = pest._estimate(t(K), t(rgb[0]), t(mask[0]), t(ext[0]),
                                       t(rgb[1]), t(mask[1]), t(ext[1]), t(u1), t(u2))
    out = {"bbox": bbox.numpy(), "valid": valid.numpy(),
           **{k: v.numpy() for k, v in pose.items()}}
    return ref, out


def test_valid_flags_equal(results):
    ref, out = results
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    np.testing.assert_array_equal(out["valid"], [True, True, False])


def test_world_bbox_within_a_millimetre(results):
    ref, out = results
    print("max |bbox diff| (m):", np.abs(out["bbox"] - ref["bbox"]).max())
    np.testing.assert_allclose(out["bbox"], ref["bbox"], rtol=0, atol=1e-3)


def test_empty_view_returns_the_sentinel(results):
    _, out = results
    np.testing.assert_array_equal(out["bbox"][2], port_adapose.DEFAULT_BBOX)


def test_pose_matches_on_valid_envs(results):
    """Rotation and translation come out of the network and the centroid
    solve in f32 (1e-4); the scale is a median, exact in the port and
    bisected to range/2**32 by the JAX package (rtol 1e-4 covers both and
    the f32 network differences that feed it)."""
    ref, out = results
    ok = ref["valid"]
    for k, tol in (("R_cam", dict(rtol=0, atol=1e-4)),
                   ("t_cam", dict(rtol=0, atol=1e-4)),
                   ("scale", dict(rtol=1e-4, atol=0))):
        print(k, "max |diff|:", np.abs(out[k][ok] - ref[k][ok]).max())
        np.testing.assert_allclose(out[k][ok], ref[k][ok], err_msg=k, **tol)


def test_public_entry_point_with_its_generator():
    """estimate / estimate_full draw from the estimator's own generator and
    return numpy of the documented shapes."""
    pcfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": CKPT})
    est = port_adapose.AdaPoseEstimator(pcfg, device="cpu", seed=3)
    K, rgb, mask, ext = scene(seed=1)
    full = est.estimate_full(K[:1], rgb[0, :1], mask[0, :1], ext[0, :1],
                             rgb[1, :1], mask[1, :1], ext[1, :1])
    assert full["bbox"].shape == (1, 8, 3) and full["valid"].shape == (1,)
    assert full["R_cam"].shape == (1, 3, 3) and full["t_cam"].shape == (1, 3)
    assert np.isfinite(full["bbox"]).all()
    bbox = est.estimate(K[:1], rgb[0, :1], mask[0, :1], ext[0, :1],
                        rgb[1, :1], mask[1, :1], ext[1, :1])
    assert bbox.shape == (1, 8, 3)


def test_meta_mismatch_raises():
    pcfg = load_group("pose_estimator", "adapose_cabinet_fast",
                      {"checkpoint_path": CKPT, "img_size": 224})
    with pytest.raises(ValueError, match="architecture knobs"):
        port_adapose.AdaPoseEstimator(pcfg, device="cpu")

