"""Every estimator generation and solve of the JAX package through the port:
``make_estimator``'s v1 (the original network, NOCS-match triangulation and
DLT PnP), v3 (predicted depth, RANSAC-Umeyama), v5 (direct regression),
baseline (no stereo fusion) and realworld (the (px, py, depth) pose branch),
and v5 with ``volume_channels`` and with ``fuse_views``; each solve alone;
``homo_warp`` and ``homo_warp_points``; ``ViewFusion`` and the tensor
quaternion ops; and ``python -m rgbmanip_tpu_torch.train
pose_estimator=adapose_baseline``.

Sizes: 64 px, 128 points, B=2 (the first two envs of
``test_torch_estimator.scene``: an object in the middle of the frame and
one in its corner), the production knobs otherwise (resnet18 at backbone
stride 32, volume scale 8, 16 bins of 0.15 m, nearest warp; V1 takes
PSPNet at stride 8 and its bilinear warp at full resolution). Both sides
run the same seeded weights (``seeded_tree`` over the JAX init's shapes),
the same views, the JAX estimator's point-sampling draws and its RANSAC
hypotheses (``jax.random.randint`` of each env's key), and the JAX crop
goes through its Pallas kernel in interpret mode.

Tolerances: the world bbox within 1e-3 m, equal valid flags (the estimates
are f32 on both sides; the networks agree to ~1e-6, tests/test_torch_stereo.py,
and each solve's SVDs and medians to f32 rounding, so the bboxes agree to
~1e-5 m). The solves alone on the same inputs: 1e-4 on rotations and unit
translations, 1e-4 relative on scales.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rgbmanip_tpu_torch.models.pose_estimator import adapose as port_adapose
from rgbmanip_tpu_torch.models.pose_estimator.converter import load_jax_params, to_jax_params
from rgbmanip_tpu_torch.ops import geometry as PG
from rgbmanip_tpu_torch.utils.checkpoint import flatten

from test_torch_estimator import scene
from test_torch_paper_estimator import init_shapes_only, seeded_tree
from test_torch_rl_loop import jax_pallas_crop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, NPTS, B = 64, 128, 2
GENERATIONS = [("v1", {}), ("v3", {}), ("v5", {}), ("baseline", {}), ("realworld", {}),
               ("v5", {"volume_channels": 8}), ("v5", {"fuse_views": True})]


def base_cfg(**over):
    with open(os.path.join(REPO, "rgbmanip_tpu", "config", "cfg", "pose_estimator",
                           "adapose_cabinet_fast.yaml")) as f:
        cfg = yaml.safe_load(f)
    return {**cfg, "load": False, "checkpoint_path": "", "img_size": S, "n_pts": NPTS,
            **over}


def jax_estimator(version, over):
    """The JAX package's ``make_estimator(version)`` on seeded weights;
    ``fuse_views`` is the module's knob, set on the estimator's model."""
    from rgbmanip_tpu.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import (StereoPoseNetV1,
                                                                StereoPoseNetWithDepth)
    from rgbmanip_tpu.utils.logger import get_logger

    fuse = over.get("fuse_views", False)
    cfg = base_cfg(**{k: v for k, v in over.items() if k != "fuse_views"})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
        mp.setattr(StereoPoseNetV1, "init", init_shapes_only)
        jest = make_estimator(version, cfg, get_logger())
    rng = np.random.default_rng(0)
    jest.params = seeded_tree(jest.params, rng)
    jest.batch_stats = seeded_tree(jest.batch_stats, rng)
    if fuse:
        jest.model = jest.model.clone(fuse_views=True)
        jest._estimate_fn = jax.jit(jest._estimate)
    return jest


def jax_draws(key, n):
    """The uniforms of the two views' point sampling and each env's RANSAC
    hypotheses, as the JAX estimator draws them from one call's key."""
    k1, k2, k3 = jax.random.split(key, 3)
    u = [np.array(jax.random.uniform(k, (n, S * S))) for k in (k1, k2)]
    idx = np.stack([np.array(jax.random.randint(k, (128, 5), 0, NPTS))
                    for k in jax.random.split(k3, n)])
    return u[0], u[1], idx


@pytest.fixture(scope="module")
def views():
    K, rgb, mask, ext = scene()
    return K[:B], rgb[:, :B], mask[:, :B], ext[:, :B]


@pytest.fixture(scope="module", params=GENERATIONS,
                ids=[v + "".join(f"-{k}" for k in o) for v, o in GENERATIONS])
def estimates(request, views):
    version, over = request.param
    K, rgb, mask, ext = views
    jest = jax_estimator(version, over)
    key = jax.random.PRNGKey(7)
    with jax_pallas_crop():
        bbox, valid, pose = jest._estimate_fn(jest.params, jest.batch_stats, K, rgb[0],
                                              mask[0], ext[0], rgb[1], mask[1], ext[1], key)
    ref = {"bbox": np.asarray(bbox), "valid": np.asarray(valid),
           **{k: np.asarray(v) for k, v in pose.items()}}
    pest = port_adapose.make_estimator(
        version, base_cfg(**{k: v for k, v in over.items() if k != "fuse_views"}), device="cpu")
    pest.model.fuse_views = over.get("fuse_views", False)
    load_jax_params(pest.model, jest.params, jest.batch_stats)
    u1, u2, idx = jax_draws(key, B)
    t = torch.from_numpy
    bbox, valid, pose = pest._estimate(t(K), t(rgb[0]), t(mask[0]), t(ext[0]), t(rgb[1]),
                                       t(mask[1]), t(ext[1]), t(u1), t(u2), t(idx))
    out = {"bbox": bbox.numpy(), "valid": valid.numpy(),
           **{k: v.numpy() for k, v in pose.items()}}
    return version, over, jest, pest, ref, out


def test_generation_builds_the_jax_architecture(estimates):
    """The same parameter tree (so the converter maps every leaf), and the
    architecture metadata a checkpoint of the generation would carry."""
    version, over, jest, pest, _, _ = estimates
    params, stats = to_jax_params(pest.model)
    for mine, theirs in ((params, jest.params), (stats, jest.batch_stats)):
        fa, fb = flatten(mine), flatten(theirs)
        assert sorted(fa) == sorted(fb)
        assert all(fa[k].shape == np.asarray(fb[k]).shape for k in fb)
    assert pest._arch_meta() == jest._arch_meta()
    m = pest.model
    if version == "v1":
        assert m.arch == "v1"
    else:
        assert m.regress_pose == (version != "v3")
        assert m.stereo_fusion == (version != "baseline")
        assert m.realworld_pts == (version == "realworld")
        assert m.volume_channels == over.get("volume_channels", 0)
        assert m.fuse_views == over.get("fuse_views", False)


def test_generation_estimate_matches_jax(estimates):
    version, over, _, _, ref, out = estimates
    print(version, over, "valid", out["valid"], "max |bbox diff| (m):",
          np.abs(out["bbox"] - ref["bbox"]).max())
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    np.testing.assert_allclose(out["bbox"], ref["bbox"], rtol=0, atol=1e-3)


def test_generation_pose_matches_jax(estimates):
    """The solved pose, NaN where the JAX package's is (V1's triangulation
    finds no mutual NOCS match on seeded weights: its scale and pose are
    NaN on both sides, and the solve alone is held below)."""
    version, _, _, _, ref, out = estimates
    for k, tol in (("R_cam", dict(rtol=0, atol=1e-4)), ("t_cam", dict(rtol=0, atol=1e-4)),
                   ("scale", dict(rtol=1e-4, atol=0))):
        np.testing.assert_array_equal(np.isfinite(out[k]), np.isfinite(ref[k]), err_msg=k)
        fin = np.isfinite(ref[k])
        np.testing.assert_allclose(out[k][fin], ref[k][fin], err_msg=k, **tol)
    assert version == "v1" or ref["valid"].all()


def test_v1_network_matches_jax():
    """``StereoPoseNetV1`` against the JAX module at 64 px on seeded weights
    (BatchNorm statistics away from identity): every output within 1e-4."""
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetV1 as JV1
    from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import StereoPoseNetV1
    from test_torch_stereo import projections
    D = 16
    rng = np.random.default_rng(12)
    img1, img2 = (rng.normal(size=(B, S, S, 3)).astype(np.float32) for _ in range(2))
    ch1, ch2 = (rng.integers(0, S * S, size=(B, NPTS)).astype(np.int32) for _ in range(2))
    P1, P2 = projections(S, 13)
    dv = np.broadcast_to(0.1 + 0.15 * np.arange(D, dtype=np.float32), (B, D)).copy()
    x = (img1, ch1, img2, ch2, P1, P2, dv)
    jm = JV1(backend="resnet18")
    shapes = init_shapes_only(jm, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in x),
                              train=False)
    rng = np.random.default_rng(14)
    params, stats = seeded_tree(shapes["params"], rng), seeded_tree(shapes["batch_stats"], rng)
    ref = jax.jit(lambda p, s, *a: jm.apply({"params": p, "batch_stats": s}, *a,
                                            train=False))(params, stats,
                                                          *(jnp.asarray(a) for a in x))
    net = StereoPoseNetV1("resnet18", n_depth=D).eval()
    load_jax_params(net, params, stats)
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in x))
    assert set(out) == set(ref)
    for k in sorted(ref):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_some_generations_give_valid_estimates():
    """The comparisons above are of poses, not only of sentinels: on these
    seeded weights the direct-regression generations solve both envs."""
    K, rgb, mask, ext = scene()
    est = port_adapose.make_estimator("v5", base_cfg(), device="cpu")
    full = est.estimate_full(K[:B], rgb[0, :B], mask[0, :B], ext[0, :B], rgb[1, :B],
                             mask[1, :B], ext[1, :B])
    assert full["valid"].all()


@pytest.mark.parametrize("cfg,match", [
    (dict(arch="v1"), "no depth head"),
    (dict(arch="v1", use_depth=False, direct_regression=False, real_world=True),
     "no depth head"),
    (dict(arch="v2"), "unknown estimator arch"),
    (dict(n_depth=12), "multiple of 8"),
])
def test_estimator_rejects_what_jax_rejects(cfg, match):
    with pytest.raises(ValueError, match=match):
        port_adapose.AdaPoseEstimator(base_cfg(**cfg), device="cpu")


def test_the_realworld_net_requires_the_points_pixels():
    from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    net = StereoPoseNetWithDepth(realworld_pts=True).eval()
    z = torch.zeros
    with pytest.raises(ValueError, match="v1_pts2d"):
        net(z(1, S, S, 3), z(1, NPTS, dtype=torch.long), z(1, S, S, 3),
            z(1, NPTS, dtype=torch.long), torch.eye(4)[None], torch.eye(4)[None],
            0.1 + 0.15 * torch.arange(16.0)[None])


# ------------------------------------------------------------- the solves ---
def similarity_problem(seed, n=128, outliers=0.3):
    """(source, target) with target = s R source + t on most points and the
    rest moved far off, B=3."""
    rng = np.random.default_rng(seed)
    src, tgt = [], []
    for _ in range(3):
        a = rng.normal(size=(3, 3))
        R, _ = np.linalg.qr(a)
        R *= np.sign(np.linalg.det(R))
        s, t = rng.uniform(0.2, 2.0), rng.normal(size=3)
        x = rng.normal(scale=0.3, size=(n, 3))
        y = s * x @ R.T + t + rng.normal(scale=1e-3, size=(n, 3))
        bad = rng.random(n) < outliers
        y[bad] += rng.normal(scale=1.0, size=(int(bad.sum()), 3))
        src.append(x)
        tgt.append(y)
    return np.stack(src).astype(np.float32), np.stack(tgt).astype(np.float32)


def test_umeyama_matches_jax():
    from rgbmanip_tpu.ops import geometry as JG
    src, tgt = similarity_problem(0, outliers=0.0)
    w = np.random.default_rng(1).uniform(0.0, 1.0, size=src.shape[:2]).astype(np.float32)
    ref = jax.vmap(JG.umeyama)(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    out = PG.umeyama(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(w))
    for r, o, name in zip(ref, out, ("scale", "R", "t")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)


def test_ransac_umeyama_matches_jax_with_its_hypotheses():
    from rgbmanip_tpu.ops import geometry as JG
    src, tgt = similarity_problem(2)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    ref = jax.vmap(JG.ransac_umeyama)(jnp.asarray(src), jnp.asarray(tgt), keys)
    idx = np.stack([np.array(jax.random.randint(k, (128, 5), 0, src.shape[1])) for k in keys])
    out = PG.ransac_umeyama(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(idx))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert out[3].all()
    for r, o, name in zip(ref[:3], out[:3], ("scale", "R", "t")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4, err_msg=name)


def cameras(seed, n_pts=128, scale=0.25):
    """Two look-at cameras around a cloud of NOCS points placed in the world
    by a similarity: returns nocs (3, N, 3), pts2d of each view, K, ext."""
    from test_torch_estimator import K_CAM, look_at
    rng = np.random.default_rng(seed)
    nocs, p1, p2, e1, e2 = [], [], [], [], []
    for _ in range(3):
        n = rng.uniform(-0.5, 0.5, size=(n_pts, 3))
        world = scale * n + np.array([0.0, 0.0, 0.3])
        views = []
        for v in range(2):
            E = look_at(np.array([0.15 * v - 0.08, -0.9, 0.5]) + rng.normal(scale=0.02, size=3),
                        [0.0, 0.0, 0.3]).astype(np.float64)
            cam = world @ E[:3, :3].T + E[:3, 3]
            uv = cam @ K_CAM.astype(np.float64).T
            views.append((uv[:, :2] / uv[:, 2:], E))
        nocs.append(n)
        (a, ea), (b, eb) = views
        p1.append(a)
        p2.append(b)
        e1.append(ea)
        e2.append(eb)
    K = np.repeat(K_CAM[None], 3, axis=0)
    f = np.float32
    return (np.stack(nocs).astype(f), np.stack(p1).astype(f), np.stack(p2).astype(f), K,
            np.stack(e1).astype(f), np.stack(e2).astype(f))


def full_projections(K, e):
    P = np.tile(np.eye(4, dtype=np.float32), (K.shape[0], 1, 1))
    P[:, :3] = K @ e[:, :3]
    return P


def test_triangulate_dlt_matches_jax():
    from rgbmanip_tpu.ops import geometry as JG
    nocs, p1, p2, K, e1, e2 = cameras(4)
    P1, P2 = full_projections(K, e1), full_projections(K, e2)
    ref = jax.vmap(JG.triangulate_dlt)(*(jnp.asarray(a) for a in (p1, P1, p2, P2)))
    out = PG.triangulate_dlt(*(torch.from_numpy(a) for a in (p1, P1, p2, P2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), 0.25 * nocs + [0.0, 0.0, 0.3], rtol=0, atol=1e-3)


@pytest.mark.parametrize("shuffle", [False, True])
def test_depth_from_nocs_matches_matches_jax(shuffle):
    """View 2's points are view 1's (shuffled or not), so mutual nearest
    neighbours in NOCS space find the true matches and the scale is the
    placement's 0.25."""
    from rgbmanip_tpu.ops import geometry as JG
    nocs, p1, p2, K, e1, e2 = cameras(5)
    nocs2 = nocs.copy()
    if shuffle:
        perm = np.random.default_rng(6).permutation(nocs.shape[1])
        nocs2, p2 = nocs2[:, perm], p2[:, perm]
    P1, P2 = full_projections(K, e1), full_projections(K, e2)
    args = (p1, nocs, P1, e1, p2, nocs2, P2, e2, K)
    ref = jax.vmap(JG.depth_from_nocs_matches)(*(jnp.asarray(a) for a in args))
    out = PG.depth_from_nocs_matches(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert out[1].all()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-4)
    np.testing.assert_allclose(out[0].numpy(), 0.25, rtol=1e-3)


def test_pnp_dlt_matches_jax():
    from rgbmanip_tpu.ops import geometry as JG
    nocs, p1, _, K, e1, _ = cameras(7)
    obj = 0.25 * nocs
    ref = jax.vmap(JG.pnp_dlt)(jnp.asarray(obj), jnp.asarray(p1), jnp.asarray(K))
    R, t = PG.pnp_dlt(torch.from_numpy(obj), torch.from_numpy(p1), torch.from_numpy(K))
    np.testing.assert_allclose(R.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(ref[1]), rtol=0, atol=1e-4)
    # the camera's own rotation, and the cloud's centre (0, 0, 0.3) in its frame
    np.testing.assert_allclose(R.numpy(), e1[:, :3, :3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), (e1[:, :3, :3] @ [0.0, 0.0, 0.3]) + e1[:, :3, 3],
                               rtol=0, atol=1e-3)


def test_a_non_finite_solve_gives_nan_not_an_error():
    obj = torch.full((2, 16, 3), float("nan"))
    R, t = PG.pnp_dlt(obj, torch.zeros(2, 16, 2), torch.eye(3).repeat(2, 1, 1))
    assert torch.isnan(R).all() and torch.isnan(t).all()


@pytest.mark.parametrize("n", [7, 128, 1000])
def test_masked_median_matches_jax_bisection(n):
    """The port's sort gives the exact lower median; the JAX package's 32
    bisection steps give it to range / 2**32."""
    from rgbmanip_tpu.ops import geometry as JG
    rng = np.random.default_rng(n)
    v = rng.lognormal(size=(3, n)).astype(np.float32)
    m = rng.random((3, n)) < 0.6
    m[2] = False
    ref = np.asarray(jax.vmap(JG.masked_median)(jnp.asarray(v), jnp.asarray(m)))
    out = PG.masked_median(torch.from_numpy(v), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(out[:2], ref[:2], rtol=1e-6)
    assert np.isnan(out[2]) and np.isnan(ref[2])


# ------------------------------------------------------------ the warps ----
def test_homo_warp_and_homo_warp_points_match_jax():
    from rgbmanip_tpu.models.pose_estimator.nets import stereo as JS
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo as PS
    from test_torch_stereo import projections
    rng = np.random.default_rng(8)
    Hv = 16
    feat = rng.normal(size=(B, Hv, Hv, 8)).astype(np.float32)
    P1, P2 = projections(Hv, 9)
    dv = np.broadcast_to(0.1 + 0.15 * np.arange(8, dtype=np.float32), (B, 8)).copy()
    one = JS.homo_warp(*(jnp.asarray(a[0]) for a in (feat, P2, P1, dv)))
    mine = PS.homo_warp(*(torch.from_numpy(a[0]) for a in (feat, P2, P1, dv)))
    np.testing.assert_allclose(mine.numpy(), np.asarray(one), rtol=0, atol=1e-4)
    px = rng.integers(0, Hv, size=(B, 20)).astype(np.int32)
    py = rng.integers(0, Hv, size=(B, 20)).astype(np.int32)
    ref = JS.homo_warp_points(*(jnp.asarray(a) for a in (feat, P2, P1, dv, px, py)))
    out = PS.homo_warp_points(*(torch.from_numpy(a) for a in (feat, P2, P1, dv, px, py)))
    assert out.shape == ref.shape == (B, 20, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    # the points' warp is the full warp read at the points
    full = PS.homo_warp_batched(*(torch.from_numpy(a) for a in (feat, P2, P1, dv)))
    at = full.permute(0, 2, 3, 1, 4)[torch.arange(B)[:, None], torch.from_numpy(py).long(),
                                       torch.from_numpy(px).long()]
    np.testing.assert_allclose(out.numpy(), at.numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------- fusion and transforms ---
def test_view_fusion_matches_jax():
    from rgbmanip_tpu.models.pose_estimator.nets.fusion import ViewFusion as JF
    from rgbmanip_tpu_torch.models.pose_estimator.nets.fusion import (ViewFusion,
                                                                      load_flax_params)
    rng = np.random.default_rng(10)
    f1 = rng.normal(size=(B, 32, 40)).astype(np.float32)
    f2 = rng.normal(size=(B, 32, 24)).astype(np.float32)
    jm = JF(dim=64, depth=2, num_heads=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(f1), jnp.asarray(f2))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(scale=0.1, size=a.shape).astype(np.float32),
        params)                              # LayerNorm and biases away from 1 and 0
    ref = jm.apply({"params": params}, jnp.asarray(f1), jnp.asarray(f2))
    net = ViewFusion(40, 24, dim=64, depth=2, num_heads=4)
    load_flax_params(net, params)
    with torch.no_grad():
        out = net(torch.from_numpy(f1), torch.from_numpy(f2))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("fn", ["quat_mul", "quat_conjugate", "quat_rotate", "quat_to_matrix",
                                "matrix_to_quat", "axis_angle_to_quat", "quat_to_axis",
                                "compute_quat_err", "frame_quat", "lookat_quat", "pose_mul",
                                "pose_inv"])
def test_tensor_transform_matches_jax(fn):
    import rgbmanip_tpu.ops.transform as JT
    import rgbmanip_tpu_torch.ops.transform as PT
    rng = np.random.default_rng(11)
    n = 16
    q1, q2 = unit_quats(rng, n), unit_quats(rng, n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    mats = np.asarray(JT.quat_to_matrix(jnp.asarray(q1)))
    mats2 = np.asarray(JT.quat_to_matrix(jnp.asarray(q2)))
    direction = v.copy()
    direction[0] = [0.0, 0.0, 2.0]                 # along +z: the degenerate branch
    direction[1] = [0.0, 0.0, -1.0]
    args = {"quat_mul": (q1, q2), "quat_conjugate": (q1,), "quat_rotate": (q1, v),
            "quat_to_matrix": (q1,), "matrix_to_quat": (mats,),
            "axis_angle_to_quat": (v, v[:, 0]), "quat_to_axis": (q1, 1),
            "compute_quat_err": (q1, q2), "frame_quat": (mats, mats2),
            "lookat_quat": (direction,), "pose_mul": (v, q1, v[::-1].copy(), q2),
            "pose_inv": (v, q1)}[fn]
    ref = getattr(JT, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    out = getattr(PT, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                            for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=2e-6)


# ------------------------------------------------------ the baseline row ---
def test_train_main_runs_the_baseline_estimator(tmp_path, monkeypatch):
    """``python -m rgbmanip_tpu_torch.train pose_estimator=adapose_baseline``
    (the default heuristic controller on the cabinet) on the CPU at 64 px:
    the estimator it builds has no stereo fusion, every estimate goes
    through it, and the run writes its result."""
    import json

    from rgbmanip_tpu_torch import train as T
    built = []
    orig = T.prepare_pose_estimator

    def keep(*a, **k):
        built.append(orig(*a, **k))
        return built[-1]
    monkeypatch.setattr(T, "prepare_pose_estimator", keep)
    result = T.main(["pose_estimator=adapose_baseline", "pose_estimator.img_size=64",
                     "pose_estimator.n_pts=128", "task.num_envs=2", "train.total_round=2",
                     "device=cpu", f"train.save_dir={tmp_path}", f"train.log_dir={tmp_path}"])
    est = built[0]
    assert isinstance(est, port_adapose.AdaPoseEstimator)
    assert not est.model.stereo_fusion and est.model.backend == "resnet34"
    assert result["rounds"] == 2
    saved = [json.load(open(os.path.join(r, "result.json")))
             for r, _, fs in os.walk(tmp_path) if "result.json" in fs]
    assert result in saved
