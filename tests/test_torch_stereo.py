"""The port's PSPNet and StereoPoseNetWithDepth against the JAX modules at a
small size (B=2, img_size 64, 128 points, 8 depth hypotheses), with random
JAX parameters carried across by ``load_jax_params``.

Tolerances: both sides compute in f32, but the convolutions and matrix
products sum in another order (XLA's CPU kernels against oneDNN/ATen, and
the JAX side's banded execution plan of the 3-D U-Net), so values agree to
a few ulps times the depth of the network: 1e-4 absolute on outputs of
order 1.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.models.pose_estimator.converter import load_jax_params
from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo as port_stereo

torch.set_num_threads(2)

S, NPTS, D, B = 64, 128, 8, 2
KNOBS = dict(backend="resnet18", backbone_stride=32, volume_scale=8)
ATOL = 1e-4


def look_at(eye, target=(0.0, 0.0, 0.0)):
    """World -> camera extrinsic (4, 4) of a camera at ``eye`` looking at
    ``target`` (camera z forward, y down)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, -1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, y, z])
    E[:3, 3] = -E[:3, :3] @ eye
    return E


def projections(size, seed):
    """(B, 4, 4) full projections K @ E of two views per env."""
    rng = np.random.default_rng(seed)
    K = np.array([[1.1 * size, 0, size / 2], [0, 1.1 * size, size / 2], [0, 0, 1]])
    out = []
    for _ in range(2):
        views = []
        for _ in range(B):
            eye = np.array([0.0, -0.8, 0.4]) + rng.normal(scale=0.15, size=3)
            P = np.eye(4)
            P[:3] = K @ look_at(eye)[:3]
            views.append(P)
        out.append(np.stack(views).astype(np.float32))
    return out


def randomise(tree, rng):
    """Perturb BatchNorm and PReLU leaves away from their trivial init, so
    that the mapping of every leaf matters."""
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in ("scale", "var"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "prelu") or (k == "bias" and "bn" in path):
                node[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
            else:
                node[k] = np.asarray(v)
    walk(tree, ())
    return tree


@pytest.fixture(scope="module")
def weights():
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu.ops.preprocess import depth_hypotheses

    model = StereoPoseNetWithDepth(regress_pose=True, warp_mode="nearest", **KNOBS)
    args = (jnp.zeros((1, S, S, 3)), jnp.zeros((1, NPTS), jnp.int32),
            jnp.zeros((1, S, S, 3)), jnp.zeros((1, NPTS), jnp.int32),
            jnp.eye(4)[None], jnp.eye(4)[None], depth_hypotheses(1, n=D))
    variables = jax.jit(lambda k, *a: model.init(k, *a, train=False))(
        jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(0)
    to_np = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    return randomise(to_np["params"], rng), randomise(to_np["batch_stats"], rng)


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    img1, img2 = (rng.normal(size=(B, S, S, 3)).astype(np.float32) for _ in range(2))
    ch1, ch2 = (rng.integers(0, S * S, size=(B, NPTS)).astype(np.int32) for _ in range(2))
    P1, P2 = projections(S, seed)
    dv = np.broadcast_to(0.1 + 0.15 * np.arange(D, dtype=np.float32), (B, D)).copy()
    return img1, ch1, img2, ch2, P1, P2, dv


def test_pspnet_features_match_jax(weights):
    from rgbmanip_tpu.models.pose_estimator.nets.pspnet import PSPNet

    params, batch_stats = weights
    x = np.random.default_rng(2).normal(size=(B, S, S, 3)).astype(np.float32)
    ref = np.asarray(PSPNet(backend="resnet18", backbone_stride=32).apply(
        {"params": params["img_extractor"]}, jnp.asarray(x)))
    net = port_stereo.StereoPoseNetWithDepth(**KNOBS)
    load_jax_params(net, params, batch_stats)
    with torch.no_grad():
        out = net.img_extractor(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (B, S // 4, S // 4, 32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("size", [(6, 2), (3, 2), (6, 3), (2, 4), (6, 6)])
def test_psp_resize_matches_jax_image_resize(size):
    """jax.image.resize antialiases when it shrinks; the port's resize must
    too (without antialiasing a 6 -> 2 shrink is off by more than 1)."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets.pspnet import resize_bilinear

    a, b = size
    x = np.random.default_rng(a * 10 + b).normal(size=(2, a, a, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, b, b, 5), "bilinear"))
    out = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (b, b))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_homo_warp_batched_matches_jax(mode):
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import homo_warp_batched

    rng = np.random.default_rng(3)
    Hv = S // 8
    feat = rng.normal(size=(B, Hv, Hv, 32)).astype(np.float32)
    P1, P2 = projections(Hv, 4)
    dv = np.broadcast_to(0.1 + 0.15 * np.arange(D, dtype=np.float32), (B, D)).copy()
    ref = np.asarray(homo_warp_batched(jnp.asarray(feat), jnp.asarray(P2),
                                       jnp.asarray(P1), jnp.asarray(dv), mode))
    out = port_stereo.homo_warp_batched(torch.from_numpy(feat), torch.from_numpy(P2),
                                        torch.from_numpy(P1), torch.from_numpy(dv),
                                        mode).numpy()
    assert out.shape == ref.shape == (B, D, Hv, Hv, 32)
    assert (np.abs(ref).sum(-1) > 0).mean() > 0.2   # the views overlap
    differ = np.abs(out - ref).max(-1) > 1e-4       # per (b, d, y, x) tap
    print(f"{mode} warp: {differ.mean():.2e} of the taps differ")
    if mode == "nearest":
        # the two 4x4 inverses round differently; a tap that sits on a
        # rounding boundary may move. Allow one in a thousand.
        assert differ.mean() <= 1e-3
        np.testing.assert_allclose(out[~differ], ref[~differ], rtol=0, atol=1e-6)
    else:
        # the projected coordinates round differently (the 4x4 inverses, and
        # XLA's fused multiply-adds) by ~1e-6 px; the taps' weights follow
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("warp_mode,k2", [pytest.param("nearest", False, id="nearest"),
                                          pytest.param("bilinear", False, id="bilinear"),
                                          pytest.param("bilinear", True, id="bilinear-k2")])
def test_stereo_net_matches_jax(weights, warp_mode, k2, monkeypatch):
    """Against the JAX module as the estimator builds it: its default
    banded execution plan of the 3-D U-Net, which the port runs as Conv3d.
    With ``k2`` the forward takes K2's route as on the card (``k2_applies``
    asked of features on the card): ``fused_volume`` (its plain twin here)
    into the U-Net's (B, C, D, H, W) layout, read without a permuted copy,
    and the pose features gathered from that layout."""
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth

    calls = []
    if k2:
        applies, fused_volume = (port_stereo.StereoPoseNetWithDepth.k2_applies,
                                 port_stereo.fused_volume)
        monkeypatch.setattr(port_stereo.StereoPoseNetWithDepth, "k2_applies",
                            lambda self, feat: applies(self, SimpleNamespace(is_cuda=True)))
        monkeypatch.setattr(port_stereo, "fused_volume",
                            lambda *a: calls.append(1) or fused_volume(*a))
    params, batch_stats = weights
    x = inputs()
    model = StereoPoseNetWithDepth(regress_pose=True, warp_mode=warp_mode, **KNOBS)
    ref = model.apply({"params": params, "batch_stats": batch_stats},
                      *(jnp.asarray(a) for a in x), train=False)
    net = port_stereo.StereoPoseNetWithDepth(warp_mode=warp_mode, **KNOBS).eval()
    load_jax_params(net, params, batch_stats)
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in x))
    assert len(calls) == (2 if k2 else 0)
    assert set(out) == set(ref)
    for k in sorted(ref):
        r = np.asarray(ref[k])
        assert out[k].shape == r.shape, k
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("knob,match", [(dict(backend="resnet50"), "backend"),
                                        (dict(backbone_stride=64), "stride")])
def test_stereo_net_rejects_unknown_backend_and_stride(knob, match):
    """As the JAX module's tables do: resnet34/18/10s at stride 8, 16 or 32."""
    with pytest.raises(ValueError, match=match):
        port_stereo.StereoPoseNetWithDepth(**{**KNOBS, **knob})


def test_ortho6d_matches_jax():
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import ortho6d_to_mat

    r6 = np.random.default_rng(5).normal(size=(4, 6)).astype(np.float32)
    ref = np.asarray(ortho6d_to_mat(jnp.asarray(r6[:, :3]), jnp.asarray(r6[:, 3:])))
    out = port_stereo.ortho6d_to_mat(torch.from_numpy(r6[:, :3]),
                                     torch.from_numpy(r6[:, 3:])).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape, stride", [((2, 64, 2, 3, 3), 1), ((2, 32, 4, 6, 6), 2)],
                         ids=["conv6", "conv5"])
def test_bf16_conv3d_on_the_cpu_takes_its_weight_gradient_in_f32(shape, stride):
    """The CostRegNet's bf16 ``Conv3d`` on the CPU at its smallest volume
    (the flagship's conv5 and conv6): the forward and the input gradient are
    the bf16 kernel's bit for bit; the weight gradient is the f32 gradient
    of the same bf16 values rounded once, within one bf16 ulp of the bf16
    kernel's where that kernel is sound (PyTorch 2.11's leaves elements of
    it unwritten now and then on the card's machine)."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets.layers import Conv3d

    g = torch.Generator().manual_seed(0)
    m = Conv3d(shape[1], 64, 3, stride, padding=1, bias=False, dtype=torch.bfloat16)
    with torch.no_grad():
        m.weight.copy_(0.05 * torch.randn(m.weight.shape, generator=g))
    x = torch.randn(shape, generator=g).requires_grad_()
    y = m(x)
    up = torch.randn(y.shape, generator=g)
    (y.float() * up).sum().backward()

    xb = x.detach().to(torch.bfloat16).requires_grad_()
    wb = m.weight.detach().to(torch.bfloat16).requires_grad_()
    ref = torch.nn.functional.conv3d(xb, wb, None, stride, 1)
    (ref.float() * up).sum().backward()
    assert torch.equal(y, ref)
    assert torch.equal(x.grad, xb.grad.float())
    f32 = torch.nn.grad.conv3d_weight(xb.detach().float(), wb.shape, up.to(torch.bfloat16).float(),
                                      stride, 1)
    assert torch.equal(m.weight.grad, f32.to(torch.bfloat16).float())
    ulp = torch.exp2(torch.floor(torch.log2(wb.grad.float().abs().clamp_min(1e-30))) - 7)
    assert ((m.weight.grad - wb.grad.float()).abs() <= ulp).all()


def test_cpu_bf16_conv_probe_counts_the_ports_calls_whole():
    """``scripts/cpu_bf16_conv_probe.py`` at 20 calls: the port's layer
    never gives a non-finite weight gradient (PyTorch 2.11's own kernel, on
    the card's machine, did in a quarter to over half of 300 calls)."""
    from rgbmanip_tpu_torch.scripts import cpu_bf16_conv_probe

    out = cpu_bf16_conv_probe.main(["--calls", "20"])
    assert out["B=2"]["port"] == out["B=8"]["port"] == 0
    assert out["calls"] == 20 and out["torch"] == torch.__version__
