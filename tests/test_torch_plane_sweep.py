"""K2, the fused bilinear plane-sweep warp (``ops/plane_sweep.py``), on the
CPU: off the card ``fused_volume`` is its plain twin, the eager warp plus the
fusing add (``nets/stereo.py``: ``homo_warp_batched`` over ``_project`` and
``_sample``) as the U-Net's (B, C, D, H, W), channels-last, in f32 and bf16, both
directions, on a geometry with points on and off the image, behind the
camera and on tap ties (the card's tests use it too); the pose features'
gather from that layout against the permuted gather; the forward taking
K2's route only where it applies (no gradient, bilinear warp, both views
fused, the card), with the same outputs as the eager path; and the same for
v1's network (``StereoPoseNetV1``), whose ``VolumeConv`` reads the fused
volume in that layout as the permute it replaced did. The kernel itself
runs on the card (``tests/test_torch_cuda.py -k k2``). The file imports
neither JAX nor the JAX package."""

import types

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
from rgbmanip_tpu_torch.ops import plane_sweep

torch.set_num_threads(2)

INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
# what ``k2_applies`` reads of features on the card
ON_CARD = types.SimpleNamespace(is_cuda=True)


def bits(t):
    """A tensor's bit patterns, so that -0 and +0 (and NaN payloads) count."""
    return t.contiguous().view(INT[t.dtype])


def look_at(eye, target):
    """World -> camera (4, 4) of a camera at ``eye`` looking at ``target``."""
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, -1.0])
    x /= np.linalg.norm(x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, np.cross(z, x), z])
    E[:3, 3] = -E[:3, :3] @ eye
    return E


def geometry(B, H, W, D, seed, device="cpu"):
    """(proj1, proj2, depth): two views' full projections (B, 4, 4) of
    cameras about 0.5 m from a target, turned up to ~20 degrees apart, so
    that part of each view falls outside the other, at depths 0.1 m apart
    from 0.1 m; the last depth negative (behind the camera). Sample 0 has
    both projections the identity and depths powers of two: every ray lands
    exactly on its own pixel, a tap tie in x and y, and the last row and
    column on the clamped tap."""
    rng = np.random.default_rng(seed)
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]])
    P = np.tile(np.eye(4), (2, B, 1, 1))
    for b in range(1, B):
        target = rng.normal(scale=0.05, size=3)
        for v in range(2):
            eye = target + np.array([0.0, -0.45, 0.2]) + rng.normal(scale=0.12, size=3)
            P[v, b, :3] = K @ look_at(eye, target)[:3]
    depth = np.tile(0.1 + 0.1 * np.arange(D), (B, 1))
    depth[0] = 2.0 ** np.arange(-3, D - 3)
    depth[:, -1] = -0.3
    t = [torch.tensor(x, dtype=torch.float32, device=device) for x in (P[0], P[1], depth)]
    return t[0], t[1], t[2]


def features(B, H, W, C, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(2, B, H, W, C, generator=g)
    f[:, :, 0, 0, :2] = 0.0          # zeros, for the sign of a masked sum
    f[:, :, 1, 1, :2] = -0.0
    return f[0].to(device, dtype), f[1].to(device, dtype)


def eager(src, ref, src_proj, ref_proj, depth):
    """The fused volume as the eager path wrote it before K2: the bilinear
    warp plus the fusing add, then a permuted copy, contiguous NCDHW."""
    w = stereo.homo_warp_batched(src, src_proj, ref_proj, depth, "bilinear")
    return (ref[:, None] + w).permute(0, 4, 1, 2, 3).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["2->1", "1->2"])
def test_plain_twin_equals_the_eager_warp(dtype, direction):
    """Off the card ``fused_volume`` is ``fused_volume_plain``: the eager
    warp and the fusing add, as the U-Net's (B, C, D, H, W) in the
    channels-last-3d layout (no permuted copy), with the values of the
    contiguous volume; and ``geometry`` reaches every case the kernel has to
    get right."""
    B, H, W, C, D = 3, 12, 16, 8, 6
    p1, p2, depth = geometry(B, H, W, D, seed=4)
    f1, f2 = features(B, H, W, C, dtype, seed=5)
    src, ref, sp, rp = (f2, f1, p2, p1) if direction == "2->1" else (f1, f2, p1, p2)
    got = stereo.fused_volume(src, ref, sp, rp, depth)
    want = eager(src, ref, sp, rp, depth)
    assert got.shape == (B, C, D, H, W) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(stereo.fused_volume_plain(src, ref, sp, rp, depth)), bits(want))
    # the cases are there: inside and outside the image, behind the camera,
    # whole-pixel ties and the clamped last column
    rot, trans = stereo._relative_projection(sp, rp)
    px, py, inside = stereo._project(rot, trans, stereo._pixel_rays(H, W, "cpu"),
                                     depth, H, W)
    assert inside.any() and (~inside[:, :-1]).any() and not inside[:, -1].any()
    tie = inside & (px == torch.floor(px)) & (py == torch.floor(py))
    assert tie[0, :-1].all()
    assert (inside & (px == W - 1)).any()


def test_plain_twin_keeps_nan_of_a_singular_view():
    """A view with zero extrinsics (an env with no valid view yet) projects
    to NaN: the eager path's masked sum is NaN there, and so is the twin's."""
    B, H, W, C, D = 2, 8, 8, 8, 4
    p1, p2, depth = geometry(B, H, W, D, seed=1)
    p2[1] = 0.0
    f1, f2 = features(B, H, W, C, torch.float32, seed=2)
    got = stereo.fused_volume(f1, f2, p1, p2, depth)      # into the singular view
    want = eager(f1, f2, p1, p2, depth)
    assert torch.isnan(want[1]).all() and torch.isnan(got[1]).all()
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_volume_points_from_the_unet_layout_equal_the_permuted_gather(dtype):
    B, D, H, W, C, N = 3, 5, 6, 7, 8, 40
    g = torch.Generator().manual_seed(0)
    fused = torch.randn(B, D, H, W, C, generator=g).to(dtype)
    idx = torch.randint(0, H * W, (B, N), generator=g)
    old = stereo.flat_gather(fused.permute(0, 2, 3, 1, 4).reshape(B, H * W, D * C),
                             idx).reshape(B, N, D, C)
    vol = fused.permute(0, 4, 1, 2, 3).contiguous()
    new = stereo.volume_points(vol, idx)
    assert new.is_contiguous() and new.shape == (B, N, D, C)
    assert torch.equal(bits(new), bits(old))
    # and from the channels-last view of the same rows, as the warp writes it
    assert torch.equal(bits(stereo.volume_points(fused.permute(0, 4, 1, 2, 3), idx)), bits(old))
    # and the probability-weighted sum the pose features take of it
    w = torch.rand(B, N, D, 1, generator=g).to(dtype).float()
    assert torch.equal((new.float() * w).sum(2), (old.float() * w).sum(2))


@pytest.fixture
def counted(monkeypatch):
    """K2's route as if on the card: ``k2_applies`` asked of features on the
    card (its rules on the gradient, the warp and the fusion unchanged), and
    ``fused_volume`` (off the card its plain twin) counted."""
    calls = []
    applies, fused_volume = StereoPoseNetWithDepth.k2_applies, stereo.fused_volume
    monkeypatch.setattr(StereoPoseNetWithDepth, "k2_applies",
                        lambda self, feat: applies(self, ON_CARD))
    monkeypatch.setattr(stereo, "fused_volume",
                        lambda *a: calls.append(1) or fused_volume(*a))
    return calls


def net_inputs(B, S, N, D, seed):
    g = torch.Generator().manual_seed(seed)
    p1, p2, depth = geometry(B, S, S, D, seed)
    depth = depth.abs()
    img = [torch.randn(B, S, S, 3, generator=g) for _ in range(2)]
    choose = [torch.randint(0, S * S, (B, N), generator=g) for _ in range(2)]
    return img[0], choose[0], img[1], choose[1], p1, p2, depth


def tiny_net(warp_mode, dtype, **kw):
    torch.manual_seed(0)
    net = StereoPoseNetWithDepth("resnet18", 8, volume_scale=1, warp_mode=warp_mode,
                                 dtype=dtype, **kw)
    return stereo.flax_init_(net, torch.Generator().manual_seed(1)).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_through_k2_equals_the_eager_forward(counted, monkeypatch, dtype):
    net = tiny_net("bilinear", dtype)
    x = net_inputs(2, 32, 16, 8, seed=3)
    on = StereoPoseNetWithDepth.k2_applies
    with torch.no_grad():
        got = net(*x)
        assert len(counted) == 2
        monkeypatch.setattr(StereoPoseNetWithDepth, "k2_applies", lambda self, feat: False)
        want = net(*x)
    assert len(counted) == 2 and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # both views' towers in one batch take it too
    net.fuse_views = True
    with torch.no_grad():
        monkeypatch.setattr(StereoPoseNetWithDepth, "k2_applies", on)
        fused = net(*x)
    assert len(counted) == 4
    assert all(torch.equal(fused[k], want[k]) for k in want)


def test_training_and_the_nearest_warp_take_the_eager_path(counted):
    x = net_inputs(2, 32, 16, 8, seed=3)
    net = tiny_net("bilinear", torch.float32).train()
    out = net(*x)                       # gradients recorded: the eager warp
    out["view1_t"].sum().backward()
    assert not counted
    with torch.no_grad():
        tiny_net("nearest", torch.float32)(*x)
        tiny_net("bilinear", torch.float32, stereo_fusion=False)(*x)
    assert not counted
    with torch.inference_mode():        # the estimator's own mode
        tiny_net("bilinear", torch.float32)(*x)
    assert len(counted) == 2


def test_k2_applies_only_on_the_card():
    net = tiny_net("bilinear", torch.float32)
    f = torch.zeros(1, 8, 8, 32)
    with torch.no_grad():
        assert not net.k2_applies(f)
        # on the card whatever the features' dtype and width
        assert net.k2_applies(ON_CARD)
        assert not tiny_net("nearest", torch.float32).k2_applies(ON_CARD)
    assert not net.k2_applies(ON_CARD)           # a gradient recorded


def test_warp_fuse_checks_its_arguments():
    B, H, W, C, D = 1, 4, 4, 8, 3
    f = torch.zeros(B, H, W, C)
    rays, trans, depth = torch.zeros(B, 3, H * W), torch.zeros(B, 3), torch.ones(B, D)
    with pytest.raises(ValueError, match="card"):
        plane_sweep.warp_fuse(f, f, rays, trans, depth)
    with pytest.raises(ValueError, match="one"):
        plane_sweep.warp_fuse(f, f[:, :2], rays, trans, depth)
    with pytest.raises(ValueError, match="both"):
        plane_sweep.warp_fuse(f, f.bfloat16(), rays, trans, depth)
    with pytest.raises(ValueError, match="rays"):
        plane_sweep.warp_fuse(f, f, rays[:, :, :3], trans, depth)
    with pytest.raises(ValueError, match="depth"):
        plane_sweep.warp_fuse(f, f, rays, trans, depth.double())
    with pytest.raises(ValueError, match="both"):
        plane_sweep.warp_fuse(f.half(), f.half(), rays, trans, depth)


# ------------------------------------------------------------ v1 --
def tiny_v1(dtype):
    net = stereo.StereoPoseNetV1("resnet18", n_depth=8, dtype=dtype)
    return stereo.flax_init_(net, torch.Generator().manual_seed(1)).eval()


@pytest.fixture
def counted_v1(monkeypatch):
    return v1_on_card(monkeypatch)


def v1_on_card(monkeypatch):
    """v1's K2 route as if on the card: ``StereoPoseNetV1.k2_applies`` asked
    of features on the card (its rule on the gradient unchanged), and
    ``fused_volume`` (off the card its plain twin) counted."""
    calls = []
    applies, fused_volume = stereo.StereoPoseNetV1.k2_applies, stereo.fused_volume
    monkeypatch.setattr(stereo.StereoPoseNetV1, "k2_applies",
                        lambda self, feat: applies(self, ON_CARD))
    monkeypatch.setattr(stereo, "fused_volume",
                        lambda *a: calls.append(1) or fused_volume(*a))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_volume_conv_on_the_fused_view_equals_the_old_permute_path(dtype):
    """``VolumeConv`` on the fused volume as both routes return it (the
    (B, C, D, H, W) view over channels-last-3d memory, read in place) against
    the forward it replaced, which took the eager sum ``ref[:, None] + warped``
    as (B, D, H, W, C) and permuted it back: the same bits, with BatchNorm
    statistics away from the identity."""
    B, S, D, C = 2, 24, 6, 32
    p1, p2, depth = geometry(B, S, S, D, seed=3)
    f1, f2 = features(B, S, S, C, dtype, seed=4)
    f1 = f1.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)   # as the PSPNet hands it
    vc = stereo.flax_init_(stereo.VolumeConv(C, dtype), torch.Generator().manual_seed(1)).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for i in range(3):
            bn = getattr(vc, f"bn_{i}")
            for t, lo, hi in ((bn.running_mean, -0.1, 0.1), (bn.running_var, 0.5, 1.5),
                              (bn.weight, 0.5, 1.5), (bn.bias, -0.1, 0.1)):
                t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))

        def old(x):
            x = x.permute(0, 4, 1, 2, 3)
            for i in range(3):
                x = torch.relu(getattr(vc, f"bn_{i}")(getattr(vc, f"conv_{i}")(x)))
            return x[:, 0].permute(0, 2, 3, 1)
        want = old(f1[:, None] + stereo.homo_warp_batched(f2, p2, p1, depth, "bilinear"))
        vol = stereo.fused_volume_plain(f2, f1, p2, p1, depth)
        seen = []
        hook = vc.conv_0.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
        got = vc(vol)
        hook.remove()
    assert seen[0] is vol                   # no permute back, no copy in the module
    assert got.shape == (B, S, S, D) and got.dtype == dtype
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v1_forward_through_k2_equals_the_eager_forward(counted_v1, monkeypatch, dtype):
    """``StereoPoseNetV1`` builds both fused volumes through ``fused_volume``
    (K2's entry) where K2 applies, and through its plain twin where it does
    not: the same outputs bit for bit."""
    net = tiny_v1(dtype)
    x = net_inputs(2, 32, 16, 8, seed=3)
    with torch.no_grad():
        got = net(*x)
        assert len(counted_v1) == 2
        monkeypatch.setattr(stereo.StereoPoseNetV1, "k2_applies", lambda self, feat: False)
        want = net(*x)
    assert len(counted_v1) == 2 and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_v1_k2_applies_only_on_the_card_without_a_gradient(monkeypatch):
    net = tiny_v1(torch.float32)
    with torch.no_grad():
        assert not net.k2_applies(torch.zeros(1, 8, 8, 32))
        assert net.k2_applies(ON_CARD)
    assert not net.k2_applies(ON_CARD)     # a gradient recorded
    calls = v1_on_card(monkeypatch)
    x = net_inputs(2, 32, 16, 8, seed=3)
    out = net.train()(*x)                  # training: the eager warp
    out["view1_t"].sum().backward()
    assert not calls
    with torch.inference_mode():           # the estimator's own mode
        net.eval()(*x)
    assert len(calls) == 2
