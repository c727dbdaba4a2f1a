"""The cost volume's layout on the way into the 3-D U-Net, on the CPU.

On the card the fused volume and every activation of ``CostRegNet`` are
channels-last-3d: the logical shape (B, C, D, H, W), the memory
(B, D, H, W, C), which is how K2 and the eager warp write the volume
(``stereo.unet_input``). Here: the U-Net on a channels-last volume equals its
run on the contiguous one within f32 rounding and keeps the layout through
every module; ``volume_points`` reads a channels-last volume in place, bit for
bit, without a volume-sized temporary; ``fused_volume_plain`` (K2's plain
twin) returns the channels-last view; and off the card the U-Net's input stays
contiguous NCDHW and the ``ndhwc_volumes`` counter stays at 0. The card's side
is in ``test_torch_cuda.py``. The file imports neither JAX nor the JAX
package."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
from rgbmanip_tpu_torch.utils import logger as L

torch.set_num_threads(2)

CL = torch.channels_last_3d
INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bits(t):
    return t.contiguous().view(INT[t.dtype])


def unet(seed=0, dtype=torch.float32):
    net = stereo.CostRegNet(32, base=8, dtype=dtype)
    return stereo.flax_init_(net, torch.Generator().manual_seed(seed))


def layouts(net):
    """{module name: (channels-last, contiguous)} of each submodule's output
    at the next forward."""
    seen = {}
    for name, mod in net.named_modules():
        if name:
            mod.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(
                    name, (o.is_contiguous(memory_format=CL), o.is_contiguous())))
    return seen


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_unet_on_a_channels_last_volume_equals_its_contiguous_run(mode):
    """f32, in eval mode (running statistics) and in train mode (the batch's).
    Tolerance: 64 f32 ulps of the output's largest magnitude. Both runs are
    the same f32 math; the CPU's channels-last convolutions and the
    statistics' reductions add the same terms in another order (up to
    27 x 64 products a convolution, 11 layers deep), which moves each result
    by a few ulps of its scale, layer after layer."""
    net = unet().train(mode == "train")
    g = torch.Generator().manual_seed(1)
    vol = torch.randn(2, 8, 16, 16, 32, generator=g).permute(0, 4, 1, 2, 3)  # (B, C, D, H, W)
    assert vol.is_contiguous(memory_format=CL) and not vol.is_contiguous()
    seen = layouts(net)
    with torch.no_grad():
        want = net(vol.contiguous())
        assert all(c and not cl for cl, c in list(seen.values())[:-1])
        seen.clear()
        got = net(vol)
    assert got.shape == want.shape == (2, 1, 8, 16, 16)
    # every module's output stays channels-last (``prob``'s one channel is
    # both layouts at once)
    assert len(seen) == 31 and all(cl for cl, _ in seen.values()), seen
    assert all(not c for name, (_, c) in seen.items() if name != "prob")
    assert got.is_contiguous(memory_format=CL)
    tol = 64 * torch.finfo(torch.float32).eps * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


class Allocations(TorchDispatchMode):
    """Every op dispatched within, with the storage of each tensor it
    returns."""

    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.outs.append((str(func), t.numel(), t.untyped_storage().data_ptr()))
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_volume_points_read_a_channels_last_volume_in_place(dtype):
    """The pose features' gather from the U-Net's channels-last volume equals
    the gather from a contiguous copy bit for bit, and every volume-sized
    tensor it makes is a view of the volume's own storage: no copy."""
    B, D, H, W, C, N = 3, 5, 6, 7, 8, 40
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(B, D, H, W, C, generator=g).to(dtype)
    idx = torch.randint(0, H * W, (B, N), generator=g)
    vol = rows.permute(0, 4, 1, 2, 3)                        # channels-last (B, C, D, H, W)
    assert vol.is_contiguous(memory_format=CL)
    want = stereo.volume_points(vol.contiguous(), idx)
    with Allocations() as seen:
        got = stereo.volume_points(vol, idx)
    assert got.is_contiguous() and got.shape == (B, N, D, C)
    assert torch.equal(bits(got), bits(want))
    copied = rows.permute(0, 2, 3, 1, 4).reshape(B, H * W, D, C)     # (B, HW, D, C), a copy
    assert torch.equal(bits(got), bits(copied[torch.arange(B)[:, None], idx]))
    big = [(op, ptr) for op, n, ptr in seen.outs if n >= vol.numel()]
    assert big and all(ptr == vol.untyped_storage().data_ptr() for _, ptr in big), big
    assert max(n for op, n, ptr in seen.outs if ptr != vol.untyped_storage().data_ptr()) \
        == B * N * D * C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_volume_plain_returns_the_channels_last_view(dtype):
    """K2's plain twin: the (B, D, H, W, C) sum of the reference features and
    the warp, returned as the U-Net's (B, C, D, H, W) without a copy, with the
    values of the contiguous volume it returned before; in that layout also
    where the reference features are a permuted view of NCHW memory, as the
    PSPNet hands them."""
    from test_torch_plane_sweep import eager, features, geometry

    B, H, W, C, D = 2, 12, 16, 8, 6
    p1, p2, depth = geometry(B, H, W, D, seed=4)
    f1, f2 = features(B, H, W, C, dtype, seed=5)
    want = eager(f2, f1, p2, p1, depth)
    assert want.is_contiguous()
    perm = f1.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    for ref in (f1, perm):
        got = stereo.fused_volume_plain(f2, ref, p2, p1, depth)
        assert got.shape == want.shape == (B, C, D, H, W) and got.dtype == dtype
        assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
        assert got.permute(0, 2, 3, 4, 1).is_contiguous()   # the rows themselves
        assert torch.equal(bits(got), bits(want))


def test_unet_input_is_contiguous_ncdhw_off_the_card():
    """Off the card the U-Net's input is what it was: a contiguous copy of
    the permuted volume, with the same values; a volume already contiguous is
    taken as it is."""
    rows = torch.randn(2, 4, 6, 6, 8)
    vol = stereo.unet_input(rows.permute(0, 4, 1, 2, 3))
    assert vol.is_contiguous() and torch.equal(vol, rows.permute(0, 4, 1, 2, 3))
    assert stereo.unet_input(vol) is vol


def test_no_ndhwc_volume_is_counted_on_the_cpu():
    """Under a profiler the estimate's ``stereo/cost_reg`` span runs both
    views' U-Nets, and on the CPU counts no channels-last volume (on the card
    2 a call, ``test_torch_cuda.py``)."""
    cfg = dict(img_size=64, n_pts=128, backend="resnet18", backbone_stride=32, volume_scale=8,
               n_depth=16, d_interval=0.15, warp_mode="nearest", load=False)
    est = AdaPoseEstimator(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    B = 2
    rgb = rng.uniform(size=(2, B, 480, 640, 3)).astype(np.float32)
    mask = np.zeros((2, B, 480, 640), bool)
    mask[:, :, 100:220, 200:320] = True
    K = np.repeat(np.array([[[500, 0, 320], [0, 500, 240], [0, 0, 1]]], np.float32), B, 0)
    ext = np.repeat(np.eye(4, dtype=np.float32)[None], B, 0)
    ext[:, 2, 3] = 1.0
    ext2 = ext.copy()
    ext2[:, 0, 3] = 0.05
    L.SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            est.estimate_full(K, rgb[0], mask[0], ext, rgb[1], mask[1], ext2)
        s = L.SPANS.summary()
    finally:
        L.SPANS.reset()
    assert s["stereo/cost_reg"]["calls"] == 1
    assert s["stereo/cost_reg"].get("ndhwc_volumes", 0) == 0
