"""PSPNet feature extractor (counterpart of
``rgbmanip_tpu/models/pose_estimator/nets/pspnet.py``).

ResNet basic blocks without batch norm (the backends of the JAX module's
table: resnet34, resnet18 and the slim resnet10s), at backbone stride 8
(layers 3 and 4 dilated, the reference), 16 or 32, a pyramid-pooling module
with bins (1, 2, 3, 6), three 2x bilinear upsamples with PReLU and a final
1x1 conv to 32 channels. The public forward takes and returns NHWC like the
JAX module; inside, the convolutions run NCHW. Module names follow the
reference torch state_dict keys (``converter.torch_key_map``). Every module
takes the JAX module's ``dtype`` and computes by flax's rule (``layers``);
the pyramid pooling and the resizes round where the JAX module's do.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ....utils.logger import count
from .layers import Conv2d, PReLU, cumsum

# backend -> (blocks per stage, stage widths, slim 1x1 up_1)
ARCH = {
    "resnet34": ((3, 4, 6, 3), (64, 128, 256, 512), False),
    "resnet18": ((2, 2, 2, 2), (64, 128, 256, 512), False),
    "resnet10s": ((1, 1, 1, 1), (48, 96, 192, 384), True),
}
# backbone_stride -> (stride, dilation) of layers 3 and 4; layers 1 and 2
# have strides 1 and 2. The first block of a stage has dilation 1.
STRIDES = {8: ((1, 2), (1, 4)), 16: ((2, 1), (1, 2)), 32: ((2, 1), (2, 1))}
BINS = (1, 2, 3, 6)
STEM_CH = 64


def arch(backend: str, backbone_stride: int):
    """(blocks, planes, slim, per-stage (stride, dilation)); raises
    ValueError on a backend or stride the JAX module does not have."""
    if backend not in ARCH:
        raise ValueError(f"backend must be one of {sorted(ARCH)}, got {backend!r}")
    if backbone_stride not in STRIDES:
        raise ValueError(f"backbone stride must be one of {sorted(STRIDES)}, "
                         f"got {backbone_stride}")
    blocks, planes, slim = ARCH[backend]
    return blocks, planes, slim, ((1, 1), (2, 1)) + STRIDES[backbone_stride]


def has_downsample(stage: int, planes) -> bool:
    """Whether the first block of ``stage`` (0-based) has a 1x1 downsample
    conv: its input width differs from its own, or it strides. Every stage
    after the first changes width; the first does only when it is narrower
    than the stem (resnet10s). ``ResNetFeats`` and the converter both ask
    this."""
    return stage > 0 or planes[0] != STEM_CH


@functools.cache
def resize_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")`` along
    one axis (``jax.image.scale.compute_weight_mat`` with the triangle
    kernel): half-pixel centres and, when shrinking, a triangle widened by
    the shrink factor (antialiasing), each column normalised; computed in
    f32 and cast to ``dtype`` as jax casts them to the image's dtype. Made
    outside inference mode, so that a cached tensor serves autograd too."""
    with torch.inference_mode(False):
        return _resize_weights(n_in, n_out).to(dtype).to(device)


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    inv_scale = 1.0 / (n_out / n_in)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp_min(1.0 - x / max(inv_scale, 1.0), 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x, size):
    """NCHW bilinear resize with the semantics of ``jax.image.resize(...,
    "bilinear")``: half-pixel centres and, when shrinking, an antialiasing
    (widened triangle) kernel. At f32, ``F.interpolate(antialias=True)``,
    which computes exactly that (without antialiasing a 6 -> 2 shrink
    differs by more than 1). In a reduced dtype, as jax computes it: one
    contraction with each axis's weights (``resize_weights``), rows first,
    each rounded to x's dtype; an axis whose size does not change is left
    alone."""
    if x.dtype == torch.float32:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                             antialias=True)
    h, w = size
    if x.shape[-2] != h:
        x = torch.einsum("bchw,hi->bciw", x, resize_weights(x.shape[-2], h, x.dtype,
                                                            x.device))
    if x.shape[-1] != w:
        x = torch.einsum("bchw,wj->bchj", x, resize_weights(x.shape[-1], w, x.dtype,
                                                            x.device))
    return x


def _edges(n: int, s: int):
    """The s pooling windows of ``AdaptiveAvgPool2d`` over n cells: floor
    starts and ceil ends."""
    return [i * n // s for i in range(s)], [-((-(i + 1) * n) // s) for i in range(s)]


@functools.cache
def pool_tables(H: int, W: int, dtype, device):
    """The windows of every bin of ``BINS`` over an H x W map, bin after bin
    and row-major (1 + 4 + 9 + 36): (4, n) flat indices into the padded
    (H + 1) x (W + 1) integral image of each window's corners, bottom-right,
    top-right, bottom-left, top-left, and (n,) window areas in ``dtype``.
    Made on the device once per shape, outside inference mode, so that a
    cached tensor serves autograd too."""
    corners, areas = [], []
    for s in BINS:
        (ylo, yhi), (xlo, xhi) = _edges(H, s), _edges(W, s)
        for a, b in zip(ylo, yhi):
            for c, d in zip(xlo, xhi):
                corners.append([b * (W + 1) + d, a * (W + 1) + d,
                                b * (W + 1) + c, a * (W + 1) + c])
                areas.append((b - a) * (d - c))
    with torch.inference_mode(False):
        return (torch.tensor(corners).T.contiguous().to(device),
                torch.tensor(areas, dtype=torch.float32).to(dtype).to(device))


class _Bin(torch.autograd.Function):
    """One bin's (B, C, s, s) maps, cut from the pooled windows of every
    bin, with the gradient that autograd gives the bin's own integral-image
    pooling: the divide, each corner's gradient scattered and the four added
    in the order autograd adds them (top-left, bottom-left, top-right,
    bottom-right), the padding dropped and both cumulative sums reversed,
    each step rounded in x's dtype. Autograd through the one integral image
    of all bins would add every bin's corners before the reversed sums, and
    round otherwise."""

    @staticmethod
    def forward(ctx, x, pooled, corners, area):
        ctx.save_for_backward(corners, area)
        ctx.hw = x.shape[-2:]
        return pooled.unflatten(2, area.shape).contiguous()

    @staticmethod
    def backward(ctx, grad):
        corners, area = ctx.saved_tensors
        (H, W), (B, C) = ctx.hw, grad.shape[:2]
        g = (grad / area).flatten(2)

        def at(k, v):
            return grad.new_zeros(B, C, (H + 1) * (W + 1)).index_add_(2, corners[k], v)
        d = (((at(3, g) + at(2, -g)) + at(1, -g)) + at(0, g)).unflatten(2, (H + 1, W + 1))
        d = d[:, :, 1:, 1:]
        for dim in (3, 2):
            d = cumsum(d.flip(dim), dim).flip(dim)
        return d, None, None, None


def pyramid_pool(x):
    """``AdaptiveAvgPool2d`` of x (B, C, H, W) to each bin of ``BINS``, in
    x's reduced dtype as the JAX module computes it: an integral image (a
    cumulative sum over rows, then columns), the four corners of every
    window read by one gather (``pool_tables``), ``a - b - c + d`` and the
    divide by the area, each op rounded in x's dtype. The integral image is
    built once for all bins, and nothing is copied from the host."""
    B, C, H, W = x.shape
    corners, area = pool_tables(H, W, x.dtype, x.device)
    with torch.no_grad():
        cs = F.pad(cumsum(cumsum(x, 2), 3), (1, 0, 1, 0)).flatten(2)
        g = cs.index_select(2, corners.flatten()).unflatten(2, corners.shape)
        pooled = (g[:, :, 0] - g[:, :, 1] - g[:, :, 2] + g[:, :, 3]) / area
    out, o = [], 0
    for s in BINS:
        out.append(_Bin.apply(x, pooled[:, :, o:o + s * s], corners[:, o:o + s * s],
                              area[o:o + s * s].view(s, s)))
        o += s * s
    return out


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation, dilation=dilation,
                            bias=False, dtype=dtype)
        self.downsample = (nn.Sequential(Conv2d(in_ch, planes, 1, stride, bias=False,
                                                dtype=dtype))
                           if downsample else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetFeats(nn.Module):
    def __init__(self, blocks, planes, stages, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, STEM_CH, 7, 2, padding=3, bias=False, dtype=dtype)
        in_ch = STEM_CH
        for li, (p, n, (s, d)) in enumerate(zip(planes, blocks, stages), start=1):
            layer = [BasicBlock(in_ch, p, stride=s, downsample=has_downsample(li - 1, planes),
                                dtype=dtype)]
            layer += [BasicBlock(p, p, dilation=d, dtype=dtype) for _ in range(1, n)]
            setattr(self, f"layer{li}", nn.Sequential(*layer))
            in_ch = p

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class PSPModule(nn.Module):
    def __init__(self, feat_dim: int, dtype=torch.float32):
        super().__init__()
        red = feat_dim // len(BINS)
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b), Conv2d(feat_dim, red, 1, bias=False,
                                                          dtype=dtype))
            for b in BINS)

    def forward(self, x):
        """At f32 each stage pools; in a reduced dtype ``pyramid_pool`` pools
        every bin and each stage's conv takes its bin."""
        size = x.shape[-2:]
        if x.dtype == torch.float32:
            return torch.cat([x] + [resize_bilinear(F.relu(s(x)), size)
                                    for s in self.stages], dim=1)
        count(psp_pool_gathers=1)
        return torch.cat([x] + [resize_bilinear(F.relu(conv(p)), size)
                                for (_, conv), p in zip(self.stages, pyramid_pool(x))],
                         dim=1)


class PSPUpsample(nn.Module):
    """2x resize, conv, PReLU: f32 out whatever the dtype (``layers.PReLU``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, out_ch, kernel, padding=(kernel - 1) // 2, dtype=dtype),
            PReLU(1, init=0.25))

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(resize_bilinear(x, (2 * h, 2 * w)))


class PSPNet(nn.Module):
    """Features at S / (backbone_stride / 8): the backbone's stride, then
    three 2x upsamples (full resolution at stride 8, 1/4 at stride 32), in
    ``dtype`` (``layers``)."""

    def __init__(self, backend: str = "resnet34", backbone_stride: int = 8,
                 dtype=torch.float32):
        super().__init__()
        blocks, planes, slim, stages = arch(backend, backbone_stride)
        self.feats = ResNetFeats(blocks, planes, stages, dtype)
        self.psp = PSPModule(planes[3], dtype)
        self.up_1 = PSPUpsample(2 * planes[3], 256, kernel=1 if slim else 3, dtype=dtype)
        self.up_2 = PSPUpsample(256, 64, dtype=dtype)
        self.up_3 = PSPUpsample(64, 64, dtype=dtype)
        self.final = Conv2d(64, 32, 1, dtype=dtype)

    def forward(self, x):
        """x (B, H, W, 3) -> features (B, H/4, W/4, 32) in the dtype."""
        p = self.psp(self.feats(x.permute(0, 3, 1, 2)))
        return self.final(self.up_3(self.up_2(self.up_1(p)))).permute(0, 2, 3, 1)
