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


class AdaptiveAvgPool2d(nn.Module):
    """``AdaptiveAvgPool2d``: at f32 PyTorch's own; in a reduced dtype as the
    JAX module computes it, through integral images (a cumulative sum over
    rows, then columns, and four corners per window) in x's dtype."""

    def __init__(self, out_size: int):
        super().__init__()
        self.out_size = out_size

    def forward(self, x):
        if x.dtype == torch.float32:
            return F.adaptive_avg_pool2d(x, self.out_size)
        B, C, H, W = x.shape
        cs = F.pad(cumsum(cumsum(x, 2), 3), (1, 0, 1, 0))
        (ylo, yhi), (xlo, xhi) = _edges(H, self.out_size), _edges(W, self.out_size)

        def at(rows, cols):
            return cs[:, :, rows][:, :, :, cols]
        s = at(yhi, xhi) - at(ylo, xhi) - at(yhi, xlo) + at(ylo, xlo)
        area = torch.tensor([[(b - a) * (d - c) for c, d in zip(xlo, xhi)]
                             for a, b in zip(ylo, yhi)], dtype=torch.float32)
        return s / area.to(device=x.device, dtype=x.dtype)


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
            nn.Sequential(AdaptiveAvgPool2d(b), Conv2d(feat_dim, red, 1, bias=False,
                                                       dtype=dtype))
            for b in BINS)

    def forward(self, x):
        size = x.shape[-2:]
        return torch.cat([x] + [resize_bilinear(F.relu(s(x)), size)
                                for s in self.stages], dim=1)


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
