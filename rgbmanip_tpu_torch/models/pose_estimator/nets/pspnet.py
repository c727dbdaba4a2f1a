"""PSPNet feature extractor (counterpart of
``rgbmanip_tpu/models/pose_estimator/nets/pspnet.py``).

ResNet basic blocks without batch norm (the backends of the JAX module's
table: resnet34, resnet18 and the slim resnet10s), at backbone stride 8
(layers 3 and 4 dilated, the reference), 16 or 32, a pyramid-pooling module
with bins (1, 2, 3, 6), three 2x bilinear upsamples with PReLU and a final
1x1 conv to 32 channels. The public forward takes and returns NHWC like the
JAX module; inside, the convolutions run NCHW. Module names follow the reference torch state_dict
keys (``converter.torch_key_map``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

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


def resize_bilinear(x, size):
    """NCHW bilinear resize with the semantics of ``jax.image.resize(...,
    "bilinear")``: half-pixel centres and, when shrinking, an antialiasing
    (widened triangle) kernel. ``antialias=True`` gives exactly that;
    without it a 6 -> 2 shrink differs by more than 1."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride, bias=False))
                           if downsample else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetFeats(nn.Module):
    def __init__(self, blocks, planes, stages):
        super().__init__()
        self.conv1 = nn.Conv2d(3, STEM_CH, 7, 2, padding=3, bias=False)
        in_ch = STEM_CH
        for li, (p, n, (s, d)) in enumerate(zip(planes, blocks, stages), start=1):
            layer = [BasicBlock(in_ch, p, stride=s, downsample=has_downsample(li - 1, planes))]
            layer += [BasicBlock(p, p, dilation=d) for _ in range(1, n)]
            setattr(self, f"layer{li}", nn.Sequential(*layer))
            in_ch = p

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class PSPModule(nn.Module):
    def __init__(self, feat_dim: int):
        super().__init__()
        red = feat_dim // len(BINS)
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b), nn.Conv2d(feat_dim, red, 1, bias=False))
            for b in BINS)

    def forward(self, x):
        size = x.shape[-2:]
        return torch.cat([x] + [resize_bilinear(F.relu(s(x)), size)
                                for s in self.stages], dim=1)


class PSPUpsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, kernel, padding=(kernel - 1) // 2),
            nn.PReLU(1, init=0.25))

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(resize_bilinear(x, (2 * h, 2 * w)))


class PSPNet(nn.Module):
    """Features at S / (backbone_stride / 8): the backbone's stride, then
    three 2x upsamples (full resolution at stride 8, 1/4 at stride 32)."""

    def __init__(self, backend: str = "resnet34", backbone_stride: int = 8):
        super().__init__()
        blocks, planes, slim, stages = arch(backend, backbone_stride)
        self.feats = ResNetFeats(blocks, planes, stages)
        self.psp = PSPModule(planes[3])
        self.up_1 = PSPUpsample(2 * planes[3], 256, kernel=1 if slim else 3)
        self.up_2 = PSPUpsample(256, 64)
        self.up_3 = PSPUpsample(64, 64)
        self.final = nn.Conv2d(64, 32, 1)

    def forward(self, x):
        """x (B, H, W, 3) -> features (B, H/4, W/4, 32)."""
        p = self.psp(self.feats(x.permute(0, 3, 1, 2)))
        return self.final(self.up_3(self.up_2(self.up_1(p)))).permute(0, 2, 3, 1)
