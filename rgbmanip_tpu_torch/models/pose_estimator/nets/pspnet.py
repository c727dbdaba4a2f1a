"""PSPNet feature extractor (counterpart of
``rgbmanip_tpu/models/pose_estimator/nets/pspnet.py``).

ResNet-18 basic blocks without batch norm at backbone stride 32 (the
production configuration; the JAX package's other backends and strides are
not ported yet), a pyramid-pooling module with bins (1, 2, 3, 6), three 2x
bilinear upsamples with PReLU and a final 1x1 conv to 32 channels. The
public forward takes and returns NHWC like the JAX module; inside, the
convolutions run NCHW. Module names follow the reference torch state_dict
keys (``converter.torch_key_map``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS = (2, 2, 2, 2)                  # resnet18
PLANES = (64, 128, 256, 512)
LAYER_STRIDES = (1, 2, 2, 2)           # backbone_stride 32: no dilation
BINS = (1, 2, 3, 6)


def resize_bilinear(x, size):
    """NCHW bilinear resize with the semantics of ``jax.image.resize(...,
    "bilinear")``: half-pixel centres and, when shrinking, an antialiasing
    (widened triangle) kernel. ``antialias=True`` gives exactly that;
    without it a 6 -> 2 shrink differs by more than 1."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, padding=1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride, bias=False))
                           if stride != 1 or in_ch != planes else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetFeats(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        in_ch = 64
        for li, (p, n, s) in enumerate(zip(PLANES, BLOCKS, LAYER_STRIDES), start=1):
            blocks = [BasicBlock(in_ch, p, stride=s)] + [BasicBlock(p, p) for _ in range(1, n)]
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
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
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=1),
                                  nn.PReLU(1, init=0.25))

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(resize_bilinear(x, (2 * h, 2 * w)))


class PSPNet(nn.Module):
    """Features at 1/4 of the input resolution (stride 32, three 2x upsamples)."""

    def __init__(self):
        super().__init__()
        self.feats = ResNetFeats()
        self.psp = PSPModule(PLANES[3])
        self.up_1 = PSPUpsample(2 * PLANES[3], 256)
        self.up_2 = PSPUpsample(256, 64)
        self.up_3 = PSPUpsample(64, 64)
        self.final = nn.Conv2d(64, 32, 1)

    def forward(self, x):
        """x (B, H, W, 3) -> features (B, H/4, W/4, 32)."""
        p = self.psp(self.feats(x.permute(0, 3, 1, 2)))
        return self.final(self.up_3(self.up_2(self.up_1(p)))).permute(0, 2, 3, 1)
