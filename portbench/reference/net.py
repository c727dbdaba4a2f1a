"""Plain PyTorch reference of the AdaPose network (``StereoPoseNetWithDepth``
with direct pose regression, the network of both benchmark configurations),
in float32 and in eval mode.

It follows the published RGBManip estimator (arXiv 2310.03478; the reference
repository's AdaPose ``StereoPoseNetWithDepth``): a PSPNet over ResNet basic
blocks without batch norm, a plane-sweep cost volume built by warping the
other view's features over D depth hypotheses, a 3-D U-Net over the volume,
a per-point NOCS head, a softmax depth regression at the chosen points and
depth-probability-weighted volume features feeding the 6-D rotation,
translation and size heads. Module names are the reference's torch
state_dict keys, so one state dict loads here and into the measured program.

Departures from the published network, each a knob of the repository's
configurations: ``backbone_stride`` 16 or 32 strides layers 3 and 4 instead
of dilating them, ``volume_scale`` average-pools the features before the
warp, and ``warp`` "nearest" samples the nearest source cell.

Every convolution, transposed convolution and dense layer rounds its input
and weight with its ``quant`` (none by default); ``quantize`` installs one
for a block: the lower-precision control of the benchmark's correctness
check. Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# backend -> (blocks per stage, stage widths)
ARCH = {"resnet34": ((3, 4, 6, 3), (64, 128, 256, 512)),
        "resnet18": ((2, 2, 2, 2), (64, 128, 256, 512))}
# backbone_stride -> (stride, dilation) of layers 3 and 4
STRIDES = {8: ((1, 2), (1, 4)), 16: ((2, 1), (1, 2)), 32: ((2, 1), (2, 1))}
BINS = (1, 2, 3, 6)

@contextlib.contextmanager
def quantize(net, fn):
    """Round the input and the weight of every convolution and dense layer
    of ``net`` with ``fn`` (a tensor -> tensor of the same dtype) inside the
    block; ``fn`` None leaves them alone."""
    layers = [m for m in net.modules() if isinstance(m, _Rounded)]
    for m in layers:
        m.quant = fn
    try:
        yield
    finally:
        for m in layers:
            m.quant = None


class _Rounded:
    quant = None

    def _q(self, x):
        return x if self.quant is None else self.quant(x)


class Conv2d(_Rounded, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(self._q(x), self._q(self.weight), self.bias)


class Conv3d(_Rounded, nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(self._q(x), self._q(self.weight), self.bias)


class ConvTranspose3d(_Rounded, nn.ConvTranspose3d):
    def forward(self, x):
        return F.conv_transpose3d(self._q(x), self._q(self.weight), self.bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(_Rounded, nn.Linear):
    def forward(self, x):
        return F.linear(self._q(x), self._q(self.weight), self.bias)


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, padding=dilation, dilation=dilation,
                            bias=False)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation, dilation=dilation,
                            bias=False)
        self.downsample = (nn.Sequential(Conv2d(cin, planes, 1, stride, bias=False))
                           if downsample else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetFeats(nn.Module):
    def __init__(self, backend, backbone_stride):
        super().__init__()
        blocks, planes = ARCH[backend]
        stages = ((1, 1), (2, 1)) + STRIDES[backbone_stride]
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        cin = 64
        for li, (p, n, (s, d)) in enumerate(zip(planes, blocks, stages), start=1):
            layer = [BasicBlock(cin, p, stride=s, downsample=li > 1)]
            layer += [BasicBlock(p, p, dilation=d) for _ in range(1, n)]
            setattr(self, f"layer{li}", nn.Sequential(*layer))
            cin = p

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, padding=1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def _resize(x, size):
    """Bilinear resize with half-pixel centres and an antialiasing kernel
    when shrinking (``jax.image.resize``'s rule, which the estimator was
    trained under)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=True)


class PSPModule(nn.Module):
    def __init__(self, feat):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b), Conv2d(feat, feat // 4, 1, bias=False))
            for b in BINS)

    def forward(self, x):
        size = x.shape[-2:]
        return torch.cat([x] + [_resize(F.relu(s(x)), size) for s in self.stages], 1)


class PSPUpsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(cin, cout, 3, padding=1), nn.PReLU(1, init=0.25))

    def forward(self, x):
        h, w = x.shape[-2:]
        return self.conv(_resize(x, (2 * h, 2 * w)))


class PSPNet(nn.Module):
    def __init__(self, backend, backbone_stride):
        super().__init__()
        self.feats = ResNetFeats(backend, backbone_stride)
        self.psp = PSPModule(512)
        self.up_1 = PSPUpsample(1024, 256)
        self.up_2 = PSPUpsample(256, 64)
        self.up_3 = PSPUpsample(64, 64)
        self.final = Conv2d(64, 32, 1)

    def forward(self, x):
        """(B, S, S, 3) -> (B, S', S', 32), S' = S / (backbone_stride / 8)."""
        p = self.psp(self.feats(x.permute(0, 3, 1, 2)))
        return self.final(self.up_3(self.up_2(self.up_1(p)))).permute(0, 2, 3, 1)


class ConvBnRelu3d(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv = Conv3d(cin, cout, 3, stride, padding=1, bias=False)
        self.bn = nn.BatchNorm3d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBnRelu3d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvTranspose3d(cin, cout, 3, 2, padding=1, output_padding=1, bias=False)
        self.bn = nn.BatchNorm3d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CostRegNet(nn.Module):
    def __init__(self, cin, b=8):
        super().__init__()
        self.conv0 = ConvBnRelu3d(cin, b)
        self.conv1 = ConvBnRelu3d(b, 2 * b, 2)
        self.conv2 = ConvBnRelu3d(2 * b, 2 * b)
        self.conv3 = ConvBnRelu3d(2 * b, 4 * b, 2)
        self.conv4 = ConvBnRelu3d(4 * b, 4 * b)
        self.conv5 = ConvBnRelu3d(4 * b, 8 * b, 2)
        self.conv6 = ConvBnRelu3d(8 * b, 8 * b)
        self.conv7 = DeconvBnRelu3d(8 * b, 4 * b)
        self.conv9 = DeconvBnRelu3d(4 * b, 2 * b)
        self.conv11 = DeconvBnRelu3d(2 * b, b)
        self.prob = Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        x = c2 + self.conv9(x)
        x = c0 + self.conv11(x)
        return self.prob(x)


def _mlp(widths, final=None):
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        layers.append(Linear(a, b))
        if i < len(widths) - 2:
            layers.append(nn.ReLU())
        elif final is not None:
            layers.append(final)
    return nn.Sequential(*layers)


def flat_gather(table, idx):
    """table (B, M, ...), idx (B, ...) -> table[b, idx[b]]."""
    bb = torch.arange(table.shape[0], device=table.device)
    return table[bb.reshape((-1,) + (1,) * (idx.dim() - 1)), idx.long()]


def point_sample(feat, ys, xs):
    """Bilinear samples of feat (B, H, W, C) at float pixel coords (B, N),
    zero outside the map: (B, N, C)."""
    B, H, W, C = feat.shape
    flat = feat.reshape(B, H * W, C)
    out = 0
    y0, x0 = torch.floor(ys), torch.floor(xs)
    for yy in (y0, y0 + 1):
        wy = torch.clamp_min(1 - (ys - yy).abs(), 0) * ((yy >= 0) & (yy <= H - 1))
        for xx in (x0, x0 + 1):
            wx = torch.clamp_min(1 - (xs - xx).abs(), 0) * ((xx >= 0) & (xx <= W - 1))
            idx = yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long()
            out = out + flat_gather(flat, idx) * (wy * wx)[..., None]
    return out


def homo_warp(src, src_proj, ref_proj, depth, mode):
    """Warp src features (B, H, W, C) into the ref view over depths (B, D):
    (B, D, H, W, C), zero where the ray leaves the source or falls behind it."""
    B, H, W, C = src.shape
    D = depth.shape[1]
    proj = src_proj @ torch.linalg.inv_ex(ref_proj).inverse
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    dev = src.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1), torch.ones(H * W, device=dev)])[None]
    rot_xyz = torch.einsum("bij,bjn->bin", rot, xyz.expand(B, -1, -1))
    p = rot_xyz[:, :, None, :] * depth[:, None, :, None] + trans[:, :, None, None]
    pz = p[:, 2]
    px = p[:, 0] / (pz + 1e-9)
    py = p[:, 1] / (pz + 1e-9)
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & (pz > 1e-6)
    flat = src.reshape(B, H * W, C)

    def g(yy, xx):
        return flat_gather(flat, yy * W + xx)

    if mode == "nearest":
        out = g(torch.round(py).long().clamp(0, H - 1), torch.round(px).long().clamp(0, W - 1))
    else:
        x0f, y0f = torch.floor(px), torch.floor(py)
        wx, wy = (px - x0f)[..., None], (py - y0f)[..., None]
        x0, y0 = x0f.long().clamp(0, W - 1), y0f.long().clamp(0, H - 1)
        x1, y1 = (x0 + 1).clamp_max(W - 1), (y0 + 1).clamp_max(H - 1)
        out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
               + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)
    return (out * inside[..., None]).reshape(B, D, H, W, C)


def ortho6d_to_mat(x_raw, y_raw):
    x = x_raw / (x_raw.norm(dim=-1, keepdim=True) + 1e-8)
    z = torch.cross(x, y_raw, dim=-1)
    z = z / (z.norm(dim=-1, keepdim=True) + 1e-8)
    y = torch.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


class StereoPoseNet(nn.Module):
    """The estimator's network: ``forward`` returns, for both views, the
    NOCS (B, N, 3), point depths (B, N), rotation (B, 3, 3), translation
    and size (B, 3). The solve reads view 1's; both are the network's work."""

    def __init__(self, backend="resnet34", backbone_stride=8, volume_scale=1,
                 warp_mode="nearest"):
        super().__init__()
        self.backbone_stride = backbone_stride
        self.volume_scale = volume_scale
        self.warp_mode = warp_mode
        self.img_extractor = PSPNet(backend, backbone_stride)
        self.instance_color = _mlp((32, 64), nn.ReLU())
        self.nocs_head = _mlp((64, 128, 64, 3), nn.Tanh())
        self.cost_regularization = CostRegNet(32)
        self.nocs_pts_mlp = _mlp((3, 32, 64), nn.ReLU())
        self.pose_mlp1 = _mlp((64 + 32, 128, 128), nn.ReLU())
        self.pose_mlp2 = _mlp((256, 256, 256), nn.ReLU())
        self.rotation_estimator = _mlp((256, 256, 128, 6))
        self.translation_estimator = _mlp((256, 256, 128, 3))
        self.size_estimator = _mlp((256, 256, 128, 3))

    def heads(self, feat):
        x = self.pose_mlp1(feat)
        x = torch.cat([x, x.mean(-2, keepdim=True).expand_as(x)], -1)
        x = self.pose_mlp2(x).mean(-2)
        r6 = self.rotation_estimator(x)
        return (ortho6d_to_mat(r6[..., :3], r6[..., 3:]), self.translation_estimator(x),
                self.size_estimator(x))

    def forward(self, img1, choose1, img2, choose2, proj1, proj2, depth):
        S = img1.shape[1]
        D = depth.shape[1]
        fs = self.backbone_stride // 8
        vs = self.volume_scale
        Sv = S // vs
        f1, f2 = self.img_extractor(img1), self.img_extractor(img2)
        pv = vs // fs

        def pool(f):
            if pv == 1:
                return f
            return F.avg_pool2d(f.permute(0, 3, 1, 2), pv, pv).permute(0, 2, 3, 1)
        f1v, f2v = pool(f1), pool(f2)
        scale = torch.tensor([1.0 / vs, 1.0 / vs, 1.0, 1.0], device=proj1.device)[:, None]
        p1v, p2v = scale * proj1, scale * proj2
        fused1 = f1v[:, None] + homo_warp(f2v, p2v, p1v, depth, self.warp_mode)
        fused2 = f2v[:, None] + homo_warp(f1v, p1v, p2v, depth, self.warp_mode)

        def rows_cols(choose):
            return torch.div(choose, S, rounding_mode="floor"), choose % S

        def nocs(feat, choose):
            r, c = rows_cols(choose)
            pts = point_sample(feat, (r.float() + 0.5) / fs - 0.5, (c.float() + 0.5) / fs - 0.5)
            return self.nocs_head(self.instance_color(pts))

        def point_depth(fused, choose):
            cost = self.cost_regularization(fused.permute(0, 4, 1, 2, 3).contiguous())
            cost = cost[:, 0].permute(0, 2, 3, 1)                 # (B, Sv, Sv, D)
            r, c = rows_cols(choose)
            pts = point_sample(cost, (r.float() + 0.5) / vs - 0.5, (c.float() + 0.5) / vs - 0.5)
            prob = torch.softmax(pts, -1)
            return prob, (prob * depth[:, None, :]).sum(-1)

        def pose_feat(fused, choose, prob, n):
            B = fused.shape[0]
            r, c = rows_cols(choose)
            py = torch.div(r, vs, rounding_mode="floor").clamp(0, Sv - 1)
            px = torch.div(c, vs, rounding_mode="floor").clamp(0, Sv - 1)
            table = fused.permute(0, 2, 3, 1, 4).reshape(B, Sv * Sv, -1)
            pts = flat_gather(table, py * Sv + px).reshape(B, -1, D, fused.shape[-1])
            return torch.cat([(pts * prob[..., None]).sum(2), self.nocs_pts_mlp(n)], -1)

        n1, n2 = nocs(f1, choose1), nocs(f2, choose2)
        prob1, d1 = point_depth(fused1, choose1)
        prob2, d2 = point_depth(fused2, choose2)
        R1, t1, s1 = self.heads(pose_feat(fused1, choose1, prob1, n1))
        R2, t2, s2 = self.heads(pose_feat(fused2, choose2, prob2, n2))
        return {"view1_nocs": n1, "view2_nocs": n2, "view1_depth": d1, "view2_depth": d2,
                "view1_r": R1, "view1_t": t1, "view1_s": s1,
                "view2_r": R2, "view2_t": t2, "view2_s": s2}
