"""StereoPoseNetWithDepth (counterpart of
``rgbmanip_tpu/models/pose_estimator/nets/stereo.py``): every PSPNet
backend and backbone stride, ``volume_scale``, nearest or bilinear warp,
regressed pose.

Per view: PSPNet features, a plane-sweep cost volume built by warping the
other view's features over D depth hypotheses, a 3-D U-Net (CostRegNet) over
the volume, a per-point NOCS head, softmax depth regression at the chosen
points, and depth-probability-weighted volume features feeding the 6-D
rotation / translation / size heads.

``model.train()`` is the JAX module's ``train=True``: only the CostRegNet's
BatchNorms change (``FlaxBatchNorm3d``), and the two views' ``reg`` calls of
one forward update their running statistics twice, view 1 first. PSPNet
has no BatchNorm.

Layouts at the public functions follow the JAX package: NHWC images and
features, (B, N, C) points, and ``homo_warp_batched`` returning
(B, D, H, W, C). Inside, ``Conv3d`` runs NCDHW. The JAX package's banded
``CostRegNet2D`` is a TPU execution plan of the same math and parameter tree;
this module ports ``CostRegNet``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.gather import flat_gather, point_sample
from .pspnet import PSPNet


def ortho6d_to_mat(x_raw, y_raw):
    """6-D rotation representation -> rotation matrix (..., 3, 3) with rows
    x, y, z."""
    x = x_raw / (torch.linalg.norm(x_raw, dim=-1, keepdim=True) + 1e-8)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def homo_warp_batched(src_feat, src_proj, ref_proj, depth_values,
                      mode: str = "bilinear"):
    """Warp src features (B, H, W, C) into the ref view over depth
    hypotheses (B, D); src_proj/ref_proj (B, 4, 4) full projections.
    Returns (B, D, H, W, C), zero where the ray leaves the source image or
    falls behind the camera. mode: "bilinear" (4 taps) or "nearest"."""
    B, H, W, C = src_feat.shape
    D = depth_values.shape[1]
    # inv_ex: a singular projection (an env with no valid view yet, whose
    # extrinsics ControlInterface.get_estimation leaves at zero) gives NaN as
    # jnp.linalg.inv does, and that env's estimate falls back to the
    # sentinel; torch.linalg.inv would raise for the whole batch
    proj = src_proj @ torch.linalg.inv_ex(ref_proj).inverse       # (B, 4, 4)
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3]

    dev = src_feat.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(H * W, device=dev)])             # (3, HW)
    rot_xyz = torch.einsum("bij,jn->bin", rot, xyz)                # (B, 3, HW)
    proj_xyz = (rot_xyz[:, :, None, :] * depth_values[:, None, :, None]
                + trans[:, :, None, None])                         # (B, 3, D, HW)
    pz = proj_xyz[:, 2]
    px = proj_xyz[:, 0] / (pz + 1e-9)
    py = proj_xyz[:, 1] / (pz + 1e-9)
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & (pz > 1e-6)

    flat = src_feat.reshape(B, H * W, C)

    def g(yy, xx):                                                 # (B, D, HW, C)
        return flat_gather(flat, yy * W + xx)

    if mode == "nearest":
        out = g(torch.round(py).long().clamp(0, H - 1),
                torch.round(px).long().clamp(0, W - 1))
    elif mode == "bilinear":
        x0f = torch.floor(px)
        y0f = torch.floor(py)
        wx = (px - x0f)[..., None].to(src_feat.dtype)
        wy = (py - y0f)[..., None].to(src_feat.dtype)
        x0 = x0f.long().clamp(0, W - 1)
        y0 = y0f.long().clamp(0, H - 1)
        x1 = torch.clamp_max(x0 + 1, W - 1)
        y1 = torch.clamp_max(y0 + 1, H - 1)
        out = g(y0, x0) * ((1 - wy) * (1 - wx))
        out = out + g(y0, x1) * ((1 - wy) * wx)
        out = out + g(y1, x0) * (wy * (1 - wx))
        out = out + g(y1, x1) * (wy * wx)
    else:
        raise ValueError(f"warp mode must be 'nearest' or 'bilinear', got {mode!r}")
    out = out * inside[..., None].to(src_feat.dtype)
    return out.reshape(B, D, H, W, C)


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over (B, C, D, H,
    W). In eval mode it is ``nn.BatchNorm3d`` on the running statistics. In
    train mode it normalises by the batch mean and the biased batch variance,
    computed as flax computes them (``E[x^2] - E[x]^2``, clipped at 0), and
    updates ``running = 0.9 running + 0.1 batch`` with that biased variance
    (``nn.BatchNorm3d`` would update with the unbiased one)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3, 4)
        mean = x.mean(dims)
        var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean)
            self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var)
            self.num_batches_tracked += 1
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ConvBnRelu3d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, 3, stride, padding=1, bias=False)
        self.bn = FlaxBatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBnRelu3d(nn.Module):
    """``ConvTranspose3d(k3, s2, p1, output_padding=1)``: the alignment the
    JAX package emulates with an explicitly padded, flipped conv_transpose."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_ch, out_ch, 3, 2, padding=1,
                                       output_padding=1, bias=False)
        self.bn = FlaxBatchNorm3d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CostRegNet(nn.Module):
    """3-D U-Net over the fused volume (B, C, D, H, W) -> (B, 1, D, H, W)."""

    def __init__(self, in_ch: int, base: int = 8):
        super().__init__()
        b = base
        self.conv0 = ConvBnRelu3d(in_ch, b)
        self.conv1 = ConvBnRelu3d(b, 2 * b, stride=2)
        self.conv2 = ConvBnRelu3d(2 * b, 2 * b)
        self.conv3 = ConvBnRelu3d(2 * b, 4 * b, stride=2)
        self.conv4 = ConvBnRelu3d(4 * b, 4 * b)
        self.conv5 = ConvBnRelu3d(4 * b, 8 * b, stride=2)
        self.conv6 = ConvBnRelu3d(8 * b, 8 * b)
        self.conv7 = DeconvBnRelu3d(8 * b, 4 * b)
        self.conv9 = DeconvBnRelu3d(4 * b, 2 * b)
        self.conv11 = DeconvBnRelu3d(2 * b, b)
        self.prob = nn.Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        x = self.conv6(self.conv5(c4))
        x = c4 + self.conv7(x)
        x = c2 + self.conv9(x)
        x = c0 + self.conv11(x)
        return self.prob(x)


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s weights in place from the distributions of the JAX
    package's flax init (not its numbers): every conv, transposed-conv and
    linear weight from lecun_normal, a normal truncated at two standard
    deviations and scaled to variance 1 / fan-in, where fan-in counts the
    input channels times the kernel's taps; biases zero. PReLU slopes (0.25)
    and BatchNorm (identity) already start as flax's do. PyTorch's own
    default draws a third of that variance, and through the 36 unnormalised
    conv layers of resnet34 the NOCS head's output then barely varies
    across points, so the scale solve finds no pair and returns no pose.
    The draws come from ``generator`` alone."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
                w = mod.weight
                taps = w[0, 0].numel() if w.dim() > 2 else 1
                fan_in = taps * (w.shape[0] if isinstance(mod, nn.ConvTranspose3d)
                                 else w.shape[1])
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def _mlp(widths, final=None):
    """Per-point MLP on (..., C): Linear/ReLU pairs, the last layer followed
    by ``final`` (a module or None). Sequential indices match the reference
    Conv1d stacks (0, 2, 4, ...)."""
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        layers.append(nn.Linear(a, b))
        last = i == len(widths) - 2
        if not last:
            layers.append(nn.ReLU())
        elif final is not None:
            layers.append(final)
    return nn.Sequential(*layers)


class StereoPoseNetWithDepth(nn.Module):
    """The production network: stereo fusion, regressed pose, no volume
    channel reduction, the per-view towers run once per view."""

    def __init__(self, backend: str = "resnet18", backbone_stride: int = 32,
                 volume_scale: int = 8, warp_mode: str = "nearest",
                 regress_pose: bool = True, stereo_fusion: bool = True,
                 volume_channels: int = 0, realworld_pts: bool = False,
                 fuse_views: bool = False):
        super().__init__()
        unported = {"regress_pose": (regress_pose, True),
                    "stereo_fusion": (stereo_fusion, True),
                    "volume_channels": (volume_channels, 0),
                    "realworld_pts": (realworld_pts, False),
                    "fuse_views": (fuse_views, False)}
        for knob, (value, production) in unported.items():
            if value != production:
                raise NotImplementedError(
                    f"{knob}={value!r} is not ported yet (ROADMAP.md, Queue 1: "
                    f"'the other estimator knobs and solves'); the port runs "
                    f"{knob}={production!r}")
        if warp_mode not in ("nearest", "bilinear"):
            raise ValueError(f"warp_mode must be 'nearest' or 'bilinear', got {warp_mode!r}")
        self.backend = backend
        self.backbone_stride = backbone_stride
        self.volume_scale = volume_scale
        self.warp_mode = warp_mode
        fs = backbone_stride // 8
        if volume_scale % fs != 0:
            raise ValueError(f"volume_scale {volume_scale} must be a multiple of "
                             f"the feature stride {fs} (backbone_stride "
                             f"{backbone_stride})")

        self.img_extractor = PSPNet(backend, backbone_stride)
        self.instance_color = _mlp((32, 64), nn.ReLU())
        self.nocs_head = _mlp((64, 128, 64, 3), nn.Tanh())
        self.cost_regularization = CostRegNet(32, base=8)
        self.nocs_pts_mlp = _mlp((3, 32, 64), nn.ReLU())
        self.pose_mlp1 = _mlp((96, 128, 128), nn.ReLU())
        self.pose_mlp2 = _mlp((256, 256, 256), nn.ReLU())
        self.rotation_estimator = _mlp((256, 256, 128, 6))
        self.translation_estimator = _mlp((256, 256, 128, 3))
        self.size_estimator = _mlp((256, 256, 128, 3))

    def heads(self, pose_feat):
        """pose_feat (B, N, 96) -> R (B, 3, 3), t (B, 3), s (B, 3)."""
        x = self.pose_mlp1(pose_feat)
        x = torch.cat([x, x.mean(dim=-2, keepdim=True).expand_as(x)], dim=-1)
        x = self.pose_mlp2(x).mean(dim=-2)
        r6 = self.rotation_estimator(x)
        R = ortho6d_to_mat(r6[..., :3], r6[..., 3:])
        return R, self.translation_estimator(x), self.size_estimator(x)

    def forward(self, v1_img, v1_choose, v2_img, v2_choose, v1_proj, v2_proj,
                depth_values):
        """v*_img (B, S, S, 3); v*_choose (B, N) flat pixel indices;
        v*_proj (B, 4, 4); depth_values (B, D). Returns the JAX module's dict
        ``view{1,2}_{nocs,depth,r,t,s}``."""
        S = v1_img.shape[1]
        fs = self.backbone_stride // 8
        vs = self.volume_scale
        Sv = S // vs
        if Sv % 8 != 0:
            raise ValueError(
                f"volume resolution img_size/volume_scale = {Sv} must be "
                f"divisible by 8: the cost-regularization U-Net halves the "
                f"spatial dims three times and its deconvs double exactly")
        f1 = self.img_extractor(v1_img)        # (B, S/fs, S/fs, 32)
        f2 = self.img_extractor(v2_img)

        pv = vs // fs
        if pv > 1:
            def pool(f):
                return F.avg_pool2d(f.permute(0, 3, 1, 2), pv, pv).permute(0, 2, 3, 1)
            f1v, f2v = pool(f1), pool(f2)
        else:
            f1v, f2v = f1, f2
        scale = torch.tensor([1.0 / vs, 1.0 / vs, 1.0, 1.0],
                             device=v1_proj.device)[:, None]
        p1v, p2v = scale * v1_proj, scale * v2_proj

        w2 = homo_warp_batched(f2v, p2v, p1v, depth_values, self.warp_mode)
        w1 = homo_warp_batched(f1v, p1v, p2v, depth_values, self.warp_mode)
        fused1 = f1v[:, None] + w2             # (B, D, Sv, Sv, C)
        fused2 = f2v[:, None] + w1

        def rows_cols(choose):
            return (torch.div(choose, S, rounding_mode="floor"), choose % S)

        def gather_pts(feat, choose):
            # pixel-centre alignment into the strided map: (p + 0.5)/fs - 0.5
            r, c = rows_cols(choose)
            return point_sample(feat, (r.float() + 0.5) / fs - 0.5,
                                (c.float() + 0.5) / fs - 0.5)

        nocs1 = self.nocs_head(self.instance_color(gather_pts(f1, v1_choose)))
        nocs2 = self.nocs_head(self.instance_color(gather_pts(f2, v2_choose)))

        def cost(fused):                       # -> (B, Sv, Sv, D)
            vol = fused.permute(0, 4, 1, 2, 3).contiguous()   # (B, C, D, Sv, Sv)
            return self.cost_regularization(vol)[:, 0].permute(0, 2, 3, 1)

        def point_depth(cost_vol, choose):
            r, c = rows_cols(choose)
            pts = point_sample(cost_vol, (r.float() + 0.5) / vs - 0.5,
                               (c.float() + 0.5) / vs - 0.5)  # (B, N, D)
            prob = torch.softmax(pts.float(), dim=-1)
            return prob, (prob * depth_values[:, None, :]).sum(-1)

        prob1, depth1 = point_depth(cost(fused1), v1_choose)
        prob2, depth2 = point_depth(cost(fused2), v2_choose)

        def pose_branch(fused, choose, prob, nocs):
            # depth-probability-weighted volume features at the nearest
            # volume cell of each chosen pixel
            B, D, _, _, C = fused.shape
            r, c = rows_cols(choose)
            py = torch.div(r, vs, rounding_mode="floor").clamp(0, Sv - 1)
            px = torch.div(c, vs, rounding_mode="floor").clamp(0, Sv - 1)
            table = fused.permute(0, 2, 3, 1, 4).reshape(B, Sv * Sv, D * C)
            pts = flat_gather(table, py * Sv + px).reshape(B, -1, D, C)
            feat = (pts * prob[..., None].to(pts.dtype)).sum(2)
            return torch.cat([feat, self.nocs_pts_mlp(nocs).to(pts.dtype)], dim=-1)

        R1, t1, s1 = self.heads(pose_branch(fused1, v1_choose, prob1, nocs1))
        R2, t2, s2 = self.heads(pose_branch(fused2, v2_choose, prob2, nocs2))
        return {"view1_nocs": nocs1, "view2_nocs": nocs2,
                "view1_depth": depth1, "view2_depth": depth2,
                "view1_r": R1, "view1_t": t1, "view1_s": s1,
                "view2_r": R2, "view2_t": t2, "view2_s": s2}
