"""The StereoPoseNet family (counterpart of
``rgbmanip_tpu/models/pose_estimator/nets/stereo.py``).

``StereoPoseNetWithDepth`` is the v3-v5 network with every knob of the JAX
module: each PSPNet backend and backbone stride, ``volume_scale``, nearest
or bilinear warp, ``regress_pose`` (the pose heads, or none for the
depth-solve generation), ``stereo_fusion`` (False: the no-cross-view
ablation, ``adapose_baseline``), ``volume_channels`` (a 1x1 reduction
before the warp), ``realworld_pts`` (the pose branch over (px, py, depth))
and ``fuse_views`` (both views' towers in one batch, eval only).
``StereoPoseNetV1`` is the original volume_conv + fuse_conv network.

Per view: PSPNet features, a plane-sweep cost volume built by warping the
other view's features over D depth hypotheses, a 3-D U-Net (CostRegNet) over
the volume, a per-point NOCS head, softmax depth regression at the chosen
points, and depth-probability-weighted volume features feeding the 6-D
rotation / translation / size heads.

Every module takes the JAX module's ``dtype`` and computes by flax's rule
(``layers``): f32 parameters, each convolution and dense layer in ``dtype``,
BatchNorm in f32 returning ``dtype``, the depth softmax in f32, the warp's
tap weights in the features' dtype. In a reduced dtype this module rounds
where the JAX module's compiled code does (each add of a pooled window,
each of the point sampler's two contractions) and not where XLA keeps f32
(a product summed next).

``model.train()`` is the JAX module's ``train=True``: only the BatchNorms
change (``FlaxBatchNorm3d``), and the two views' ``reg`` calls of one
forward update their running statistics twice, view 1 first. PSPNet has no
BatchNorm.

Layouts at the public functions follow the JAX package: NHWC images and
features, (B, N, C) points, and ``homo_warp_batched`` returning
(B, D, H, W, C). Inside, ``Conv3d`` runs NCDHW. The JAX package's banded
``CostRegNet2D`` is a TPU execution plan of the same math and parameter tree;
this module ports ``CostRegNet``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ....ops.gather import flat_gather, point_sample
from ....utils.logger import span
from .layers import Conv2d, Conv3d, ConvTranspose3d, Linear
from .pspnet import PSPNet


def _norm(x):
    """``jnp.linalg.norm`` over the last axis as XLA computes it: the
    squares and their sum in f32 (XLA drops the rounding of a product that
    is converted to f32 next), rounded to x's dtype, the square root."""
    xf = x.float()
    return torch.sqrt((xf * xf).sum(-1, keepdim=True).to(x.dtype))


def _cross(a, b):
    """``jnp.cross``, each product and difference rounded to the dtype."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def ortho6d_to_mat(x_raw, y_raw):
    """6-D rotation representation -> rotation matrix (..., 3, 3) with rows
    x, y, z."""
    x = x_raw / (_norm(x_raw) + 1e-8)
    z = _cross(x, y_raw)
    z = z / (_norm(z) + 1e-8)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-2)


def _relative_projection(src_proj, ref_proj):
    # inv_ex: a singular projection (an env with no valid view yet, whose
    # extrinsics ControlInterface.get_estimation leaves at zero) gives NaN as
    # jnp.linalg.inv does, and that env's estimate falls back to the
    # sentinel; torch.linalg.inv would raise for the whole batch
    proj = src_proj @ torch.linalg.inv_ex(ref_proj).inverse       # (B, 4, 4)
    return proj[:, :3, :3], proj[:, :3, 3]


def _project(rot, trans, xyz, depth_values, H: int, W: int):
    """Pixel rays xyz (B or 1, 3, M) of the ref view at each depth through
    the relative projection: (px, py, inside), each (B, D, M)."""
    rot_xyz = torch.einsum("bij,bjn->bin", rot, xyz.expand(rot.shape[0], -1, -1))
    proj_xyz = (rot_xyz[:, :, None, :] * depth_values[:, None, :, None]
                + trans[:, :, None, None])                         # (B, 3, D, M)
    pz = proj_xyz[:, 2]
    px = proj_xyz[:, 0] / (pz + 1e-9)
    py = proj_xyz[:, 1] / (pz + 1e-9)
    inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1) & (pz > 1e-6)
    return px, py, inside


def _sample(src_feat, px, py, inside, mode: str):
    """Nearest or 4-tap bilinear samples of src_feat (B, H, W, C) at
    (B, D, M) source coords, zero where not ``inside``: (B, D, M, C). The
    tap weights are in the features' dtype, as the JAX module keeps them."""
    B, H, W, C = src_feat.shape
    dt = src_feat.dtype
    flat = src_feat.reshape(B, H * W, C)

    def g(yy, xx):
        return flat_gather(flat, yy * W + xx)

    if mode == "nearest":
        out = g(torch.round(py).long().clamp(0, H - 1),
                torch.round(px).long().clamp(0, W - 1))
    elif mode == "bilinear":
        x0f = torch.floor(px)
        y0f = torch.floor(py)
        wx = (px - x0f)[..., None].to(dt)
        wy = (py - y0f)[..., None].to(dt)
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
    return out * inside[..., None].to(dt)


def homo_warp_batched(src_feat, src_proj, ref_proj, depth_values,
                      mode: str = "bilinear"):
    """Warp src features (B, H, W, C) into the ref view over depth
    hypotheses (B, D); src_proj/ref_proj (B, 4, 4) full projections.
    Returns (B, D, H, W, C), zero where the ray leaves the source image or
    falls behind the camera. mode: "bilinear" (4 taps) or "nearest"."""
    B, H, W, C = src_feat.shape
    D = depth_values.shape[1]
    rot, trans = _relative_projection(src_proj, ref_proj)
    dev = src_feat.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1),
                       torch.ones(H * W, device=dev)])[None]       # (1, 3, HW)
    px, py, inside = _project(rot, trans, xyz, depth_values, H, W)
    return _sample(src_feat, px, py, inside, mode).reshape(B, D, H, W, C)


def homo_warp(src_feat, src_proj, ref_proj, depth_values, mode: str = "bilinear"):
    """``homo_warp_batched`` of one sample: (H, W, C) -> (D, H, W, C)."""
    return homo_warp_batched(src_feat[None], src_proj[None], ref_proj[None],
                             depth_values[None], mode)[0]


def homo_warp_points(src_feat, src_proj, ref_proj, depth_values, pts_x, pts_y):
    """The bilinear plane-sweep warp at N chosen ref-view pixels only:
    pts_x/pts_y (B, N) integer pixel coords -> (B, N, D, C)."""
    B, H, W, C = src_feat.shape
    rot, trans = _relative_projection(src_proj, ref_proj)
    xyz = torch.stack([pts_x.float(), pts_y.float(), torch.ones_like(pts_x, dtype=torch.float32)],
                      dim=1)                                       # (B, 3, N)
    px, py, inside = _project(rot, trans, xyz, depth_values, H, W)
    return _sample(src_feat, px, py, inside, "bilinear").transpose(1, 2)


def avg_pool(f, k: int):
    """flax ``nn.avg_pool`` with a k x k window and stride k over NHWC
    features: at f32 ``F.avg_pool2d``; in a reduced dtype the window's cells
    summed row by row in f's dtype (rounded after each add, as XLA's reduce
    window), then divided by k * k."""
    if f.dtype == torch.float32:
        return F.avg_pool2d(f.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)
    B, H, W, C = f.shape
    t = f[:, :H // k * k, :W // k * k].reshape(B, H // k, k, W // k, k, C)
    s = None
    for i in range(k):
        for j in range(k):
            s = t[:, :, i, :, j] if s is None else s + t[:, :, i, :, j]
    return s / (k * k)


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``; its backward sums the
    gradient over them too, so that each rank's share of the statistics
    carries every rank's loss gradient, as GSPMD's reduction does."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class FlaxBatchNorm3d(nn.BatchNorm3d):
    """flax's ``nn.BatchNorm(momentum, epsilon=1e-5, dtype)`` over (B, C, D,
    H, W): the statistics and the normalisation in f32 (the batch's mean and
    biased variance in train mode, computed as flax computes them,
    ``E[x^2] - E[x]^2`` clipped at 0; the running ones in eval mode), the
    result in ``dtype``; in eval mode at f32, ``nn.BatchNorm3d``. Train mode
    updates ``running = momentum * running +
    (1 - momentum) * batch`` with the biased variance (``nn.BatchNorm3d``
    would update with the unbiased one).

    ``process_group``: when set (a dp sub-group, by ``EstimatorTrainer``
    with a mesh), train mode takes ``E[x]`` and ``E[x^2]`` over the whole
    batch of the group's ranks, as the JAX package's BatchNorm of a
    dp-sharded batch does under GSPMD: the per-rank sums and element count
    are summed over the group, with a backward that sums too, and the
    running statistics update from the global values. (``nn.SyncBatchNorm``
    refuses CPU tensors and updates with the unbiased variance.)"""

    def __init__(self, num_features: int, momentum: float = 0.9, dtype=torch.float32):
        super().__init__(num_features, eps=1e-5)
        self.decay = momentum
        self.compute_dtype = dtype
        self.process_group = None

    def forward(self, x):
        if not self.training and x.dtype == self.compute_dtype == torch.float32:
            return super().forward(x)
        shape = (1, -1, 1, 1, 1)
        x = x.float()
        if self.training:
            dims = (0, 2, 3, 4)
            if self.process_group is None:
                mean, mean2 = x.mean(dims), (x * x).mean(dims)
            else:
                C = x.shape[1]
                sums = torch.cat([x.sum(dims), (x * x).sum(dims),
                                  x.new_full((1,), x.numel() // C)])
                sums = _AllReduceSum.apply(sums, self.process_group)
                mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.decay * self.running_mean + (1 - self.decay) * mean)
                self.running_var.copy_(self.decay * self.running_var + (1 - self.decay) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.compute_dtype)


class ConvBnRelu3d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(in_ch, out_ch, 3, stride, padding=1, bias=False, dtype=dtype)
        self.bn = FlaxBatchNorm3d(out_ch, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DeconvBnRelu3d(nn.Module):
    """``ConvTranspose3d(k3, s2, p1, output_padding=1)``: the alignment the
    JAX package emulates with an explicitly padded, flipped conv_transpose."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = ConvTranspose3d(in_ch, out_ch, 3, 2, padding=1, output_padding=1,
                                    bias=False, dtype=dtype)
        self.bn = FlaxBatchNorm3d(out_ch, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CostRegNet(nn.Module):
    """3-D U-Net over the fused volume (B, C, D, H, W) -> (B, 1, D, H, W)."""

    def __init__(self, in_ch: int, base: int = 8, dtype=torch.float32):
        super().__init__()
        b = base
        self.conv0 = ConvBnRelu3d(in_ch, b, dtype=dtype)
        self.conv1 = ConvBnRelu3d(b, 2 * b, stride=2, dtype=dtype)
        self.conv2 = ConvBnRelu3d(2 * b, 2 * b, dtype=dtype)
        self.conv3 = ConvBnRelu3d(2 * b, 4 * b, stride=2, dtype=dtype)
        self.conv4 = ConvBnRelu3d(4 * b, 4 * b, dtype=dtype)
        self.conv5 = ConvBnRelu3d(4 * b, 8 * b, stride=2, dtype=dtype)
        self.conv6 = ConvBnRelu3d(8 * b, 8 * b, dtype=dtype)
        self.conv7 = DeconvBnRelu3d(8 * b, 4 * b, dtype=dtype)
        self.conv9 = DeconvBnRelu3d(4 * b, 2 * b, dtype=dtype)
        self.conv11 = DeconvBnRelu3d(2 * b, b, dtype=dtype)
        self.prob = Conv3d(b, 1, 3, padding=1, bias=False, dtype=dtype)

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


def _mlp(widths, final=None, dtype=torch.float32):
    """Per-point MLP on (..., C): Linear/ReLU pairs, the last layer followed
    by ``final`` (a module or None). Sequential indices match the reference
    Conv1d stacks (0, 2, 4, ...)."""
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        layers.append(Linear(a, b, dtype=dtype))
        last = i == len(widths) - 2
        if not last:
            layers.append(nn.ReLU())
        elif final is not None:
            layers.append(final)
    return nn.Sequential(*layers)


class _PoseNet(nn.Module):
    """What the two networks share: the per-point NOCS head and the
    rotation / translation / size heads, named after the reference's
    torch keys."""

    def _build_nocs(self, in_ch: int, dtype):
        self.instance_color = _mlp((in_ch, 64), nn.ReLU(), dtype)
        self.nocs_head = _mlp((64, 128, 64, 3), nn.Tanh(), dtype)

    def _build_heads(self, in_ch: int, dtype):
        self.nocs_pts_mlp = _mlp((3, 32, 64), nn.ReLU(), dtype)
        self.pose_mlp1 = _mlp((in_ch, 128, 128), nn.ReLU(), dtype)
        self.pose_mlp2 = _mlp((256, 256, 256), nn.ReLU(), dtype)
        self.rotation_estimator = _mlp((256, 256, 128, 6), None, dtype)
        self.translation_estimator = _mlp((256, 256, 128, 3), None, dtype)
        self.size_estimator = _mlp((256, 256, 128, 3), None, dtype)

    def heads(self, pose_feat):
        """pose_feat (B, N, C) -> R (B, 3, 3), t (B, 3), s (B, 3)."""
        x = self.pose_mlp1(pose_feat)
        x = torch.cat([x, x.mean(dim=-2, keepdim=True).expand_as(x)], dim=-1)
        x = self.pose_mlp2(x).mean(dim=-2)
        r6 = self.rotation_estimator(x)
        R = ortho6d_to_mat(r6[..., :3], r6[..., 3:])
        return R, self.translation_estimator(x), self.size_estimator(x)


def _rows_cols(choose, S: int):
    return torch.div(choose, S, rounding_mode="floor"), choose % S


class StereoPoseNetWithDepth(_PoseNet):
    """The v3-v5 network; the knobs and their defaults (the production
    configuration's) are the JAX module's. ``fuse_views`` runs the per-view
    towers once on both views stacked along the batch, in eval mode only
    and not with ``realworld_pts``; every op is per sample there, so it is
    exact by construction."""

    arch = "with_depth"

    def __init__(self, backend: str = "resnet18", backbone_stride: int = 32,
                 volume_scale: int = 8, warp_mode: str = "nearest",
                 regress_pose: bool = True, stereo_fusion: bool = True,
                 volume_channels: int = 0, realworld_pts: bool = False,
                 fuse_views: bool = False, dtype=torch.float32):
        super().__init__()
        if warp_mode not in ("nearest", "bilinear"):
            raise ValueError(f"warp_mode must be 'nearest' or 'bilinear', got {warp_mode!r}")
        self.backend = backend
        self.backbone_stride = backbone_stride
        self.volume_scale = volume_scale
        self.warp_mode = warp_mode
        self.regress_pose = regress_pose
        self.stereo_fusion = stereo_fusion
        self.volume_channels = volume_channels
        self.realworld_pts = realworld_pts
        self.fuse_views = fuse_views
        self.dtype = dtype
        fs = backbone_stride // 8
        if volume_scale % fs != 0:
            raise ValueError(f"volume_scale {volume_scale} must be a multiple of "
                             f"the feature stride {fs} (backbone_stride "
                             f"{backbone_stride})")

        self.img_extractor = PSPNet(backend, backbone_stride, dtype)
        C = volume_channels or 32
        if volume_channels:
            self.volume_reduce = Conv2d(32, volume_channels, 1, bias=False, dtype=dtype)
        self._build_nocs(32, dtype)
        self.cost_regularization = CostRegNet(C, base=8, dtype=dtype)
        if regress_pose:
            if realworld_pts:
                self.camera_pts_mlp = _mlp((3, 32, 64), nn.ReLU(), dtype)
            self._build_heads(64 + (64 if realworld_pts else C), dtype)

    def forward(self, v1_img, v1_choose, v2_img, v2_choose, v1_proj, v2_proj,
                depth_values, v1_pts2d=None, v2_pts2d=None):
        """v*_img (B, S, S, 3); v*_choose (B, N) flat pixel indices;
        v*_proj (B, 4, 4); depth_values (B, D); with ``realworld_pts`` also
        v*_pts2d (B, N, 2), the points' original-frame pixel coords. Returns
        the JAX module's dict ``view{1,2}_{nocs,depth}`` and, with the pose
        heads, ``view{1,2}_{r,t,s}``."""
        B, S = v1_img.shape[0], v1_img.shape[1]
        D = depth_values.shape[1]
        dt = self.dtype
        fs = self.backbone_stride // 8
        vs = self.volume_scale
        Sv = S // vs
        if Sv % 8 != 0:
            raise ValueError(
                f"volume resolution img_size/volume_scale = {Sv} must be "
                f"divisible by 8: the cost-regularization U-Net halves the "
                f"spatial dims three times and its deconvs double exactly")
        fuse2 = self.fuse_views and not self.training and not self.realworld_pts

        def both(fn, *pairs):
            """fn on view 1's arguments and on view 2's (each of ``pairs``
            one argument of both views), or once on the two stacked along
            the batch and split."""
            if not fuse2:
                return fn(*(a for a, _ in pairs)), fn(*(b for _, b in pairs))
            out = fn(*(torch.cat(p) for p in pairs))
            if isinstance(out, tuple):
                return tuple(o[:B] for o in out), tuple(o[B:] for o in out)
            return out[:B], out[B:]

        with span("stereo/backbone"):
            f1, f2 = both(self.img_extractor, (v1_img, v2_img))   # (B, S/fs, S/fs, 32)
            pv = vs // fs
            f1v, f2v = (avg_pool(f, pv) if pv > 1 else f for f in (f1, f2))
            scale = torch.tensor([1.0 / vs, 1.0 / vs, 1.0, 1.0],
                                 device=v1_proj.device)[:, None]
            p1v, p2v = scale * v1_proj, scale * v2_proj
            if self.volume_channels:
                def reduce(f):
                    return self.volume_reduce(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                f1v, f2v = reduce(f1v), reduce(f2v)
        C = f1v.shape[-1]

        with span("stereo/warp"):
            if self.stereo_fusion:
                w2 = homo_warp_batched(f2v, p2v, p1v, depth_values, self.warp_mode)
                w1 = homo_warp_batched(f1v, p1v, p2v, depth_values, self.warp_mode)
                fused1 = f1v[:, None] + w2             # (B, D, Sv, Sv, C)
                fused2 = f2v[:, None] + w1
            else:   # the ablation: each view's volume is its own features, no warp
                fused1 = f1v[:, None].expand(B, D, Sv, Sv, C)
                fused2 = f2v[:, None].expand(B, D, Sv, Sv, C)

        def cost(fused):                       # -> (B, Sv, Sv, D)
            vol = fused.permute(0, 4, 1, 2, 3).contiguous()   # (B, C, D, Sv, Sv)
            return self.cost_regularization(vol)[:, 0].permute(0, 2, 3, 1)

        with span("stereo/cost_reg"):
            cost1, cost2 = both(cost, (fused1, fused2))
        with span("stereo/heads"):
            def gather_pts(feat, choose):
                # pixel-centre alignment into the strided map: (p + 0.5)/fs - 0.5
                r, c = _rows_cols(choose, S)
                return point_sample(feat, (r.float() + 0.5) / fs - 0.5,
                                    (c.float() + 0.5) / fs - 0.5)

            def nocs_of(feat, choose):
                return self.nocs_head(self.instance_color(gather_pts(feat, choose)))
            nocs1, nocs2 = both(nocs_of, (f1, f2), (v1_choose, v2_choose))

            def point_depth(cost_vol, choose, dvals):
                r, c = _rows_cols(choose, S)
                pts = point_sample(cost_vol, (r.float() + 0.5) / vs - 0.5,
                                   (c.float() + 0.5) / vs - 0.5)  # (B, N, D)
                prob = torch.softmax(pts.float(), dim=-1)
                return prob, (prob * dvals[:, None, :]).sum(-1)

            prob1, depth1 = point_depth(cost1, v1_choose, depth_values)
            prob2, depth2 = point_depth(cost2, v2_choose, depth_values)
            out = {"view1_nocs": nocs1, "view2_nocs": nocs2,
                   "view1_depth": depth1, "view2_depth": depth2}
            if not self.regress_pose:
                return out
            if self.realworld_pts:
                if v1_pts2d is None or v2_pts2d is None:
                    raise ValueError("realworld_pts=True requires v1_pts2d/v2_pts2d")

                def pose_feat(pts2d, depth, nocs):
                    pts3d = torch.cat([pts2d.to(dt), depth[..., None].to(dt)], dim=-1)
                    return torch.cat([self.camera_pts_mlp(pts3d),
                                      self.nocs_pts_mlp(nocs).to(dt)], dim=-1)
                feats = (pose_feat(v1_pts2d, depth1, nocs1), pose_feat(v2_pts2d, depth2, nocs2))
            else:
                def pose_feat(fused, choose, prob, nocs):
                    # depth-probability-weighted volume features at the nearest
                    # volume cell of each chosen pixel
                    Bp = fused.shape[0]
                    r, c = _rows_cols(choose, S)
                    py = torch.div(r, vs, rounding_mode="floor").clamp(0, Sv - 1)
                    px = torch.div(c, vs, rounding_mode="floor").clamp(0, Sv - 1)
                    table = fused.permute(0, 2, 3, 1, 4).reshape(Bp, Sv * Sv, D * C)
                    pts = flat_gather(table, py * Sv + px).reshape(Bp, -1, D, C)
                    # the products with the probabilities rounded to the dtype,
                    # summed in f32 and rounded once (XLA keeps the products in
                    # f32 for the sum)
                    w = prob[..., None].to(dt).float()
                    feat = (pts.float() * w).sum(2).to(dt)
                    return torch.cat([feat, self.nocs_pts_mlp(nocs).to(dt)], dim=-1)
                feats = (pose_feat(fused1, v1_choose, prob1, nocs1),
                         pose_feat(fused2, v2_choose, prob2, nocs2))
            (R1, t1, s1), (R2, t2, s2) = both(self.heads, feats)
            out.update({"view1_r": R1, "view1_t": t1, "view1_s": s1,
                        "view2_r": R2, "view2_t": t2, "view2_s": s2})
            return out


class VolumeConv(nn.Module):
    """V1's volume_conv: 1x1x1 convolutions 32 -> 16 -> 8 -> 1 over the
    fused volume, each with flax's default BatchNorm (momentum 0.99) and a
    ReLU. (B, D, H, W, C) -> (B, H, W, D)."""

    def __init__(self, in_ch: int = 32, dtype=torch.float32):
        super().__init__()
        for i, (a, b) in enumerate(zip((in_ch, 16, 8), (16, 8, 1))):
            setattr(self, f"conv_{i}", Conv3d(a, b, 1, bias=False, dtype=dtype))
            setattr(self, f"bn_{i}", FlaxBatchNorm3d(b, momentum=0.99, dtype=dtype))

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        for i in range(3):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x)))
        return x[:, 0].permute(0, 2, 3, 1)


class StereoPoseNetV1(_PoseNet):
    """The v1 network (the JAX module's ``StereoPoseNetV1``): PSPNet at
    backbone stride 8 (full-resolution features), the bilinear plane-sweep
    warp at full resolution, ``volume_conv`` to one channel per depth, a
    ``fuse_conv`` MLP over the D depths added back to the features, the
    NOCS head on the fused features, and the pose heads over the NOCS
    head's input and the NOCS. ``n_depth`` is the D that ``fuse_conv``
    takes."""

    arch = "v1"

    def __init__(self, backend: str = "resnet34", n_depth: int = 24, dtype=torch.float32):
        super().__init__()
        self.backend = backend
        self.dtype = dtype
        self.img_extractor = PSPNet(backend, 8, dtype)
        self.volume_conv = VolumeConv(32, dtype)
        self.fuse_conv = _mlp((n_depth, 32, 32), None, dtype)
        self._build_nocs(32, dtype)
        self._build_heads(128, dtype)

    def forward(self, v1_img, v1_choose, v2_img, v2_choose, v1_proj, v2_proj,
                depth_values):
        B, S = v1_img.shape[0], v1_img.shape[1]
        f1 = self.img_extractor(v1_img)        # (B, S, S, 32)
        f2 = self.img_extractor(v2_img)
        w2 = homo_warp_batched(f2, v2_proj, v1_proj, depth_values)
        w1 = homo_warp_batched(f1, v1_proj, v2_proj, depth_values)
        g1 = self.volume_conv(f1[:, None] + w2)
        g2 = self.volume_conv(f2[:, None] + w1)
        f1 = F.relu(f1 + self.fuse_conv(g1))
        f2 = F.relu(f2 + self.fuse_conv(g2))
        n1 = self.instance_color(flat_gather(f1.reshape(B, S * S, -1), v1_choose))
        n2 = self.instance_color(flat_gather(f2.reshape(B, S * S, -1), v2_choose))
        nocs1, nocs2 = self.nocs_head(n1), self.nocs_head(n2)
        R1, t1, s1 = self.heads(torch.cat([n1, self.nocs_pts_mlp(nocs1)], dim=-1))
        R2, t2, s2 = self.heads(torch.cat([n2, self.nocs_pts_mlp(nocs2)], dim=-1))
        return {"view1_nocs": nocs1, "view2_nocs": nocs2,
                "view1_r": R1, "view1_t": t1, "view1_s": s1,
                "view2_r": R2, "view2_t": t2, "view2_s": s2}
