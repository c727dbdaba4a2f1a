"""Plain PyTorch reference of the v1/v2 estimator generation, in float32 and
in eval mode: the original network of the RGBManip repository
(``AdaPose/lib/network.py``, ``StereoPoseNet``) with the NOCS-match
triangulation and PnP solve of ``AdaPose/interface.py`` and
``interface_v2.py``. A configuration names it with ``"reference": "v1"``.

The network, per view: the PSPNet of ``net.py`` at backbone stride 8, so
that the features are at the crop's full S x S resolution; the other view's
features warped over the D depth hypotheses by the bilinear plane sweep
(``net.homo_warp``) and added to the view's own; ``volume_conv``, three 1x1x1
convolutions 32 -> 16 -> 8 -> 1, each followed by an eval-mode BatchNorm and
a ReLU, which leaves one value a depth at each pixel; ``fuse_conv``, a dense
D -> 32 -> 32 stack over those D values, added back to the features, then a
ReLU. At each chosen pixel the fused feature goes through ``instance_color``
(32 -> 64) and the NOCS head; the pose heads (those of ``net.py``) read
``[instance_color, nocs_pts_mlp(nocs)]``. Module names are the program's
state-dict keys, so one seeded state loads into both. Every convolution and
dense layer is one of ``net.py``'s rounded layers, so that ``net.quantize``
rounds its operands as it does the v5 network's.

The solve reads both views' NOCS and none of the pose heads' outputs:
- matches: each view-1 point's nearest view-2 point in NOCS space (the first
  of equal distances), kept where the two are each other's nearest and the
  view-2 pixel lies within 5 px of the view-1 pixel's epipolar line (from
  the two extrinsics and the frame's intrinsics);
- triangulation: each match's world point by the two-view DLT, the null
  vector of its 4 x 4 system;
- scale: the lower median, over pairs of points taken at stride N // 128
  and both matched, of the world distance over the NOCS distance, where the
  NOCS distance is over 0.01 and the world distance under 2.0; a pair is
  valid with 8 or more matches;
- pose: DLT PnP of the scaled NOCS against the frame pixels of all N points
  (the null vector of the 2N x 12 system, its sign putting the points in
  front of the camera), orthonormalised by the nearest rotation; then the box
  of the NOCS extent, scaled, in the camera and then the world frame.

Departures from the reference repository: ``interface.py`` solves the pose
with cv2's EPnP inside RANSAC and refines it by VVS; here, as in the
measured program, DLT PnP over all points, with no RANSAC.
The warp zeros a whole sample whose projected point leaves the image or
falls behind the camera, where ``grid_sample`` zero-pads each tap. Nothing
here imports the measured program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import estimate as RE
from portbench.reference import net as RN

EPIPOLAR_PX = 5.0
MIN_MATCHES = 8


class VolumeConv(nn.Module):
    def __init__(self, cin=32):
        super().__init__()
        for i, (a, b) in enumerate(zip((cin, 16, 8), (16, 8, 1))):
            setattr(self, f"conv_{i}", RN.Conv3d(a, b, 1, bias=False))
            setattr(self, f"bn_{i}", nn.BatchNorm3d(b, eps=1e-5))

    def forward(self, vol):
        """(B, D, H, W, C) -> (B, H, W, D)."""
        x = vol.permute(0, 4, 1, 2, 3)
        for i in range(3):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x)))
        return x[:, 0].permute(0, 2, 3, 1)


class StereoPoseNetV1(nn.Module):
    """``forward`` returns, for both views, the NOCS (B, N, 3), rotation
    (B, 3, 3), translation and size (B, 3)."""

    heads = RN.StereoPoseNet.heads

    def __init__(self, backend="resnet34", n_depth=24):
        super().__init__()
        self.img_extractor = RN.PSPNet(backend, 8)
        self.volume_conv = VolumeConv(32)
        self.fuse_conv = RN._mlp((n_depth, 32, 32))
        self.instance_color = RN._mlp((32, 64), nn.ReLU())
        self.nocs_head = RN._mlp((64, 128, 64, 3), nn.Tanh())
        self.nocs_pts_mlp = RN._mlp((3, 32, 64), nn.ReLU())
        self.pose_mlp1 = RN._mlp((128, 128, 128), nn.ReLU())
        self.pose_mlp2 = RN._mlp((256, 256, 256), nn.ReLU())
        self.rotation_estimator = RN._mlp((256, 256, 128, 6))
        self.translation_estimator = RN._mlp((256, 256, 128, 3))
        self.size_estimator = RN._mlp((256, 256, 128, 3))

    def forward(self, img1, choose1, img2, choose2, proj1, proj2, depth):
        B, S = img1.shape[:2]
        f1, f2 = self.img_extractor(img1), self.img_extractor(img2)   # (B, S, S, 32)
        g1 = self.volume_conv(f1[:, None] + RN.homo_warp(f2, proj2, proj1, depth, "bilinear"))
        g2 = self.volume_conv(f2[:, None] + RN.homo_warp(f1, proj1, proj2, depth, "bilinear"))
        f1 = F.relu(f1 + self.fuse_conv(g1))
        f2 = F.relu(f2 + self.fuse_conv(g2))
        c1 = self.instance_color(RN.flat_gather(f1.reshape(B, S * S, -1), choose1))
        c2 = self.instance_color(RN.flat_gather(f2.reshape(B, S * S, -1), choose2))
        n1, n2 = self.nocs_head(c1), self.nocs_head(c2)
        R1, t1, s1 = self.heads(torch.cat([c1, self.nocs_pts_mlp(n1)], -1))
        R2, t2, s2 = self.heads(torch.cat([c2, self.nocs_pts_mlp(n2)], -1))
        return {"view1_nocs": n1, "view2_nocs": n2,
                "view1_r": R1, "view1_t": t1, "view1_s": s1,
                "view2_r": R2, "view2_t": t2, "view2_s": s2}


def network(cfg):
    return StereoPoseNetV1(cfg["backend"], int(cfg["n_depth"]))


def frame_pixels(mask, choose, S):
    """The chosen crop pixels (B, N) as (x, y) coordinates of the frame: the
    crop's pixel over the crop's scale S / window side, plus the window's
    corner (B, N, 2)."""
    rmin, rmax, cmin, _, _ = RE.windows(mask)
    h = (rmax - rmin).float()
    ratio = torch.full_like(h, S) / h
    x = (choose % S).float() / ratio[:, None] + cmin[:, None]
    y = torch.div(choose, S, rounding_mode="floor").float() / ratio[:, None] + rmin[:, None]
    return torch.stack([x, y], -1)


def null_vector(A):
    """The right singular vector of each matrix's least singular value
    (..., n); NaN for a matrix with a non-finite entry."""
    finite = torch.isfinite(A).flatten(-2).all(-1)
    v = torch.linalg.svd(torch.where(finite[..., None, None], A, 0.0),
                         full_matrices=False).Vh[..., -1, :]
    return torch.where(finite[..., None], v, torch.nan)


def nearest_rotation(M):
    """(R, s): the rotation nearest each (B, 3, 3) ``M`` and the scale that
    fits ``M`` to it, the mean of the singular values under the rotation's
    signs; NaN for a matrix with a non-finite entry."""
    finite = torch.isfinite(M).flatten(-2).all(-1)
    U, D, Vh = torch.linalg.svd(torch.where(finite[:, None, None], M, 0.0))
    sign = torch.sign(torch.linalg.det(U @ Vh))
    signs = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], -1)
    R = U @ torch.diag_embed(signs) @ Vh
    s = (D * signs).mean(-1)
    return (torch.where(finite[:, None, None], R, torch.nan),
            torch.where(finite, s, torch.nan))


def pair_distances(x):
    """(B, M, 3) -> (B, M * M) distances of every ordered pair."""
    return torch.linalg.norm(x[:, :, None] - x[:, None], dim=-1).flatten(1)


def match_scale(p1, nocs1, p2, nocs2, K, ext1, ext2):
    """NOCS-match triangulation: (scale (B,), matches (B,)) from both views'
    frame pixels (B, N, 2) and NOCS (B, N, 3)."""
    B, N, _ = nocs1.shape
    dist = torch.linalg.norm(nocs1[:, :, None] - nocs2[:, None], dim=-1)   # (B, N, N)
    to2, to1 = dist.argmin(2), dist.argmin(1)
    mutual = to1.gather(1, to2) == torch.arange(N, device=nocs1.device)
    q2 = p2.gather(1, to2[..., None].expand(-1, -1, 2))

    rel = ext2 @ torch.linalg.inv_ex(ext1).inverse                 # camera 1 -> camera 2
    t = rel[:, :3, 3]
    zero = torch.zeros_like(t[:, 0])
    t_cross = torch.stack([torch.stack([zero, -t[:, 2], t[:, 1]], -1),
                           torch.stack([t[:, 2], zero, -t[:, 0]], -1),
                           torch.stack([-t[:, 1], t[:, 0], zero], -1)], 1)
    Kinv = torch.linalg.inv_ex(K).inverse
    fundamental = Kinv.transpose(1, 2) @ t_cross @ rel[:, :3, :3] @ Kinv
    ones = torch.ones_like(p1[..., :1])
    lines = torch.cat([p1, ones], -1) @ fundamental.transpose(1, 2)     # in view 2
    off = (lines * torch.cat([q2, ones], -1)).sum(-1).abs()
    matched = mutual & (off / (torch.linalg.norm(lines[..., :2], dim=-1) + 1e-9) < EPIPOLAR_PX)

    def proj(ext):
        return (K @ ext[:, :3])[:, None]                            # (B, 1, 3, 4)
    P1, P2 = proj(ext1), proj(ext2)
    A = torch.stack([p1[..., :1] * P1[..., 2, :] - P1[..., 0, :],
                     p1[..., 1:] * P1[..., 2, :] - P1[..., 1, :],
                     q2[..., :1] * P2[..., 2, :] - P2[..., 0, :],
                     q2[..., 1:] * P2[..., 2, :] - P2[..., 1, :]], -2)    # (B, N, 4, 4)
    X = null_vector(A)
    world = X[..., :3] / X[..., 3:]

    step = max(1, N // 128)
    rd, nd = pair_distances(world[:, ::step]), pair_distances(nocs1[:, ::step])
    g = matched[:, ::step]
    keep = (g[:, :, None] & g[:, None]).flatten(1) & (nd > 0.01) & (rd < 2.0)
    scale = RE.lower_median(rd / torch.where(nd > 1e-9, nd, torch.ones_like(nd)), keep)
    return scale, matched.sum(1)


def pnp(obj, pix, K):
    """DLT PnP: (R (B, 3, 3), t (B, 3)) that take object points (B, N, 3) to
    the frame pixels (B, N, 2) through K."""
    B = obj.shape[0]
    ones = torch.ones_like(obj[..., :1])
    rays = torch.cat([pix, ones], -1) @ torch.linalg.inv_ex(K).inverse.transpose(1, 2)
    Xh = torch.cat([obj, ones], -1)
    zero = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zero, -rays[..., :1] * Xh], -1),
                   torch.cat([zero, Xh, -rays[..., 1:2] * Xh], -1)], 1)     # (B, 2N, 12)
    P = null_vector(A).reshape(B, 3, 4)
    P = P * torch.sign((Xh @ P[:, 2, :, None]).mean((1, 2)))[:, None, None]
    R, s = nearest_rotation(P[:, :, :3])
    return R, P[:, :, 3] / s[:, None]


def estimate(net, cfg, K, rgb1, mask1, ext1, rgb2, mask2, ext2, u1, u2):
    """The whole estimate -> dict ``bbox`` (B, 8, 3) world, ``valid`` (B,),
    ``R_cam`` (B, 3, 3), ``t_cam`` (B, 3), ``scale`` (B,); an invalid pair's
    bbox is the unit cube moved by +10 in each axis."""
    S, N = int(cfg["img_size"]), int(cfg["n_pts"])
    B = rgb1.shape[0]
    dev = rgb1.device
    K, ext1, ext2 = K.float(), ext1.float(), ext2.float()
    c1, ch1, nK1, ok1 = RE.prepare(rgb1, mask1, K, u1, S, N)
    c2, ch2, nK2, ok2 = RE.prepare(rgb2, mask2, K, u2, S, N)
    D = int(cfg["n_depth"])
    depth = (float(cfg["d_min"]) + float(cfg["d_interval"])
             * torch.arange(D, dtype=torch.float32, device=dev)).expand(B, D)

    def proj(nK, ext):
        P = torch.eye(4, device=dev).repeat(B, 1, 1)
        P[:, :3] = nK @ ext[:, :3]
        return P

    out = net(c1, ch1, c2, ch2, proj(nK1, ext1), proj(nK2, ext2), depth)
    nocs = out["view1_nocs"]
    p1, p2 = frame_pixels(mask1, ch1, S), frame_pixels(mask2, ch2, S)
    scale, matches = match_scale(p1, nocs, p2, out["view2_nocs"], K, ext1, ext2)
    R, t = pnp(nocs * scale[:, None, None], p1, K)
    size = 2 * nocs.abs().max(1).values * scale[:, None]
    corners = torch.tensor(RE.CORNERS, dtype=torch.float32, device=dev)
    box = R @ (corners[None] * (size / 2)[:, None, :]).transpose(1, 2) + t[:, :, None]
    inv = torch.linalg.inv_ex(ext1).inverse
    world = (inv[:, :3, :3] @ box + inv[:, :3, 3:4]).transpose(1, 2)
    valid = ok1 & ok2 & (matches >= MIN_MATCHES) & torch.isfinite(world).reshape(B, -1).all(-1)
    sentinel = torch.tensor([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)],
                            dtype=torch.float32, device=dev) + 10
    bbox = torch.where(valid[:, None, None], world, sentinel)
    return {"bbox": bbox, "valid": valid, "R_cam": R, "t_cam": t, "scale": scale}
