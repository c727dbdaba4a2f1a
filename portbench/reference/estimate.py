"""Plain PyTorch reference of one batched pose estimate: preprocessing of
both views, the network (``net.StereoPoseNet``) and the direct-regression
solve, in float32.

Preprocessing, per view: the mask's bounding box, a square window of the
box's larger side rounded up to a multiple of 40 (at most 440) centred on it
and shifted into the frame, the window resampled to S x S with hat weights
renormalised over the taps inside the frame, ImageNet normalisation; the
mask resized by nearest sampling; ``n_pts`` masked pixels in the order of
the uniform draws (wrapped when the mask has fewer), and the intrinsics
moved onto the crop. The solve: the points back-projected at their
regressed depth, the scale as the median ratio of pairwise distances in the
camera and in NOCS, the translation from the centroids under the regressed
rotation, then the 3-D box of the NOCS extent in the world frame. A pair
whose mask is empty or whose solve is not finite is invalid.
"""

from __future__ import annotations

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
CORNERS = ((1, 1, 1), (1, 1, -1), (-1, 1, 1), (-1, 1, -1),
           (1, -1, 1), (1, -1, -1), (-1, -1, 1), (-1, -1, -1))


def windows(mask):
    """(B, H, W) bool -> square windows (rmin, rmax, cmin, cmax) and whether
    the mask has any pixel."""
    B, H, W = mask.shape
    ys, xs = mask.any(2), mask.any(1)
    yi = torch.arange(H, device=mask.device)[None]
    xi = torch.arange(W, device=mask.device)[None]
    y1 = torch.where(ys, yi, H).min(1).values
    y2 = torch.where(ys, yi, 0).max(1).values
    x1 = torch.where(xs, xi, W).min(1).values
    x2 = torch.where(xs, xi, 0).max(1).values
    size = ((torch.maximum(y2 - y1, x2 - x1) // 40 + 1) * 40).clamp_max(440)
    cy, cx = (y1 + y2) // 2, (x1 + x2) // 2
    rmin, rmax, cmin, cmax = cy - size // 2, cy + size // 2, cx - size // 2, cx + size // 2
    rs = (-rmin).clamp_min(0) - (rmax - H).clamp_min(0)
    cs = (-cmin).clamp_min(0) - (cmax - W).clamp_min(0)
    return rmin + rs, rmax + rs, cmin + cs, cmax + cs, ys.any(1)


def hat_taps(lo, inv_ratio, S, n):
    """Per output row (or column): the two source taps i0, i1 and their
    weights, zero outside the frame, renormalised to sum 1 (floor 1e-6)."""
    ii = torch.arange(S, dtype=torch.float32, device=lo.device)[None]
    # one rounding of (i + 0.5) * inv_ratio + lo, as a fused multiply-add
    src = ((ii + 0.5).double() * inv_ratio[:, None].double()
           + lo[:, None].double()).float() - 0.5
    f0 = torch.floor(src)
    f1 = f0 + 1
    w0 = torch.clamp_min(1 - (src - f0).abs(), 0)
    w1 = torch.clamp_min(1 - (src - f1).abs(), 0)
    in0 = (f0 >= 0) & (f0 <= n - 1)
    in1 = (f1 >= 0) & (f1 <= n - 1)
    w0, w1 = w0 * in0, w1 * in1
    norm = torch.clamp_min(w0 + w1, 1e-6)
    return (torch.where(in0, f0, 0).long(), torch.where(in1, f1, 0).long(),
            w0 / norm, w1 / norm)


def crop(rgb, rmin, cmin, inv_ratio, S):
    """(B, H, W, 3) in [0, 1] -> (B, S, S, 3) resampled and normalised."""
    B, H, W, _ = rgb.shape
    y0, y1, wy0, wy1 = hat_taps(rmin.float(), inv_ratio, S, H)
    x0, x1, wx0, wx1 = hat_taps(cmin.float(), inv_ratio, S, W)
    bb = torch.arange(B, device=rgb.device)[:, None, None]

    def tap(yi, xi):
        return rgb[bb, yi[:, :, None], xi[:, None, :]]

    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]
    wx0, wx1 = wx0[:, None, :, None], wx1[:, None, :, None]
    v = (wx0 * (wy0 * tap(y0, x0) + wy1 * tap(y1, x0))
         + wx1 * (wy0 * tap(y0, x1) + wy1 * tap(y1, x1)))
    mean = torch.tensor(MEAN, device=rgb.device)
    std = torch.tensor(STD, device=rgb.device)
    return (v - mean) / std


def prepare(rgb, mask, K, u, S, n_pts):
    """One view: (crop (B, S, S, 3), choose (B, n) flat crop pixels, newK
    (B, 3, 3), whether the mask has a pixel (B,)); ``u`` (B, S*S) the
    point-sampling draws."""
    B, H, W = mask.shape
    rmin, rmax, cmin, cmax, has_any = windows(mask)
    h = (rmax - rmin).float()
    ratio = torch.full_like(h, S) / h
    inv_ratio = h * torch.tensor(1.0 / S, dtype=torch.float32, device=h.device)
    img = crop(rgb.float(), rmin, cmin, inv_ratio, S)
    ii = torch.arange(S, dtype=torch.float32, device=rgb.device)[None]
    ny = (rmin[:, None] + (ii + 0.5) / ratio[:, None]).int().clamp(0, H - 1)
    nx = (cmin[:, None] + (ii + 0.5) / ratio[:, None]).int().clamp(0, W - 1)
    bb = torch.arange(B, device=rgb.device)[:, None, None]
    flat = mask.float()[bb, ny[:, :, None], nx[:, None, :]].reshape(B, S * S)
    count = flat.sum(1).long()
    # masked pixels first, each group in descending draw order, the lower
    # index first among equal priorities
    order = torch.sort(u + flat * 1e3, dim=1, descending=True, stable=True).indices
    ranks = torch.arange(n_pts, device=rgb.device)[None] % count.clamp_min(1)[:, None]
    choose = torch.gather(order[:, :n_pts], 1, ranks)
    ccx = (cmin + cmax).float() / 2
    ccy = (rmin + rmax).float() / 2
    sx = (cmax - cmin + 1).float()
    sy = (rmax - rmin + 1).float()
    newK = torch.zeros(B, 3, 3, device=rgb.device)
    newK[:, 0, 0] = K[:, 0, 0] * ratio
    newK[:, 0, 2] = (K[:, 0, 2] - (ccx - sx / 2)) * ratio
    newK[:, 1, 1] = K[:, 1, 1] * ratio
    newK[:, 1, 2] = (K[:, 1, 2] - (ccy - sy / 2)) * ratio
    newK[:, 2, 2] = 1
    return img, choose, newK, has_any


def lower_median(values, mask):
    """Lower median of values[b][mask[b]] per row; NaN for an empty row."""
    mask = mask & torch.isfinite(values)
    n = mask.sum(1)
    srt = torch.sort(torch.where(mask, values, torch.inf), dim=1).values
    k = ((n + 1) // 2 - 1).clamp_min(0)
    med = srt.gather(1, k[:, None])[:, 0]
    return torch.where(n > 0, med, torch.nan)


def solve(depth, nocs, choose, newK, R, S):
    """Direct regression's scale and translation -> (bbox (B, 3, 8) in the
    camera frame, scale (B,), translation (B, 3))."""
    B = depth.shape[0]
    px = (choose % S).float()
    py = torch.div(choose, S, rounding_mode="floor").float()
    fx, fy = newK[:, 0, 0, None], newK[:, 1, 1, None]
    cx, cy = newK[:, 0, 2, None], newK[:, 1, 2, None]
    cam = torch.stack([(px - cx) * depth / fx, (py - cy) * depth / fy, depth], -1)
    step = max(1, cam.shape[1] // 128)
    c, n = cam[:, ::step], nocs[:, ::step]
    real = torch.linalg.norm(c[:, :, None] - c[:, None], dim=-1).reshape(B, -1)
    nd = torch.linalg.norm(n[:, :, None] - n[:, None], dim=-1).reshape(B, -1)
    ratio = real / torch.where(nd > 1e-9, nd, torch.ones_like(nd))
    scale = lower_median(ratio, (nd > 0.01) & (real < 0.3))
    rotated = scale[:, None, None] * (nocs @ R.transpose(1, 2))
    t = cam.mean(1) - rotated.mean(1)
    size = 2 * nocs.abs().max(1).values * scale[:, None]
    corners = torch.tensor(CORNERS, dtype=torch.float32, device=depth.device)
    box = (corners[None] * (size / 2)[:, None, :]).transpose(1, 2)      # (B, 3, 8)
    return R @ box + t[:, :, None], scale, t


def estimate(net, cfg, K, rgb1, mask1, ext1, rgb2, mask2, ext2, u1, u2):
    """The whole estimate -> dict ``bbox`` (B, 8, 3) world, ``valid`` (B,),
    ``R_cam`` (B, 3, 3), ``t_cam`` (B, 3), ``scale`` (B,); an invalid pair's
    bbox is the unit cube moved by +10 in each axis."""
    S, N = int(cfg["img_size"]), int(cfg["n_pts"])
    B = rgb1.shape[0]
    dev = rgb1.device
    K = K.float()
    c1, ch1, nK1, ok1 = prepare(rgb1, mask1, K, u1, S, N)
    c2, ch2, nK2, ok2 = prepare(rgb2, mask2, K, u2, S, N)
    D = int(cfg["n_depth"])
    depth = (float(cfg["d_min"]) + float(cfg["d_interval"])
             * torch.arange(D, dtype=torch.float32, device=dev)).expand(B, D)

    def proj(nK, ext):
        P = torch.eye(4, device=dev).repeat(B, 1, 1)
        P[:, :3] = nK @ ext[:, :3]
        return P

    out = net(c1, ch1, c2, ch2, proj(nK1, ext1.float()), proj(nK2, ext2.float()), depth)
    R = out["view1_r"]
    box, scale, t = solve(out["view1_depth"], out["view1_nocs"], ch1, nK1, R, S)
    inv = torch.linalg.inv_ex(ext1.float()).inverse
    world = (inv[:, :3, :3] @ box + inv[:, :3, 3:4]).transpose(1, 2)
    valid = ok1 & ok2 & torch.isfinite(world).reshape(B, -1).all(-1)
    sentinel = torch.tensor([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)],
                            dtype=torch.float32, device=dev) + 10
    bbox = torch.where(valid[:, None, None], world, sentinel)
    return {"bbox": bbox, "valid": valid, "R_cam": R, "t_cam": t, "scale": scale}
