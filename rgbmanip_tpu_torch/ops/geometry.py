"""Batched pose-recovery geometry for the direct-regression solve
(counterpart of the parts of ``rgbmanip_tpu/ops/geometry.py`` that the
flagship estimate runs). Every function takes a leading batch dimension.
"""

from __future__ import annotations

import torch


def masked_median(values, mask):
    """Lower median of values[b][mask[b]] per row, exact, through a sort.
    values, mask (B, M). NaN where a row has no finite masked value."""
    mask = mask & torch.isfinite(values)
    n = mask.sum(dim=1)
    v = torch.where(mask, values, torch.full_like(values, float("inf")))
    srt = torch.sort(v, dim=1).values
    k = torch.clamp_min(torch.div(n + 1, 2, rounding_mode="floor") - 1, 0)
    med = srt.gather(1, k[:, None])[:, 0]
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def compute_scale(cam_pts, nocs_pts, max_pairs_dim: int = 128,
                  real_dis_cap: float = 0.3):
    """Median ratio of pairwise distances. cam_pts, nocs_pts (B, N, 3); the
    points are subsampled with stride N // max_pairs_dim, as in the JAX
    package, to bound the pairwise matrix. Returns (B,)."""
    B, N, _ = cam_pts.shape
    step = max(1, N // max_pairs_dim)
    c = cam_pts[:, ::step]
    n = nocs_pts[:, ::step]
    real = torch.linalg.norm(c[:, :, None, :] - c[:, None, :, :], dim=-1).reshape(B, -1)
    nocs = torch.linalg.norm(n[:, :, None, :] - n[:, None, :, :], dim=-1).reshape(B, -1)
    valid = (nocs > 0.01) & (real < real_dis_cap)
    ratio = real / torch.where(nocs > 1e-9, nocs, torch.ones_like(nocs))
    return masked_median(ratio, valid)


def backproject(depth, pts2d, K):
    """Pixel coords (B, N, 2) with per-point depth (B, N) through K (B, 3, 3)
    -> camera points (B, N, 3)."""
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    x = (pts2d[..., 0] - cx) * depth / fx
    y = (pts2d[..., 1] - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def compute_scale_and_translation(pred_depth, pred_nocs, pts2d, K, rotation):
    """Scale from pairwise-distance medians, translation from centroids under
    the regressed rotation (B, 3, 3). Returns (translation (B, 3), scale (B,))."""
    cam_pts = backproject(pred_depth, pts2d, K)
    scale = compute_scale(cam_pts, pred_nocs)
    rotated = scale[:, None, None] * (pred_nocs @ rotation.transpose(1, 2))
    translation = cam_pts.mean(dim=1) - rotated.mean(dim=1)
    return translation, scale


_CORNERS = ((1, 1, 1), (1, 1, -1), (-1, 1, 1), (-1, 1, -1),
            (1, -1, 1), (1, -1, -1), (-1, -1, 1), (-1, -1, -1))


def get_3d_bbox(size):
    """8-corner bboxes (B, 3, 8) for extents ``size`` (B, 3)."""
    corners = torch.tensor(_CORNERS, dtype=torch.float32, device=size.device)
    return (corners[None] * (size / 2)[:, None, :]).transpose(1, 2)


def transform_coordinates_3d(coords, sRT):
    """(B, 3, N) points through (B, 4, 4) transforms."""
    ones = torch.ones_like(coords[:, :1])
    out = sRT @ torch.cat([coords, ones], dim=1)
    return out[:, :3] / out[:, 3:4]
