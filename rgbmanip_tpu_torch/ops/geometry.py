"""Batched pose-recovery geometry (counterpart of
``rgbmanip_tpu/ops/geometry.py``): the three solves of the estimator
(direct regression's scale and translation; depth back-projection with
RANSAC-Umeyama; NOCS-match triangulation with DLT PnP). Every function takes
a leading batch dimension where the JAX package ``vmap``s over the env
batch.

SVD: a singular vector's sign is free, so each result is written to be
independent of it, as the JAX package's are: Umeyama's and PnP's rotation
``(U * S) @ Vh`` pairs each left vector with its right one, triangulation
divides by the null vector's last entry, and PnP fixes the sign of its null
vector by the points' depth. A matrix with a non-finite entry gives NaN
(``jnp.linalg.svd`` does; LAPACK may raise instead).
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


def _svd(A, full_matrices: bool = True):
    """``torch.linalg.svd`` of a batch of matrices, NaN for a matrix with a
    non-finite entry."""
    bad = ~torch.isfinite(A).flatten(-2).all(-1)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, A),
                                full_matrices=full_matrices)
    nan = float("nan")
    return (torch.where(bad[..., None, None], nan, U), torch.where(bad[..., None], nan, S),
            torch.where(bad[..., None, None], nan, Vh))


def _proper(U, D, Vh):
    """The rotation nearest ``U diag(D) Vh`` and the signs that make it one:
    (R, S) with S = (1, 1, sign(det U det Vh))."""
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vh))
    S = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], dim=-1)
    return (U * S[..., None, :]) @ Vh, S


def umeyama(source, target, weights=None):
    """Weighted similarity transform source -> target (Umeyama), batched:
    source, target (..., N, 3); weights (..., N) nonnegative. Returns
    (scale (...), R (..., 3, 3), t (..., 3)) with target ~= scale * R @
    source + t."""
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=source.dtype, device=source.device)
    w = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    mu_s = (w[..., None] * source).sum(-2)
    mu_t = (w[..., None] * target).sum(-2)
    cs = source - mu_s[..., None, :]
    ct = target - mu_t[..., None, :]
    cov = (ct * w[..., None]).transpose(-1, -2) @ cs
    U, D, Vh = _svd(cov)
    R, S = _proper(U, D, Vh)
    var_s = (w[..., None] * cs ** 2).sum((-2, -1))
    scale = (D * S).sum(-1) / (var_s + 1e-12)
    t = mu_t - scale[..., None] * (R @ mu_s[..., None])[..., 0]
    return scale, R, t


def ransac_hypotheses(generator, B: int, N: int, n_hypotheses: int = 128, device=None):
    """(B, n_hypotheses, 5) point indices in [0, N) drawn from ``generator``."""
    return torch.randint(0, N, (B, n_hypotheses, 5), generator=generator, device=device)


def ransac_umeyama(source, target, idx, min_inlier_ratio: float = 0.1):
    """RANSAC similarity estimation over every hypothesis at once: source,
    target (B, N, 3); idx (B, H, 5) the points of each hypothesis (the JAX
    package draws ``randint(key, (128, 5), 0, N)`` per env;
    ``ransac_hypotheses`` draws them from a generator). The inlier threshold
    is the hypothesis's scale times a tenth of the source's diameter; the
    best hypothesis is the first with the most inliers, and the transform is
    refitted on its inliers. Returns (scale, R, t, valid)."""
    B, N, _ = source.shape
    diameter = 2.0 * torch.linalg.norm(source - source.mean(1, keepdim=True),
                                       dim=-1).max(1).values
    inlier_t = diameter / 10.0

    def pick(x):
        return x[torch.arange(B, device=x.device)[:, None, None], idx]   # (B, H, 5, 3)
    s, R, t = umeyama(pick(source), pick(target))
    moved = s[..., None, None] * (source[:, None] @ R.transpose(-1, -2)) + t[:, :, None]
    resid = torch.linalg.norm(target[:, None] - moved, dim=-1)          # (B, H, N)
    inliers = resid < (s * inlier_t[:, None])[..., None]
    counts = inliers.sum(-1)
    best = torch.argmax(counts, dim=1)           # the first of the largest counts
    ar = torch.arange(B, device=source.device)
    scale, R, t = umeyama(source, target, inliers[ar, best].to(source.dtype))
    valid = counts[ar, best] / N >= min_inlier_ratio
    return scale, R, t, valid


def triangulate_dlt(p1, P1, p2, P2):
    """Two-view DLT triangulation: p1, p2 (B, N, 2) pixels; P1, P2 (B, 3, 4)
    or (B, 4, 4) projections. Returns (B, N, 3) world points."""
    P1 = P1[:, None, :3]
    P2 = P2[:, None, :3]
    A = torch.stack([p1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
                     p1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
                     p2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
                     p2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)  # (B, N, 4, 4)
    X = _svd(A)[2][..., -1, :]
    return X[..., :3] / (X[..., 3:] + 1e-12)


def _pair_dist(x):
    """(B, M, 3) -> (B, M * M) distances of every ordered pair."""
    return torch.linalg.norm(x[:, :, None] - x[:, None], dim=-1).flatten(1)


def depth_from_nocs_matches(pts2d_1, nocs_1, P1, ext1, pts2d_2, nocs_2, P2, ext2, K,
                            epipolar_t: float = 5.0):
    """NOCS-space mutual nearest neighbours across the two views, epipolar
    filtering, DLT triangulation and the median ratio of pairwise distances,
    batched over B: pts2d (B, N, 2), nocs (B, N, 3), P (B, 4, 4), ext
    (B, 4, 4), K (B, 3, 3). Returns (scale (B,), valid (B,)). The nearest
    neighbour is the first of equal distances, as ``jnp.argmin``'s."""
    B, N, _ = nocs_1.shape
    diff = nocs_1[:, :, None] - nocs_2[:, None]
    dis = torch.sqrt((diff * diff).sum(-1))                              # (B, N, N)
    m12 = torch.argmin(dis, dim=2)
    m21 = torch.argmin(dis, dim=1)
    mutual = torch.gather(m21, 1, m12) == torch.arange(N, device=nocs_1.device)

    matched_2d_2 = torch.gather(pts2d_2, 1, m12[..., None].expand(-1, -1, 2))
    T21 = ext2 @ torch.linalg.inv_ex(ext1).inverse
    R = T21[:, :3, :3]
    t = T21[:, :3, 3]
    z = torch.zeros_like(t[:, 0])
    tx = torch.stack([torch.stack([z, -t[:, 2], t[:, 1]], -1),
                      torch.stack([t[:, 2], z, -t[:, 0]], -1),
                      torch.stack([-t[:, 1], t[:, 0], z], -1)], dim=1)
    Kinv = torch.linalg.inv_ex(K).inverse
    Fm = Kinv.transpose(1, 2) @ tx @ R @ Kinv
    ones = torch.ones_like(pts2d_1[..., :1])
    x1h = torch.cat([pts2d_1, ones], -1)
    x2h = torch.cat([matched_2d_2, ones], -1)
    lines = x1h @ Fm.transpose(1, 2)                   # epipolar lines in view 2
    num = (lines * x2h).sum(-1).abs()
    den = torch.linalg.norm(lines[..., :2], dim=-1) + 1e-9
    good = mutual & (num / den < epipolar_t)

    world = triangulate_dlt(pts2d_1, P1, matched_2d_2, P2)
    step = max(1, N // 128)
    rd = _pair_dist(world[:, ::step])
    nd = _pair_dist(nocs_1[:, ::step])
    g = good[:, ::step]
    pair_ok = (g[:, :, None] & g[:, None]).flatten(1) & (nd > 0.01) & (rd < 2.0)
    ratio = rd / torch.where(nd > 1e-9, nd, torch.ones_like(nd))
    return masked_median(ratio, pair_ok), good.sum(1) >= 8


def pnp_dlt(obj_pts, img_pts, K, weights=None):
    """Direct-linear-transform PnP with orthonormalisation, batched:
    obj_pts (B, N, 3) scaled model points, img_pts (B, N, 2) pixels, K
    (B, 3, 3). Returns (R (B, 3, 3), t (B, 3))."""
    B, N, _ = obj_pts.shape
    if weights is None:
        weights = torch.ones(B, N, dtype=obj_pts.dtype, device=obj_pts.device)
    w = torch.sqrt(weights / (weights.sum(1, keepdim=True) + 1e-9))[..., None]
    ones = torch.ones_like(obj_pts[..., :1])
    Kinv = torch.linalg.inv_ex(K).inverse
    rays = torch.cat([img_pts, ones], -1) @ Kinv.transpose(1, 2)       # normalised rays
    u, v = rays[..., 0:1], rays[..., 1:2]
    Xh = torch.cat([obj_pts, ones], -1)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -u * Xh], -1) * w
    rows_v = torch.cat([zeros, Xh, -v * Xh], -1) * w
    A = torch.cat([rows_u, rows_v], 1)                                 # (B, 2N, 12)
    P = _svd(A, full_matrices=False)[2][:, -1].reshape(B, 3, 4)
    # the sign that puts the points in front of the camera
    P = P * torch.sign((Xh @ P[:, 2, :, None])[..., 0].mean(1))[:, None, None]
    U, D, Vh = _svd(P[:, :, :3])
    R, S = _proper(U, D, Vh)
    s = (D * S).mean(-1)
    return R, P[:, :, 3] / (s[:, None] + 1e-12)
