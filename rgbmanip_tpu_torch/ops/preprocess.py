"""Batched estimator preprocessing (counterpart of
``rgbmanip_tpu/ops/preprocess.py``): mask bbox -> square crop window ->
crop-resize-normalise (kernel K1) -> nearest mask resize -> random point
sampling with wrap padding -> crop-adjusted intrinsics. One batched pass on
the device, no per-env loop.
"""

from __future__ import annotations

import torch

from .crop_resize import crop_resize_normalize, crop_resize_normalize_clamp
from .gather import flat_gather


def mask_bbox_batched(mask):
    """(B, H, W) -> per-env (y1, x1, y2, x2, valid); int64 coords."""
    B, H, W = mask.shape
    ys = (mask > 0).any(dim=2)
    xs = (mask > 0).any(dim=1)
    yi = torch.arange(H, device=mask.device)[None]
    xi = torch.arange(W, device=mask.device)[None]
    y1 = torch.where(ys, yi, H).min(dim=1).values
    y2 = torch.where(ys, yi, 0).max(dim=1).values
    x1 = torch.where(xs, xi, W).min(dim=1).values
    x2 = torch.where(xs, xi, 0).max(dim=1).values
    return y1, x1, y2, x2, ys.any(dim=1)


def square_window_batched(y1, x1, y2, x2, H: int = 480, W: int = 640):
    """Square crop windows: 40-quantised max extent (capped 440), centred,
    shifted inside the frame. Integer division floors, as in the JAX
    package."""
    size = (torch.maximum(y2 - y1, x2 - x1) // 40 + 1) * 40
    size = torch.clamp_max(size, 440)
    cy = (y1 + y2) // 2
    cx = (x1 + x2) // 2
    rmin = cy - size // 2
    rmax = cy + size // 2
    cmin = cx - size // 2
    cmax = cx + size // 2
    rshift = torch.clamp_min(-rmin, 0) - torch.clamp_min(rmax - H, 0)
    cshift = torch.clamp_min(-cmin, 0) - torch.clamp_min(cmax - W, 0)
    return rmin + rshift, rmax + rshift, cmin + cshift, cmax + cshift


def _uniform(rand, shape, device):
    """``rand`` is a torch.Generator (draw here) or the (B, S*S) draws."""
    if isinstance(rand, torch.Generator):
        return torch.rand(shape, generator=rand, device=device, dtype=torch.float32)
    u = torch.as_tensor(rand, dtype=torch.float32, device=device)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"uniform draws must have shape {tuple(shape)}, "
                         f"got {tuple(u.shape)}")
    return u


BORDERS = ("renormalise", "clamp")


def prepare_model_input(rgb, mask, K, rand, out_size: int = 224,
                        n_pts: int = 1024, out_dtype=torch.float32,
                        border: str = "renormalise"):
    """rgb (B, H, W, 3) in [0, 1], mask (B, H, W) bool, K (B, 3, 3); ``rand``
    a torch.Generator or the (B, S*S) uniform draws. Returns (crop
    (B, S, S, 3) normalised in ``out_dtype`` (f32 or bf16: K1's two entry
    points), choose (B, n) int64, pts2d (B, n, 2), newK (B, 3, 3), valid
    (B,)).

    ``border`` is the crop's rule at the frame border, as the JAX package
    picks it by backend: "renormalise" (K1, the Pallas kernel's rule, which
    the JAX estimate runs on the TPU) or "clamp" (K1's clamping mode, the
    rule of the JAX package's CPU fallback, where its estimator trainer
    prepares every batch)."""
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")
    rgb = rgb.float().contiguous()
    maskf = mask.float()
    K = K.float()
    B, H, W = maskf.shape
    S = out_size
    dev = rgb.device

    y1, x1, y2, x2, has_any = mask_bbox_batched(maskf)
    rmin, rmax, cmin, cmax = square_window_batched(y1, x1, y2, x2, H, W)
    h = (rmax - rmin).float()
    # a true division: `S / h` on a tensor is reciprocal(h) * S in torch
    ratio = torch.full_like(h, S) / h                              # (B,)

    if border == "clamp":
        crop = crop_resize_normalize_clamp(rgb, rmin.float(), cmin.float(), ratio,
                                           out_size=S, out_dtype=out_dtype)
    else:
        # The JAX wrapper hands the kernel 1 / ratio = 1 / (S / h); inlined
        # here, XLA rewrites that as h * f32(1 / S), and that is the f32
        # value the main path's kernel multiplied by.
        inv_ratio = h * torch.tensor(1.0 / S, dtype=torch.float32, device=dev)
        crop = crop_resize_normalize(rgb, rmin.float(), cmin.float(), inv_ratio,
                                     out_size=S, out_dtype=out_dtype)

    # nearest crop-resize of the mask (truncation toward zero, then clip)
    ii = torch.arange(S, dtype=torch.float32, device=dev)[None]    # (1, S)
    ny = (rmin[:, None] + (ii + 0.5) / ratio[:, None]).int().clamp(0, H - 1)
    nx = (cmin[:, None] + (ii + 0.5) / ratio[:, None]).int().clamp(0, W - 1)
    nidx = ny[:, :, None] * W + nx[:, None, :]                     # (B, S, S)
    flat = flat_gather(maskf.reshape(B, H * W), nidx).reshape(B, S * S)

    # n_pts masked pixels in random order, wrap-padded. A stable descending
    # sort puts the lower index first among equal priorities, as
    # jax.lax.top_k does; ties are common near 1e3 in f32.
    count = flat.sum(dim=1).long()                                 # (B,)
    prio = _uniform(rand, (B, S * S), dev) + flat * 1e3
    order = torch.sort(prio, dim=1, descending=True, stable=True).indices[:, :n_pts]
    ranks = torch.arange(n_pts, device=dev)[None] % torch.clamp_min(count, 1)[:, None]
    choose = flat_gather(order, ranks)                             # (B, n)

    # original-image pixel coords of the chosen points
    px = (choose % S).float() / ratio[:, None] + cmin[:, None]
    py = torch.div(choose, S, rounding_mode="floor").float() / ratio[:, None] + rmin[:, None]
    pts2d = torch.stack([px, py], dim=-1)

    # crop-adjusted intrinsics
    crop_cx = (cmin + cmax).float() / 2.0
    crop_cy = (rmin + rmax).float() / 2.0
    size_x = (cmax - cmin + 1).float()
    size_y = (rmax - rmin + 1).float()
    zeros = torch.zeros(B, device=dev)
    ones = torch.ones(B, device=dev)
    newK = torch.stack([
        torch.stack([K[:, 0, 0] * ratio, zeros,
                     (K[:, 0, 2] - (crop_cx - size_x / 2)) * ratio], dim=-1),
        torch.stack([zeros, K[:, 1, 1] * ratio,
                     (K[:, 1, 2] - (crop_cy - size_y / 2)) * ratio], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=1)
    valid = has_any & (count > 0)
    return crop, choose, pts2d, newK, valid


def depth_hypotheses(batch: int, d_min: float = 0.1, d_interval: float = 0.1,
                     n: int = 24, device=None):
    """Plane-sweep depth hypotheses (B, n)."""
    vals = d_min + d_interval * torch.arange(n, dtype=torch.float32, device=device)
    return vals.expand(batch, n)
