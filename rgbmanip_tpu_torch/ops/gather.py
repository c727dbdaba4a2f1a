"""Batched gathers (counterparts of ``rgbmanip_tpu/ops/gather.py``).

``point_sample`` is the math of the JAX package's ``point_sample_matmul``
written as the direct 4-tap gather it is: the matmul form was a way onto
the TPU's matrix unit.
"""

from __future__ import annotations

import torch


def flat_gather(table, idx):
    """table (B, M, ...trailing); idx (B, ...) int in [0, M).
    Returns table[b, idx[b, ...]] with shape (B, *idx.shape[1:], *trailing)."""
    B = table.shape[0]
    bb = torch.arange(B, device=table.device).reshape((B,) + (1,) * (idx.dim() - 1))
    return table[bb, idx.long()]


def point_sample(feat, ys, xs):
    """Bilinear samples of feat (B, H, W, C) at float pixel coords ys, xs
    (B, N); a tap outside the map reads zero (grid_sample 'zeros' padding).
    Integer coords give an exact gather. Returns (B, N, C)."""
    B, H, W, C = feat.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    out = None
    for yy in (y0, y0 + 1.0):
        wy = torch.clamp_min(1.0 - torch.abs(ys - yy), 0.0)
        for xx in (x0, x0 + 1.0):
            wx = torch.clamp_min(1.0 - torch.abs(xs - xx), 0.0)
            inside = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            w = torch.where(inside, wy * wx, torch.zeros_like(wy))
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
            term = flat_gather(feat.reshape(B, H * W, C), idx) * w[..., None].to(feat.dtype)
            out = term if out is None else out + term
    return out
