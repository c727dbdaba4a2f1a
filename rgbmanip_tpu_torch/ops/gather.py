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
    Integer coords give an exact gather. Returns (B, N, C) in feat's dtype.

    Rounds where the JAX package's two matmuls do: the weights cast to
    feat's dtype, each of the two rows interpolated along x in f32 and
    rounded to the dtype, then the rows along y, rounded again (exact at
    f32 but for the order of the sum). The taps are read from an f32 copy,
    so that the backward sums each pixel's gradient in f32 and rounds it
    once, as the matmuls' transposes do."""
    B, H, W, C = feat.shape
    dt = feat.dtype
    flat = feat.reshape(B, H * W, C).float()

    def taps(c, n):
        c0 = torch.floor(c)
        out = []
        for cc in (c0, c0 + 1.0):
            w = torch.clamp_min(1.0 - torch.abs(c - cc), 0.0)
            w = torch.where((cc >= 0) & (cc <= n - 1), w, torch.zeros_like(w))
            out.append((cc.clamp(0, n - 1).long(), w.to(dt).float()[..., None]))
        return out

    cols = taps(xs, W)
    out = None
    for yy, wy in taps(ys, H):
        row = None
        for xx, wx in cols:
            term = flat_gather(flat, yy * W + xx) * wx
            row = term if row is None else row + term
        term = row.to(dt).float() * wy
        out = term if out is None else out + term
    return out.to(dt)
