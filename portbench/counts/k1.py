"""Least work of K1, the crop -> bilinear resize -> normalise of each view
(the renormalising border mode of the estimate).

Bytes: each distinct source pixel that a tap with a non-zero weight touches
read once (3 f32 values, 12 bytes), each output value written once (4
bytes in f32, 2 in bf16), each window's three parameters read once.
Operations: 11 f32 operations an output value. The taps are the estimate's
rule: output row (column) i samples source (i + 0.5) * side / S + lo - 0.5
with its two neighbours, a neighbour outside the frame dropped.
"""

from __future__ import annotations

import torch

from ..reference.estimate import hat_taps, windows

OPS_PER_VALUE = 11


def crop_bytes(rmin, cmin, inv_ratio, S: int, H: int, W: int, out_bytes: int) -> int:
    rmin, cmin, inv_ratio = rmin.cpu().float(), cmin.cpu().float(), inv_ratio.cpu().float()

    def distinct(lo, inv, n):
        i0, i1, w0, w1 = hat_taps(lo, inv, S, n)
        return int(torch.unique(torch.cat([i0[w0 > 0], i1[w1 > 0]])).numel())

    B = rmin.shape[0]
    src = sum(distinct(rmin[b:b + 1], inv_ratio[b:b + 1], H)
              * distinct(cmin[b:b + 1], inv_ratio[b:b + 1], W) for b in range(B))
    return src * 12 + B * S * S * 3 * out_bytes + B * 12


def view_work(mask, S: int, dtype) -> tuple:
    """(bytes, operations) of K1 on one batch of masks (B, H, W)."""
    B, H, W = mask.shape
    rmin, rmax, cmin, _, _ = windows(mask)
    inv = (rmax - rmin).float() * torch.tensor(1.0 / S, dtype=torch.float32,
                                               device=mask.device)
    out_bytes = 2 if dtype == torch.bfloat16 else 4
    return (crop_bytes(rmin, cmin, inv, S, H, W, out_bytes),
            B * S * S * 3 * OPS_PER_VALUE)


def estimate_bytes(x: dict, S: int, dtype) -> tuple:
    """(bytes, operations) of K1 over both views of one estimate's batch."""
    b1, o1 = view_work(x["mask1"], S, dtype)
    b2, o2 = view_work(x["mask2"], S, dtype)
    return b1 + b2, o1 + o2
