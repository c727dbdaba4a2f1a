"""Least work of K2, the fused bilinear plane-sweep warp of one direction of
the estimate (the reference view's features plus the other view's warped
over the depth hypotheses).

Bytes: the fused volume (B, C, D, H, W) written once, and both views'
feature maps (B, H, W, C) read once, in the cell's dtype. The projection's
inputs (a few MB of rays and depths) and the taps' re-reads are left out:
the count is the work, whatever implements it. Operations (9 a channel: 4
products, 3 sums, the mask and the add) are far below the card's balance, so
the bytes bound it.
"""

from __future__ import annotations

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
# the channels of the fused volume: the PSPNet's 32 features
CHANNELS = 32


def launch_bytes(B: int, C: int, D: int, H: int, W: int, elem_bytes: int) -> int:
    """Least bytes of one launch."""
    return (B * C * D * H * W + 2 * B * H * W * C) * elem_bytes


def cell_launch_bytes(cfg: dict, wl: dict) -> int:
    """Least bytes of one launch at a cell's shapes: its batch and dtype
    (the workload file), the volume's resolution and depths (the
    configuration)."""
    Sv = int(cfg["img_size"]) // int(cfg["volume_scale"])
    return launch_bytes(int(wl["batch"]), CHANNELS, int(cfg["n_depth"]), Sv, Sv,
                        DTYPE_BYTES[wl["dtype"]])
