"""Floating-point operations of the work the cells run, counted from shapes:
``torch.utils.flop_counter`` over the configuration's reference network
(``harness.reference``) on the meta device, so that the count is the same
whatever implements the work. Convolutions, transposed convolutions and
matrix products are counted (two operations a multiply-add); elementwise
work, gathers and the solve are not."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import harness as H


@functools.cache
def _estimate_flops(cfg_json, B):
    cfg = json.loads(cfg_json)
    ref = H.reference(cfg)
    S, N, D = int(cfg["img_size"]), int(cfg["n_pts"]), int(cfg["n_depth"])
    with torch.device("meta"):
        net = ref.network(cfg).eval()
        img = torch.empty(B, S, S, 3)
        choose = torch.zeros(B, N, dtype=torch.long)
        proj = torch.eye(4).repeat(B, 1, 1)
        depth = torch.empty(B, D)
    with FlopCounterMode(display=False) as fc:
        net(img, choose, img, choose, proj, proj, depth)
    return int(fc.get_total_flops())


def estimate_flops(est_cfg: dict, B: int) -> int:
    """The network's operations for one batch of ``B`` view pairs."""
    return _estimate_flops(json.dumps(est_cfg, sort_keys=True), int(B))


def mlp_flops(widths, B: int) -> int:
    """A dense stack of ``widths`` (input, hidden..., output) over B rows."""
    return 2 * B * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
