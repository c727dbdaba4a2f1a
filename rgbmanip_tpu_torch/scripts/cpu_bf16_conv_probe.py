"""Whether the CPU's bf16 ``Conv3d`` weight gradient comes back whole.

    python -m rgbmanip_tpu_torch.scripts.cpu_bf16_conv_probe [--calls 300]

At the CostRegNet's conv6 shape (64 -> 64 channels, 3x3x3, over a 2x3x3
volume; B=2 and 8), each call frees NaN-filled memory first, then takes the
weight gradient of ``sum(y^2)`` two ways: autograd through PyTorch's own
bf16 ``F.conv3d`` ("raw") and through the port's bf16 ``Conv3d``
(``nets/layers.py``, "port"). Prints one JSON line: the PyTorch version,
its CPU threads and, per batch, the calls whose weight gradient holds a
non-finite element. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..models.pose_estimator.nets.layers import Conv3d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    m = Conv3d(64, 64, 3, 1, padding=1, bias=False, dtype=torch.bfloat16)
    out = {"torch": torch.__version__, "threads": torch.get_num_threads(), "calls": args.calls}
    for B in (2, 8):
        bad = {"raw": 0, "port": 0}
        for _ in range(args.calls):
            junk = [torch.full((1 << k,), float("nan")) for k in range(10, 22)]
            del junk
            x = torch.randn(B, 64, 2, 3, 3)
            w = m.weight.detach().clone().requires_grad_()
            y = F.conv3d(x.to(torch.bfloat16), w.to(torch.bfloat16), None, 1, 1)
            (y.float() ** 2).sum().backward()
            bad["raw"] += int(not torch.isfinite(w.grad).all())
            m.weight.grad = None
            (m(x).float() ** 2).sum().backward()
            bad["port"] += int(not torch.isfinite(m.weight.grad).all())
        out[f"B={B}"] = bad
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
