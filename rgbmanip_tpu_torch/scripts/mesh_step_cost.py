"""What the mesh path costs a training step on the card.

    python -m rgbmanip_tpu_torch.scripts.mesh_step_cost [--reps 2]

Runs ``graft_entry.dryrun_multichip`` over every card of the machine (one
nccl rank per card) and the same steps unsharded on the first card
(``graft_entry.dryrun_steps`` without a mesh), ``--reps`` times in turn,
and prints one JSON line: the card's name and power limit, the world size,
the mesh, and per repetition the ms of the estimator step and of the PPO
update, sharded and unsharded (each the median of 3 calls after the
first). At world 1 the difference is the cost of the mesh path itself.
Needs a card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..graft_entry import dryrun_multichip, dryrun_steps
from .perfutil import card_line, require_card


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    require_card("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = torch.cuda.device_count()
    reps = []
    for _ in range(args.reps):
        sharded = dryrun_multichip(n)
        whole = dryrun_steps(sharded["dp"], sharded["tp"], device="cuda")
        reps.append({f"{k}_{side}": out[f"{k}_ms"] for k in ("estimator", "ppo")
                     for side, out in (("sharded", sharded), ("unsharded", whole))})
    print(json.dumps({"card": card_line(), "world": n, "dp": sharded["dp"],
                      "tp": sharded["tp"], "ms": reps}))


if __name__ == "__main__":
    main()
