"""How far one bf16 training step on the card parts from the CPU's, slice by
slice and loss part by loss part, beside faults that a card-vs-CPU gate on
those parts should see.

    python -m rgbmanip_tpu_torch.scripts.bf16_step_spread [--seeds 7 8 9]

For each seed, ``train_estimator.main`` at the production recipe
(``scripts/tunnel_watch_estimator.sh:66-70``, 8 envs, as
``tests/test_torch_cuda.py::test_estimator_trainer_main_on_card`` runs it)
in bf16 on the card from the committed head for 3 steps; then, from the
head it saved, one ``EstimatorTrainer`` step on each 2-env slice of the
last batch and on the whole batch, in bf16 and f32, on the card and on the
CPU. For each slice and loss part it gives ``r``, the card's bf16 part's
relative difference from the CPU's, and ``c``, the CPU's own bf16-to-f32
relative difference, which the gate of ``tests/test_torch_cuda.py::
test_bf16_estimator_training_step_on_card_matches_cpu`` holds ``r``
against; and ``r`` for four steps on the card that a sound card does not
take:

- ``f32``: the card's f32 step in bf16's place;
- ``fused_bias``: bf16 with every layer's bias added inside its product,
  one rounding where flax rounds twice (a mirrored rounding step left out);
- ``shift1``, ``shift4``: bf16 with both views' crops moved one or four
  pixels along x, with wrap-around (a crop kernel that many pixels off).

Then, for each seed, the least multiplier ``k`` at which the rule
``r <= max(k * c, 1e-2)`` passes every part of every slice, and of the
whole batch, for the sound step and for each control (a limit of ``k``
rejects exactly the runs that need more), and the card's bf16-to-f32
difference summed over the slices over the CPU's (that test's other check
holds it at half or more). Its last line of output is one JSON object; on
a card only.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..models.pose_estimator import train_estimator as TE
from ..models.pose_estimator.adapose import AdaPoseEstimator
from ..models.pose_estimator.nets import layers
from ..models.pose_estimator.training import EstimatorTrainer
from .perfutil import card_line, require_card

CKPT = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
RECIPE = ["dataset=cabinet_train", "task=open_cabinet", "task.num_envs=8",
          "img_size=192", "backend=resnet18", "backbone_stride=32", "volume_scale=8",
          "n_depth=16", "d_interval=0.15", "warp_mode=nearest", "reuse=8"]
FLOOR = 1e-2          # the card test's least bound, relative
CONTROLS = ("f32", "fused_bias", "shift1", "shift4")
ENVS, STEPS = 2, 3    # the card tests' batch width and bf16 training steps


def _fused_apply(mod, fn, x, bias_view):
    dt = mod.compute_dtype
    b = None if mod.bias is None else mod.bias.to(dt)
    return fn(x.to(dt), mod.weight.to(dt), b)


def step_parts(cfg, device, dtype, batch, control=None):
    """The loss parts of one ``EstimatorTrainer`` step of a fresh estimator
    from ``cfg``'s head on ``batch``, with ``control`` applied."""
    batch = {k: v.to(device) for k, v in batch.items()}
    if control in ("shift1", "shift4"):
        batch.update({k: torch.roll(batch[k], int(control[5:]), dims=2)
                      for k in ("img1", "img2")})
    kept = layers._apply
    if control == "fused_bias":
        layers._apply = _fused_apply
    try:
        est = AdaPoseEstimator(cfg, device=device, dtype=dtype)
        _, parts = EstimatorTrainer(est.model, lr=1e-4).step(batch)
    finally:
        layers._apply = kept
    return parts


def rel(a, b):
    return {k: abs(a[k] - b[k]) / abs(b[k]) for k in b}


def slice_readings(cfg, dev, batch):
    """{"r", "c", "c_card", control: r} by loss part for one slice."""
    cpu = torch.device("cpu")
    c16 = step_parts(cfg, cpu, torch.bfloat16, batch)
    c32 = step_parts(cfg, cpu, torch.float32, batch)
    g16 = step_parts(cfg, dev, torch.bfloat16, batch)
    g32 = step_parts(cfg, dev, torch.float32, batch)
    out = {"r": rel(g16, c16), "c": rel(c16, c32), "c_card": rel(g16, g32),
           "f32": rel(g32, c16)}
    for control in CONTROLS[1:]:
        out[control] = rel(step_parts(cfg, dev, torch.bfloat16, batch, control), c16)
    return out


def last_batch(seed, steps, head, log_dir):
    """Train ``steps`` bf16 steps from the committed head on the card; the
    last batch (on the card) and the saved head's estimator config."""
    kept = []
    orig = EstimatorTrainer.step

    def step(self, batch):
        kept.append(batch)
        return orig(self, batch)
    EstimatorTrainer.step = step
    try:
        est = TE.main(RECIPE + [f"seed={seed}", f"steps={steps}", f"resume={CKPT}",
                                f"save={head}", f"log_dir={log_dir}", "device=cuda"])
    finally:
        EstimatorTrainer.step = orig
    return kept[-1], dict(est.cfg, load=True, checkpoint_path=head)


def k_needed(readings, key="r"):
    """The least k at which ``r <= max(k * c, FLOOR)`` holds for ``key``'s
    every part of every reading in ``readings``."""
    return max(x[key][p] / x["c"][p] if x[key][p] > FLOOR else 0.0
               for x in readings for p in x["c"])


def run(seeds=(7, 8, 9)):
    dev = require_card("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = []
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        for seed in seeds:
            head = os.path.join(tmp, f"head{seed}.ckpt")
            batch, cfg = last_batch(seed, STEPS, head, os.path.join(tmp, f"logs{seed}"))
            B = batch["img1"].shape[0]
            slices = {f"{lo}-{lo + ENVS - 1}": slice_readings(
                cfg, dev, {k: v[lo:lo + ENVS] for k, v in batch.items()})
                for lo in range(0, B, ENVS)}
            whole = slice_readings(cfg, dev, batch)
            batches.append({"seed": seed, "slices": slices, "whole": whole})
    sound = sorted(x["r"][p] / x["c"][p] if x["c"][p] else float("inf")
                   for b in batches for x in b["slices"].values() for p in x["c"])
    for b in batches:
        slices = list(b["slices"].values())
        b["k_needed"] = {scope: {key: k_needed(xs, key) for key in ("r",) + CONTROLS}
                         for scope, xs in (("slices", slices), ("whole", [b["whole"]]))}
        b["card_own_over_cpu_own"] = (sum(sum(x["c_card"].values()) for x in slices)
                                      / sum(sum(x["c"].values()) for x in slices))
    return {"card": card_line(), "seeds": list(seeds), "envs": ENVS, "steps": STEPS,
            "n_sound_readings": len(sound), "sound_ratio_max": sound[-1],
            "sound_ratio_median": sound[len(sound) // 2], "batches": batches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    a = ap.parse_args(argv)
    print(json.dumps(run(tuple(a.seeds))), flush=True)


if __name__ == "__main__":
    main()
