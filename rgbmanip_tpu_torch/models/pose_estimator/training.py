"""AdaPose estimator training (counterpart of
``rgbmanip_tpu/models/pose_estimator/training.py``): supervised losses on
NOCS coordinates, per-point depth and the regressed rotation, translation
and size, and one Adam step per batch on the estimator's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops.preprocess import depth_hypotheses


def estimator_loss(pred: Dict, labels: Dict, regress_pose: bool = True):
    """L1 NOCS + Huber (delta 0.1) depth + L1 rotation/translation/size.

    Per-env ``labels["valid"]`` (when present) masks out samples whose view
    pair failed preparation: every term is a valid-weighted mean of per-env
    means, ``sum(per_env * w) / (sum(w) + 1e-9)``."""
    B = pred["view1_nocs"].shape[0]
    v = labels.get("valid")
    w = (torch.ones(B, device=pred["view1_nocs"].device) if v is None
         else v.to(torch.float32))
    denom = w.sum() + 1e-9

    def wmean(x):
        per = x.reshape(B, -1).mean(dim=1)
        return (per * w).sum() / denom

    def huber(d):
        return wmean(torch.where(d.abs() < 0.1, 0.5 * d ** 2 / 0.1, d.abs() - 0.05))

    losses = {}
    losses["nocs"] = (wmean((pred["view1_nocs"] - labels["nocs1"]).abs())
                      + wmean((pred["view2_nocs"] - labels["nocs2"]).abs()))
    losses["depth"] = (huber(pred["view1_depth"] - labels["depth1"])
                       + huber(pred["view2_depth"] - labels["depth2"]))
    if regress_pose and "r1" in labels:
        losses["rot"] = (wmean((pred["view1_r"] - labels["r1"]).abs())
                         + wmean((pred["view2_r"] - labels["r2"]).abs()))
        losses["trans"] = (wmean((pred["view1_t"] - labels["t1"]).abs())
                           + wmean((pred["view2_t"] - labels["t2"]).abs()))
        losses["size"] = (wmean((pred["view1_s"] - labels["s1"]).abs())
                          + wmean((pred["view2_s"] - labels["s2"]).abs()))
    total = (losses["nocs"] + losses["depth"]
             + 0.3 * losses.get("rot", 0.0) + losses.get("trans", 0.0)
             + losses.get("size", 0.0))
    return total, losses


class EstimatorTrainer:
    """Adam (``optax.adam``: eps 1e-8, no clipping, no weight decay) on
    every parameter of ``model``, a ``StereoPoseNetWithDepth`` on its
    device. Each ``step`` runs the network in train mode (batch statistics
    in the CostRegNet's BatchNorms, whose running statistics it updates) and
    leaves it in eval mode. Forward and backward run in the model's compute
    dtype with f32 parameters, so the gradients and Adam are f32, as
    ``jax.value_and_grad`` over the JAX package's flax model gives them; the
    loss promotes the bf16 predictions to f32 against the f32 labels."""

    def __init__(self, model, lr: float = 1e-4):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def loss(self, batch):
        out = self.model(batch["img1"], batch["choose1"], batch["img2"],
                         batch["choose2"], batch["P1"], batch["P2"],
                         batch["depth_values"])
        return estimator_loss(out, batch)

    def step(self, batch):
        """One step on a batch of device tensors; returns (total, parts)
        as floats."""
        self.model.train()
        try:
            total, parts = self.loss(batch)
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
            self.optimizer.step()
        finally:
            self.model.eval()
        return float(total.detach()), {k: float(v.detach()) for k, v in parts.items()}


def synthetic_batch(generator: torch.Generator, B: int, S: int, N: int,
                    n_depth: int = 24, device: Optional[torch.device] = None):
    """Random but geometrically consistent batch for smoke use; draws from
    ``generator`` (on ``device``)."""
    def u(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    def idx():
        return torch.randint(0, S * S, (B, N), generator=generator, device=device)

    eye4 = torch.eye(4, device=device).expand(B, 4, 4).clone()
    eye3 = torch.eye(3, device=device).expand(B, 3, 3).clone()
    return {
        "img1": u((B, S, S, 3)), "img2": u((B, S, S, 3)),
        "choose1": idx(), "choose2": idx(),
        "P1": eye4, "P2": eye4.clone(),
        "depth_values": depth_hypotheses(B, n=n_depth, device=device),
        "nocs1": u((B, N, 3), -0.5, 0.5), "nocs2": u((B, N, 3), -0.5, 0.5),
        "depth1": u((B, N), 0.3, 2.0), "depth2": u((B, N), 0.3, 2.0),
        "r1": eye3, "r2": eye3.clone(),
        "t1": torch.zeros(B, 3, device=device), "t2": torch.zeros(B, 3, device=device),
        "s1": torch.full((B, 3), 0.3, device=device),
        "s2": torch.full((B, 3), 0.3, device=device),
    }
