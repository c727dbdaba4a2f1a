"""AdaPose estimator training (counterpart of
``rgbmanip_tpu/models/pose_estimator/training.py``): supervised losses on
NOCS coordinates, per-point depth and the regressed rotation, translation
and size, and one Adam step per batch on the estimator's device, on one
process or over a (dp, tp) mesh (``parallel.mesh``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ...ops.preprocess import depth_hypotheses
from ...parallel.mesh import full_parameters
from .nets.stereo import FlaxBatchNorm3d


def valid_weights(labels: Dict, B: int, device) -> torch.Tensor:
    """Per-env loss weights: ``labels["valid"]`` as f32, or ones."""
    v = labels.get("valid")
    return torch.ones(B, device=device) if v is None else v.to(torch.float32)


def estimator_loss(pred: Dict, labels: Dict, regress_pose: bool = True,
                   weight_sum: Optional[torch.Tensor] = None):
    """L1 NOCS + Huber (delta 0.1) depth + L1 rotation/translation/size.

    Per-env ``labels["valid"]`` (when present) masks out samples whose view
    pair failed preparation: every term is a valid-weighted mean of per-env
    means, ``sum(per_env * w) / (sum(w) + 1e-9)``. ``weight_sum``: the sum
    of ``w`` over the whole batch when ``labels`` is one rank's block of
    it; each term is then this block's share of the batch's."""
    B = pred["view1_nocs"].shape[0]
    w = valid_weights(labels, B, pred["view1_nocs"].device)
    denom = (w.sum() if weight_sum is None else weight_sum) + 1e-9

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
    loss promotes the bf16 predictions to f32 against the f32 labels.

    With a ``mesh`` (``parallel.mesh.make_mesh``), each rank steps on its
    dp block of the batch (``shard_batch``) as the JAX package's jitted
    step runs a dp-sharded batch: the BatchNorms take their statistics over
    the dp sub-group's whole batch; the forward and backward run on the full
    parameters (``full_parameters``: a DTensor's ``full_tensor``, so every
    activation stays a plain tensor); each gradient's local shard and the
    loss are summed over the dp sub-group (each rank's loss is its share of
    the batch's mean, so the sum is the batch's); Adam steps the parameters
    as they are placed (``apply_shardings``). Autograd labels a sharded
    parameter's gradient ``Replicate()`` on dp although its values differ
    between dp ranks: DTensor would not reduce it, so the step does."""

    def __init__(self, model, lr: float = 1e-4, mesh=None):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.mesh = mesh
        self.group = None if mesh is None else mesh.get_group("dp")
        if mesh is not None:
            for m in model.modules():
                if isinstance(m, FlaxBatchNorm3d):
                    m.process_group = self.group

    def loss(self, batch, params=None, weight_sum=None):
        """(total, parts) of the model on ``batch``, with ``params`` (plain
        tensors by name) in place of the model's own when given."""
        args = (batch["img1"], batch["choose1"], batch["img2"], batch["choose2"],
                batch["P1"], batch["P2"], batch["depth_values"])
        out = (self.model(*args) if params is None
               else torch.func.functional_call(self.model, params, args))
        return estimator_loss(out, batch, weight_sum=weight_sum)

    def step(self, batch):
        """One step on a batch of device tensors (this rank's block of it,
        with a mesh); returns (total, parts) as floats, the whole batch's."""
        self.model.train()
        try:
            if self.mesh is None:
                total, parts = self.loss(batch)
                self.optimizer.zero_grad(set_to_none=True)
                total.backward()
            else:
                total, parts = self._sharded_grads(batch)
            self.optimizer.step()
        finally:
            self.model.eval()
        return float(total.detach()), {k: float(v.detach()) for k, v in parts.items()}

    def _sharded_grads(self, batch):
        """Each parameter's gradient and the loss, summed over the dp
        sub-group in one all-reduce; returns the batch's (total, parts)."""
        w = valid_weights(batch, batch["img1"].shape[0], batch["img1"].device)
        weight_sum = w.sum()
        dist.all_reduce(weight_sum, group=self.group)
        total, parts = self.loss(batch, full_parameters(self.model), weight_sum)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        params = [p for p in self.model.parameters() if p.grad is not None]
        local = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                 for p in params]
        keys = sorted(parts)
        flat = torch.cat([g.reshape(-1) for g in local]
                         + [total.detach().reshape(1)]
                         + [parts[k].detach().reshape(1) for k in keys])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for p, g in zip(params, local):
            red = flat[offset:offset + g.numel()].view_as(g)
            offset += g.numel()
            p.grad = (DTensor.from_local(red, p.grad.device_mesh, p.grad.placements,
                                         run_check=False)
                      if isinstance(p.grad, DTensor) else red)
        values = flat[offset:]
        return values[0], {k: values[1 + i] for i, k in enumerate(keys)}


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
