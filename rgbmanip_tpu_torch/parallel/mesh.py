"""Device mesh and sharding (counterpart of ``rgbmanip_tpu/parallel/mesh.py``).

The JAX package runs one program over a (dp, tp) mesh and lets GSPMD place
the collectives. Here every rank is a process of an initialised
``torch.distributed`` process group (``parallel.launch``), and the six names
of the JAX module keep their meaning in torch's idiom:

  - data parallelism (dp): each rank holds its block of the batch's sample
    (or env) axis (``shard_batch``); the trainers reduce what GSPMD reduces
    for them (gradients, BatchNorm statistics, losses, the KL) over the dp
    sub-group;
  - tensor parallelism (tp): wide estimator kernels are DTensors sharded on
    their output dim over tp (``param_shardings``, ``apply_shardings``); a
    step computes on their full tensors (``DTensor.full_tensor``, an
    all-gather that autograd differentiates) and Adam steps the shards.

``batch_sharding`` and ``replicated`` are placements, the counterpart of
the JAX module's ``NamedSharding``s; ``param_shardings`` maps each parameter
name to ``(mesh, placements)``, which ``apply_shardings`` takes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..models.pose_estimator.converter import model_key_map


def make_mesh(n_devices: Optional[int] = None, tp: int = 1) -> DeviceMesh:
    """(dp, tp) mesh over the ranks of the initialised process group, which
    must number ``n_devices`` (its world size by default): the card type
    of an ``nccl`` group, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.run_ranks starts one)")
    world = dist.get_world_size()
    n = n_devices or world
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=("dp", "tp"))


def batch_sharding(mesh: DeviceMesh) -> List[Placement]:
    """The leading (batch/env) axis sharded over dp, replicated over tp."""
    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    return [Replicate(), Replicate()]


def shard_batch(batch, mesh: DeviceMesh, dim: int = 0):
    """This rank's dp block of ``dim`` of each tensor in ``batch`` (a tensor
    or a dict of them): dim 0 for a (B, ...) batch, 1 for a (T, N, ...)
    rollout, whose envs the JAX dryrun shards (``PartitionSpec(None,
    "dp")``). Ranks of one dp block (its tp ranks) get the same rows."""
    dp, r = mesh.size(0), mesh.get_local_rank("dp")

    def block(x):
        n = x.shape[dim]
        if n % dp:
            raise ValueError(f"axis {dim} of length {n} does not split over dp={dp}")
        return x.narrow(dim, r * (n // dp), n // dp).contiguous()
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, dim) for k, v in batch.items()}
    return block(batch)


def _output_dim(module: nn.Module) -> int:
    """Where torch keeps a weight's output features: dim 1 of a transposed
    convolution's (in, out, *k), dim 0 of a convolution's or a linear
    layer's (flax keeps them last in every kernel)."""
    return 1 if isinstance(module, nn.ConvTranspose3d) else 0


def param_shardings(model: nn.Module, mesh: DeviceMesh, min_tp_dim: int = 64
                    ) -> Dict[str, Tuple[DeviceMesh, List[Placement]]]:
    """The JAX module's rule on an estimator network (``StereoPoseNetWithDepth``
    or ``StereoPoseNetV1``): a parameter whose flax counterpart is a
    ``kernel`` of two or more dims, with an output dim of at least
    ``min_tp_dim`` divisible by the tp size, is sharded on that dim over tp;
    every other parameter is replicated. The flax counterpart of each
    parameter comes from the converter's key map, and its output dim from
    the layout of the module that holds it."""
    tp = mesh.size(1)
    kmap = model_key_map(model)
    owners = {f"{m}.{n}" if m else n: mod for m, mod in model.named_modules()
              for n, _ in mod.named_parameters(recurse=False)}
    out = {}
    for name, p in model.named_parameters():
        placements = replicated(mesh)
        _, fpath, _ = kmap[name]
        if fpath[-1] == "kernel" and p.dim() >= 2:
            d = _output_dim(owners[name])
            if p.shape[d] >= min_tp_dim and p.shape[d] % tp == 0:
                placements = [Replicate(), Shard(d)]
        out[name] = (mesh, placements)
    return out


def apply_shardings(model: nn.Module, shardings) -> nn.Module:
    """Place each named parameter of ``model`` on its mesh, in place
    (``param_shardings``' map): a parameter whose placements shard a mesh
    dim of more than one rank becomes a DTensor holding this rank's shard
    (``distribute_tensor``, rank 0's values); every other one stays a plain
    tensor, set to rank 0's values, since a DTensor that holds the whole
    tensor would only add its dispatch to every op of a step. The module's
    own forward then no longer takes plain tensors where a parameter is a
    DTensor: ``EstimatorTrainer(..., mesh=...)`` runs it on the full
    tensors."""
    for name, (mesh, placements) in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = getattr(mod, leaf)
        if any(pl.is_shard() and mesh.size(d) > 1 for d, pl in enumerate(placements)):
            setattr(mod, leaf, nn.Parameter(distribute_tensor(p.detach(), mesh, placements),
                                            requires_grad=p.requires_grad))
        else:   # the mesh spans the process group (make_mesh)
            with torch.no_grad():
                dist.broadcast(p.data, src=int(mesh.mesh.flatten()[0]))
    return model


def full_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` as a plain tensor: a DTensor's full
    tensor (differentiable), any other parameter itself."""
    return {n: p.full_tensor() if isinstance(p, DTensor) else p
            for n, p in model.named_parameters()}
