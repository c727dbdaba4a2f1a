"""Start one process per rank of a ``torch.distributed`` process group.

The JAX package runs its mesh in one process; a torch mesh needs a process
per rank. ``run_ranks(fn, world, device)`` spawns ``world`` processes
(``torch.multiprocessing`` with the spawn method), joins them into one
process group and calls ``fn(rank, world, *args)`` in each, then returns
every rank's result. On the CPU the ranks use ``gloo`` and one thread each
(the counterpart of the JAX package's virtual CPU devices); on the card
``nccl``, one rank per card, with TF32 off as in every f32 path of the port.
The ranks meet through a file store in a temporary directory, so that
concurrent runs never contend for a port. ``fn`` must be importable by name
(a module-level function) and its result must hold only tensors, numbers,
strings and lists or dicts of them.
"""

from __future__ import annotations

import os
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world: int, device: str, *args) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in a rank
    of a ``world``-rank process group on ``device`` ("cpu" or "cuda")."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks need {world} cards (nccl runs one rank per "
                           f"card); this machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, device, tmp, fn, args), nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world)]


def _rank(rank, world, device, tmp, fn, args):
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    # a collective that waits 5 minutes raises rather than hang the run
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            world_size=world, rank=rank, timeout=timedelta(minutes=5))
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
