"""Entry points of the port (counterpart of ``__graft_entry__.py``).

``entry(device=None)`` returns a forward on the flagship model (the AdaPose
``StereoPoseNetWithDepth`` at the JAX module's defaults, resnet34, in bf16)
plus example args for a single-card check.

``dryrun_multichip(n_devices, device=None)`` builds an n-rank (dp, tp) mesh
and runs ONE training step of both trainable components: the estimator
(batch sharded over dp, wide kernels sharded over tp) and the PPO update
(rollout sharded over dp on its env axis), at the JAX function's shapes. On
the CPU (``device="cpu"``) the ranks are ``gloo`` processes, as the JAX
package's are virtual CPU devices; by default they are ``nccl`` processes,
one per card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import resolve_device
from .algo.ppo import PPO
from .models.pose_estimator.nets.stereo import StereoPoseNetWithDepth, flax_init_
from .models.pose_estimator.training import EstimatorTrainer, synthetic_batch
from .ops.preprocess import depth_hypotheses
from .parallel.launch import run_ranks
from .parallel.mesh import apply_shardings, make_mesh, param_shardings, shard_batch
from .utils.tools import Box

# StereoPoseNetWithDepth's defaults in the JAX package, where the port's
# are the fast production knobs
JAX_NET_DEFAULTS = {"backbone_stride": 8, "volume_scale": 1, "warp_mode": "bilinear"}
PPO_CFG = {
    "policy": {"pi_hid_sizes": [96, 96, 32], "vf_hid_sizes": [96, 96, 32],
               "activation": "elu"},
    "learn": {"num_transitions_per_env": 8, "num_learning_epochs": 2,
              "num_mini_batches": 2, "clip_range": 0.2, "gamma": 0.98,
              "lam": 0.98, "init_noise_std": 0.6, "value_loss_coef": 1.0,
              "entropy_coef": 0.0, "learning_rate": 3e-4,
              "max_grad_norm": 1.0, "use_clipped_value_loss": True,
              "schedule": "adaptive", "desired_kl": 0.016, "max_lr": 5e-3,
              "min_lr": 2e-4},
}
ENTRY_SHAPE = (2, 224, 1024, 24)   # B, S, N points, D depths


def flagship_net(dtype=torch.bfloat16, device=None) -> StereoPoseNetWithDepth:
    """``entry``'s network in eval mode, its weights drawn by ``flax_init_``
    from seed 0 (the same weights in every dtype)."""
    model = StereoPoseNetWithDepth(backend="resnet34", regress_pose=True, dtype=dtype,
                                   **JAX_NET_DEFAULTS)
    flax_init_(model, torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()


def entry(device=None):
    """(forward, args): the flagship network's bf16 forward at
    ``ENTRY_SHAPE`` (B=2, S=224, N=1024 points, D=24 depths), returning
    (view1_nocs, view1_depth, view1_r); the args drawn from a seeded CPU
    generator, then moved to ``device`` (the card by default)."""
    dev = resolve_device(device)
    B, S, N, D = ENTRY_SHAPE
    model = flagship_net(torch.bfloat16, dev)
    g = torch.Generator().manual_seed(0)
    eye = torch.eye(4).expand(B, 4, 4)
    args = tuple(a.to(dev) for a in (
        torch.rand(B, S, S, 3, generator=g).to(torch.bfloat16),
        torch.randint(0, S * S, (B, N), generator=g),
        torch.rand(B, S, S, 3, generator=g).to(torch.bfloat16),
        torch.randint(0, S * S, (B, N), generator=g),
        eye.clone(), eye.clone(), depth_hypotheses(B, n=D)))

    @torch.no_grad()
    def forward(v1_img, v1_choose, v2_img, v2_choose, P1, P2, depth_values):
        out = model(v1_img, v1_choose, v2_img, v2_choose, P1, P2, depth_values)
        return out["view1_nocs"], out["view1_depth"], out["view1_r"]

    return forward, args


class _SpacesOnly:
    def __init__(self, num_envs):
        self.num_envs = num_envs
        self.observation_space = Box(-1, 1, shape=(60,))
        self.state_space = Box(-1, 1, shape=(75,))
        self.action_space = Box(-1, 1, shape=(12,))

    def reset(self):
        raise RuntimeError("dryrun only")


def _median_ms(fn, device, reps: int = 3) -> float:
    """The median time of ``reps`` calls of ``fn`` in ms, host clock around
    each synchronised call."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def dryrun_steps(dp: int, tp: int, device=None, mesh=None) -> dict:
    """The dryrun's steps for a (dp, tp) mesh: one estimator training step
    (resnet18 at the JAX module's defaults, B = 2 dp, S=32, N=64, D=8),
    when tp > 1 one at the production shape (resnet34, 224 px, 24 depths,
    ``volume_scale`` 2, nearest warp, B = dp), and one PPO update (obs 60,
    state 75, 12 actions, T=8, N = 4 dp, 2 epochs x 2 minibatches). Each
    rank of ``mesh`` steps on its block; without a mesh the same steps run
    whole on one process. Weights and batches come from seeds (made on the
    CPU, then moved), so the two agree. The results are the first call's;
    the estimator step and the PPO update then run three times more, and
    ``*_ms`` is the median of those. Returns floats and lists."""
    dev = resolve_device(device)
    out = {"dp": dp, "tp": tp}

    def estimator_step(B, S, N, D, seed, **knobs):
        model = StereoPoseNetWithDepth(regress_pose=True, **knobs)
        flax_init_(model, torch.Generator().manual_seed(0))
        model.to(dev)
        batch = {k: v.to(dev) for k, v in synthetic_batch(
            torch.Generator().manual_seed(seed), B, S, N, n_depth=D).items()}
        if mesh is not None:
            apply_shardings(model, param_shardings(model, mesh))
            batch = shard_batch(batch, mesh)
        return EstimatorTrainer(model, mesh=mesh), batch

    trainer, batch = estimator_step(2 * dp, 32, 64, 8, 0, backend="resnet18",
                                    **JAX_NET_DEFAULTS)
    total, parts = trainer.step(batch)
    out["estimator_ms"] = _median_ms(lambda: trainer.step(batch), dev)
    if not np.isfinite(total):
        raise RuntimeError("estimator dryrun loss not finite")
    out["estimator_loss"], out["estimator_parts"] = total, parts

    if tp > 1:
        # the tp sharding of the wide conv channels is only meaningful at
        # the real widths and resolution (cfg/pose_estimator/adapose_*.yaml);
        # one sample per dp block keeps the CPU run bounded
        trainer, batch = estimator_step(dp, 224, 64, 24, 1, backend="resnet34",
                                        backbone_stride=8, volume_scale=2,
                                        warp_mode="nearest")
        total2, _ = trainer.step(batch)
        if not np.isfinite(total2):
            raise RuntimeError("production-shape dryrun loss not finite")
        out["production_loss"] = total2

    T, Ne = 8, 4 * dp
    ppo = PPO(_SpacesOnly(Ne), PPO_CFG, seed=0, device=dev, mesh=mesh)
    rng = np.random.default_rng(0)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    batch = {
        "obs": put(rng.normal(size=(T, Ne, 60))),
        "states": put(rng.normal(size=(T, Ne, 75))),
        "actions": put(rng.normal(size=(T, Ne, 12))),
        "logprobs": put(rng.normal(size=(T, Ne))),
        "values": put(rng.normal(size=(T, Ne))),
        "returns": put(rng.normal(size=(T, Ne))),
        "advantages": put(rng.normal(size=(T, Ne))),
        "mu": put(rng.normal(size=(T, Ne, 12))),
        "sigma": put(np.abs(rng.normal(size=(T, Ne, 12))) + 0.5),
    }
    if mesh is not None:
        batch = shard_batch(batch, mesh, dim=1)
    metrics = ppo._update(batch).cpu().numpy()
    out["ppo_ms"] = _median_ms(lambda: ppo._update(batch), dev)
    if not np.isfinite(metrics).all():
        raise RuntimeError("PPO dryrun metrics not finite")
    out["ppo_metrics"] = metrics.tolist()
    return out


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    tp = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(world, tp=tp)
    return dryrun_steps(mesh.size(0), tp, device, mesh)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded training step on an ``n_devices``-rank mesh (tp = 2 when
    ``n_devices`` is even and at least 4): ``n_devices`` processes of
    ``gloo`` on the CPU with ``device="cpu"``, else of ``nccl``, one per
    card (it raises with fewer cards). Prints the JAX function's lines and
    returns rank 0's ``dryrun_steps`` result."""
    dev = resolve_device(device)
    out = run_ranks(_dryrun_rank, n_devices, dev.type, dev.type)[0]
    dp, tp = out["dp"], out["tp"]
    if "production_loss" in out:
        print(f"dryrun production-shape (224px/r34/24-depth) dp={dp} tp={tp}: "
              f"loss {out['production_loss']:.4f}")
    print(f"dryrun_multichip OK: mesh dp={dp} tp={tp}, "
          f"estimator loss {out['estimator_loss']:.4f}, "
          f"ppo metrics {np.asarray(out['ppo_metrics'])[:3]}")
    return out
