#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py    # from the repo root, on a machine with a card

The script drives every path of the port. The main one is the flagship
evaluation itself (``python -m rgbmanip_tpu_torch.train`` with
``controller=rl``, ``pose_estimator=adapose_cabinet_fast`` and
``checkpoints/estimator_fast_cabinet_aug_r5.ckpt``, 8 envs, seed 11; the
protocol of ``scripts/r5_cabinet_evals.sh``): the simulator renders each
view on the host, the PPO actor on the card picks the next camera pose, the
estimator on the card turns each env's last two views into a world bbox
(K1 on every estimate), ``consensus_fuse`` merges the per-step bboxes and
the scripted skill opens the door. Before it, the same estimate/policy/fuse
service runs on synthetic views made from a seed. The second path is the
row-gather probe (``scripts/try_gather.py``, the one entry point of kernel
K5) at its default shape; the third the paper-size estimator
(``adapose_cabinet``: resnet34 at backbone stride 8, 224 px, a 112x112x24
cost volume, 1024 points) on weights made from a seed, since its released
weights are not in the repo. Then the two trainers: PPO training of the
camera scheduler (``python -m rgbmanip_tpu_torch.train controller=rl
train=controller``, resumed from the committed policy) and the estimator's
trainer (``python -m rgbmanip_tpu_torch.models.pose_estimator.train_estimator``
at the production recipe of ``scripts/tunnel_watch_estimator.sh``, resumed
from the committed head), both with K1 on every estimate or batch. The last
two are the heuristic two-view controller with AdaPose on the pot and the
mug (the README's rows, ``scripts/r5_chain.sh``; one estimate per round,
K1 twice) and the estimator's inference harness on view pairs that
``train=collect`` wrote (``python -m
rgbmanip_tpu_torch.models.pose_estimator.inference``, one batch of 8). Then
the JAX package's default compute dtype, bf16: the estimate (flagship and
paper size), ``evaluate`` and the estimator's trainer at their defaults;
and every estimator generation of ``make_estimator`` with the heuristic
round of ``pose_estimator=adapose_baseline``. Last, the run modes of the
eighth slice: the RL skill (``manipulation=rl``, trained and played), the
URDF fixture datasets (the gt stack on all four, a flagship round on the
cabinet) and the real-world env with fake drivers. Then the last modules:
the config generator and multi-device training (``graft_entry``'s
``entry`` and ``dryrun_multichip``), and the scripts that produce and
explain the results table: the evaluation sweep and the failure
diagnostics; last, the JAX package's timing scripts as the port runs them
(``rgbmanip_tpu_torch.bench`` and ``rgbmanip_tpu_torch/scripts/bench_*.py``),
each in its own process. The estimator's trainer
crops with K1's clamping border mode, as the JAX package's trainer crops
on its CPU backend. Each path runs with every launch counter set to 0 just
before it and read just after. Phases:

  1. card: name, power limit, versions; TF32 off for the f32 phases
  2. build every kernel of the path with nvcc (sm_90a) and the simulator's
     C++ core with g++, all at once
  3. each kernel against its plain PyTorch version on the card
  4. load the estimator and the policy onto the card
  5. the service loop, B=8, 4 steps, with every launch counter set to 0
     just before it and read just after
  6. the same estimate on the card and on the CPU (plain path)
  7. timings: each kernel's device time (torch.profiler) beside its bound,
     its plain version's and the library call's, for K1 at B=8 and B=64
     (192 px) and at B=16 (224 px, the paper size), and at B=8 also with
     the L2 flushed before each launch; back-to-back call times (CUDA
     events, ``perfutil.bench``); estimate wall time, device busy time and
     the kernels that take it, at B=8 and B=64
  8. the gather probe: K5 at (16, 112, 32, 24) bf16 through the probe's
     ``run``, bit-exact against ``index_select``
  9. the paper-size estimate at B=8 and B=16 (K1 twice per estimate, K1
     against its plain version at 224 px), card against CPU at B=2
 10. timings: K5's device time beside its bound, its plain version's and
     ``index_select``'s; the gather-regime sweep; the paper estimate's wall
     time, busy time, idle share and top kernels at B=8 and B=16, and where
     the warp and the point gathers rank among them
 11. the flagship evaluation, one round of 8 episodes through
     ``rgbmanip_tpu_torch.train``'s functions on the card, with every launch
     counter set to 0 just before it and read just after: success rate,
     move distance and seconds per episode (printed, not gated), the
     PhaseTimer split, the host-to-device copy per estimate; K1 bit for bit
     against its plain version on every window the round fed it; the same
     round on the CPU with the same point-sampling draws (made on the CPU
     from one seed) and the card's camera moves, gated on equal frames,
     actions within 1e-5, two-view estimates and the fused bbox within
     1e-3 m, equal success; and the user's command through ``train.main``
     under ``RGBMANIP_PROFILE``, gated on ``result.json`` and on K1 launches
     inside the loop's ``estimate`` ranges of the trace
 12. PPO training through ``train.main`` (``train=controller``, 8 envs, 2
     iterations of 16 transitions, into a temporary ``save_dir``): K1 twice
     per rollout step, collect and learn seconds per iteration and the
     PhaseTimer split; the last update again on the card and on the CPU from
     the same batch and state (learning rates equal, parameters within 2e-5
     for the actor and 2e-4 for the critic); the saved ``model_<it>.ckpt``
     read back into a fresh trainer, equal
 13. the estimator's trainer through ``train_estimator.main`` (8 envs, reuse
     8, 192 px, 5 steps): K1 twice per prepared batch; steps per second split
     into render, preparation and train step, the host-to-device bytes; the
     saved head loaded back, the same estimate within 1e-5 m; one step's device
     time, idle share and top kernels, and the forward and backward device
     time of the warp (K2), point samples (K3) and pose gathers (K4); one step
     on the card against the CPU from the saved head (loss parts 1e-4
     relative, BatchNorm statistics 1e-4, parameters within two learning
     rates and rounding, 2.1e-4)
 14. heuristic + AdaPose, one round of 8 episodes on ``pot_test`` and on
     ``mug_test`` through ``rgbmanip_tpu_torch.train``'s functions on the
     card, each with every launch counter set to 0 just before it and read
     just after (K1 twice per round): success rate, move distance and
     seconds per episode (printed, not gated) and the PhaseTimer split; K1
     bit for bit against its plain version on the round's windows; the same
     round on the CPU with the same draws and the card's bbox for the
     skill, gated on equal views and cameras, estimates within 1e-3 m,
     equal success and move distance. Then ``train=collect``
     (``collect_pose``, 8 envs) writes 8 view pairs and ``inference.main``
     estimates them on the card in one batch of 8 (counters set to 0 just
     before, K1 twice, K2 twice: the estimator's default network warps
     bilinearly at full resolution); the same batch on the card and on the
     CPU with the same draws within 1e-3 m and equal valid flags; K2 on the
     card estimate's own calls, (8, 32, 24, 224, 224) in f32, bit for bit
     against the eager warp in the channels-last layout both write, and
     timed beside its bound; the estimate's wall
     time, device busy time, idle share and top kernels at B=8
 15. bf16, the JAX package's default compute dtype: the flagship and
     paper-size estimates with K1's bf16 entry point, ``evaluate`` on the
     mug and ``train_estimator.main`` at its default, each card against
     the CPU; every generation of ``make_estimator`` card against the CPU,
     and a heuristic round of ``pose_estimator=adapose_baseline``
 16. ``RLManipulation`` (``manipulation=rl`` with the learn and policy
     blocks of ``controller/rl.yaml``): one ``train.train_manipulation``
     iteration through ``train.main``, 8 envs x 16 transitions on
     ``open_cabinet`` on the card, the same iteration on the CPU from the
     card's initial weights and by its actions (rollout equal, losses
     within 1e-3 relative, parameters as phase 12), then ``play`` on the
     card in a ``train=test`` round
 17. the URDF fixture datasets: one round of the gt stack on each of the
     four (card and CPU equal), and one round of the flagship evaluation
     on ``cabinet_urdf_fixture``, card against the CPU lock-step as phase
     11 (K1 twice per estimate, two-view estimates within 1e-3 m)
 18. the real-world env with fake robot, camera and segmenter drivers: two
     estimates of the ``realworld`` generation at ``adapose_cabinet_fast``'s
     widths on seeded weights on its 480x640 views (one with an empty
     mask: the sentinel), card against the CPU within 1e-3 m, K1 twice each
 19. the config generator: ``generate_cfg.main`` into a temporary directory;
     the flagship run's groups composed from it with ``load_config(...,
     cfg_root=...)`` equal the committed tree's composition but for the
     hand-edited ``controller/rl``; the trees differ in exactly the listed
     files; the next ``load_config`` without ``cfg_root`` reads the
     committed tree (host only)
 20. multi-device: ``graft_entry.entry()``'s bf16 forward on the card and on
     the CPU, within twice the CPU's own bf16-to-f32 difference (phase 15's
     rule, on each output's mean); ``dryrun_multichip(torch.cuda.device_count())``
     through NCCL, one rank per card (world 1 here: dp=1, tp=1), its
     estimator loss and PPO metrics against the same steps run unsharded on
     the CPU at 1e-4 relative, and the ms per sharded step beside the
     unsharded step's on the card. Neither path launches K1 or K5 (the
     dryrun's batches come cropped, as the JAX dryrun's do); ``entry()``
     launches K2 twice a forward, held bit for bit against the eager warp
     in the channels-last layout on its own calls in bf16 and timed; and the
     bf16 U-Net at the parity cell's volume, (16, 32, 24, 224, 224), timed
     on K2's channels-last layout and on an NCDHW copy
 21. the evaluation sweep and the failure diagnostics
     (``rgbmanip_tpu_torch/scripts/``), each through its ``main`` or the
     sweep's own row loop, with every launch counter set to 0 just before
     each run and read just after: ``eval_sweep.main`` at one round of 8
     over all 16 gt rows on the card and on the CPU, equal row for row; one
     heuristic + AdaPose row of the sweep per estimator family (cabinet,
     drawer, pot, mug; K1 twice per estimate); ``diag_flagship.main`` at one
     round of 8 (K1 twice per recorded estimate of the RL and the heuristic
     run); ``trace_mug_learned.main`` at one round (K1 twice). It fails on
     any error row or failed run and on a learned-stack run with no K1
     launch, and prints each run's seconds
 22. the timing scripts, each at a short size in its own process on the
     card, the five side by side (``TIMING_SCRIPTS``; their times are not
     measurements then): ``python -m rgbmanip_tpu_torch.bench`` at
     B=8 and 64 (iters 2, reps 1; with its f32 B=64, B=8 and bf16 B=8 rows),
     ``bench_estimate`` ``FAST`` at B=16, ``bench_ppo_update``,
     ``bench_ppo_iter`` at 8 envs for one iteration and
     ``bench_sim_scaling`` at 1 and 8 envs for one cycle. It fails on a
     non-zero exit and on any printed number that is not finite and
     positive; it reads the bench's K1 launches per row, counted in its
     process by the wrapper with the counters set to 0 just before the row
     (2 per estimate), and adds them to the kernels line; then it holds the
     bench estimate at B=8 in f32 on the card against the same inputs and
     draws on the CPU, on the bench's own views and with the second camera
     raised 1 mm: valid flags equal, bbox within 1e-3 m. On the own views
     the volume's first and last rows sit on the source's border, a tie
     that each device's last bit breaks: the CPU replays the card's
     decisions for those rays, after checking that no other ray's differs

Phase 3 also holds K1 against its plain version on a reversed window (an
empty mask gives a window of negative side), and K1's clamping border mode
(the estimator trainer's crop, phases 13 and 15c) bit for bit in f32 and
bf16 on the synthetic views' windows and on a sweep of centred, edge and
corner windows; phase 7 times it beside ``grid_sample(padding_mode=
"border")``. K5, bit-exact, at (16, 112, 32, 24) in bf16 and f32 and at
(1, 640, 8, 2), where the index arithmetic wraps around int32.

Any failure exits non-zero. The line before the last is the kernels' JSON
(K1's f32 launches as ``crop_resize_normalize``, its bf16 entry point's
apart as ``crop_resize_normalize_bf16``, its clamping mode's as
``crop_resize_normalize_clamp`` and ``crop_resize_normalize_clamp_bf16``:
no path runs the latter, since both packages' samplers crop in f32; K2's
f32 launches, phase 14's, as ``plane_sweep_fuse`` and its bf16 launches,
phase 20's, as ``plane_sweep_fuse_bf16``, each timed on its path's calls,
the latter with the bf16 U-Net's time in both layouts as ``library_ms``),
the line before that the card's name and power limit, and the last line is
``{"ok": true, "device": {...}}``. Without a card the script exits 1 and
prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 480, 640
STEPS, B_MAIN, B_WIDE = 4, 8, 64
B_PAPER = (8, 16)              # the evaluation's num_envs; the probe's batch
S_PAPER = 224                  # adapose_cabinet's img_size
L2_FLUSH_BYTES = 96 * 2 ** 20  # written between launches for an L2-cold reading (L2: 50 MB)
B_PAPER_CPU = 2
PAPER_OVERRIDES = {}           # none: the configuration as its file gives it
K5_WRAP_SHAPE = (1, 640, 8, 2)  # B, S, C, D: HW = 409,600, the index wraps int32
CKPT_EST = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
CKPT_POLICY = "checkpoints/ppo_rl_coadapt_model_165.ckpt"
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
# the flagship evaluation, as scripts/r5_cabinet_evals.sh runs it, one round
FLAGSHIP = ["dataset=cabinet_test", "task=open_cabinet", "manipulation=open_cabinet",
            "controller=rl", f"controller.load={CKPT_POLICY}",
            "pose_estimator=adapose_cabinet_fast",
            f"pose_estimator.checkpoint_path={CKPT_EST}",
            "controller.estimate_fusion=consensus", "controller.early_stop=4",
            "train=test", "train.total_round=8", "task.num_envs=8", "seed=11"]
EVAL_DRAW_SEED = 11            # the round's point-sampling draws, made on the CPU
# PPO training of the camera scheduler, resumed from the committed policy
PPO_ITERS = 2
PPO_TRAIN = ["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
             "controller=rl", f"controller.load={CKPT_POLICY}",
             "pose_estimator=adapose_cabinet_fast",
             f"pose_estimator.checkpoint_path={CKPT_EST}", "train=controller",
             f"train.iterations_per_epoch={PPO_ITERS}", "task.num_envs=8", "seed=11"]
# the estimator's production recipe (scripts/tunnel_watch_estimator.sh:66-70)
EST_REUSE = 8
EST_TRAIN = ["dataset=cabinet_train", "task=open_cabinet", "task.num_envs=8", "seed=7",
             "img_size=192", "backend=resnet18", "backbone_stride=32", "volume_scale=8",
             "n_depth=16", "d_interval=0.15", "warp_mode=nearest", f"reuse={EST_REUSE}"]
EST_TRAIN_F32 = EST_TRAIN + ["bf16=0"]     # phase 13 keeps its f32 gates
EST_STEPS = 5
EST_CPU_ENVS = 2               # envs of the card-vs-CPU training step
K_CAM = ((439.3, 0.0, 320.0), (0.0, 439.3, 240.0), (0.0, 0.0, 1.0))
# heuristic + AdaPose (the README's pot and mug rows, scripts/r5_chain.sh), one round
HEURISTIC = {
    "open_pot": ["dataset=pot_test", "task=open_pot", "manipulation=open_pot",
                 "pose_estimator=adapose_pot_fast"],
    "pick_mug": ["dataset=mug_test", "task=pick_mug", "manipulation=pick_mug",
                 "pose_estimator=adapose_mug_fast"],
}
HEURISTIC_RUN = ["controller=heuristic_pose", "train=test", "train.total_round=8",
                 "task.num_envs=8", "seed=11"]
# train=collect of view pairs for the estimator's inference harness, one round
COLLECT = ["dataset=cabinet_test", "task=open_cabinet", "controller=collect_pose",
           "pose_estimator=ground_truth", "train=collect", "train.total_round=8",
           "task.num_envs=8", "seed=11"]
# phase 15: the bf16 paths and the estimator's other generations
BF16_PAPER_CPU = 2             # envs of the paper-size bf16 card-vs-CPU comparison
BF16_STEPS = 3
BF16_SLICE_K = 20              # a 2-env slice's bf16 loss part limit, in CPU bf16-to-f32 gaps
BF16_SHIFT = 1                 # pixels off of the crops of the gate's control step
CKPT_MUG = "checkpoints/estimator_fast_mug_fine_r5.ckpt"
# evaluate on the mug at the arguments of scripts/r5_chain.sh:22-26, 2 rounds
EVAL_MUG = ["task=pick_mug", "dataset=mug_test", "task.num_envs=8", f"checkpoint={CKPT_MUG}",
            "rounds=2", "img_size=192", "backend=resnet18", "backbone_stride=32",
            "volume_scale=8", "n_depth=16", "d_min=0.35", "d_interval=0.08",
            "warp_mode=nearest"]
GEN_B = 4
GENERATIONS = [("v1", {}), ("v3", {}), ("v5", {}), ("baseline", {}), ("realworld", {}),
               ("v5", {"volume_channels": 8}), ("v5", {"fuse_views": True})]
BASELINE_RUN = ["dataset=cabinet_test", "task=open_cabinet", "manipulation=open_cabinet",
                "controller=heuristic_pose", "pose_estimator=adapose_baseline", "train=test",
                "train.total_round=8", "task.num_envs=8", "seed=11"]
# phase 16: RLManipulation (PPO on the joint-space actions) on open_cabinet;
# its learn and policy blocks are controller/rl.yaml's, passed as overrides
MANIP_RL = ["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
            "task.num_envs=8", "seed=11"]
MANIP_RL_T = 16
# phase 17: the four URDF fixture datasets (tests/fixtures/mobility_*)
FIXTURES = {"cabinet": ("open_cabinet", "open_cabinet"), "drawer": ("open_drawer", "open_drawer"),
            "pot": ("open_pot", "open_pot"), "mug": ("pick_mug", "pick_mug")}
FIXTURE_GT = ["controller=gt_pose", "pose_estimator=ground_truth", "train=test",
              "train.total_round=8", "task.num_envs=8", "seed=0"]
# phase 18: the real-world env with fake drivers, 480x640 frames
REALWORLD_K = ((600.0, 0.0, 320.0), (0.0, 600.0, 240.0), (0.0, 0.0, 1.0))
# phase 19: the flagship evaluation's groups with the paper-size estimator of
# the same task (the generator does not write adapose_cabinet_fast); the
# committed files the generator does not write, and those edited by hand
GEN_FLAGSHIP = ["dataset=cabinet_test", "task=open_cabinet", "manipulation=open_cabinet",
                "controller=rl", "pose_estimator=adapose_cabinet", "train=test"]
GEN_NOT_WRITTEN = {"dataset/mug_urdf_fixture.yaml", "pose_estimator/adapose_cabinet_fast.yaml",
                   "pose_estimator/adapose_drawer_fast.yaml",
                   "pose_estimator/adapose_mug_fast.yaml", "pose_estimator/adapose_pot_fast.yaml"}
GEN_HAND_EDITED = {"manipulation/close_cabinet.yaml", "manipulation/close_drawer.yaml",
                   "controller/rl.yaml"}
DRYRUN_RTOL = 1e-4             # phase 20: the sharded steps on the card against the CPU
# phase 21: the evaluation sweep (scripts/eval_sweep.py's rows) and the diagnostics;
# one heuristic + AdaPose row per estimator family, with its committed estimator
SWEEP_ROUNDS = 8               # one round of the sweep's 8 envs per row
SWEEP_FAMILIES = {
    "cabinet": (("open_cabinet", "open_cabinet", [("test", "cabinet_test")]),
                [f"pose_estimator.checkpoint_path={CKPT_EST}"]),
    "drawer": (("open_drawer", "open_drawer", [("test", "drawer_test")]), []),
    "pot": (("open_pot", "open_pot", [("test", "pot_test")]), []),
    "mug": (("pick_mug", "pick_mug", [("test", "mug_test")]), []),
}

# phase 22: the timing scripts at a short size, each in its own process. The
# bench runs on the flagship head, which has the bench's knobs
# (``estimator_fast_cabinet_r2.ckpt``'s architecture), so that the smoke reads
# no checkpoint beyond the other phases'
TIMING_SCRIPTS = {
    "bench": ["rgbmanip_tpu_torch.bench", "--batch", "8", "64", "--iters", "2", "--reps",
              "1", "--checkpoint", CKPT_EST],
    "bench_estimate": ["rgbmanip_tpu_torch.scripts.bench_estimate", "fast", "--batch", "16"],
    "bench_ppo_update": ["rgbmanip_tpu_torch.scripts.bench_ppo_update", "--iters", "2",
                         "--reps", "1"],
    "bench_ppo_iter": ["rgbmanip_tpu_torch.scripts.bench_ppo_iter", "8", "1"],
    "bench_sim_scaling": ["rgbmanip_tpu_torch.scripts.bench_sim_scaling", "--envs", "1",
                          "8", "--threads", "--cycles", "1"],
}
BENCH_B_CPU = 8                # the bench estimate held card against CPU, f32
TIE_PX = 1e-4                  # a ray this close to the source's border is a tie
PROJ_TOL = 1e-3                # px between two devices' projections of one ray


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_times(torch, fn, n=20, attempts=10):
    """Device time per call, by kernel name: torch.profiler over ``n`` calls
    after one warm-up call. A profile now and then holds no device events at
    all, several in a row; the calls are then profiled again, up
    to ``attempts`` times, and the retries are said."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / n / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
        if out:
            if attempt:
                say("profile", f"{attempt} empty profile(s) before this one")
            return out
    raise SmokeError(f"torch.profiler recorded no device time in {attempts} profiles")


def cold_device_times(torch, fn, flush, n=20):
    """``device_times`` of ``fn`` with ``flush`` (a write that evicts the L2)
    before each call; the flush's own kernels are left out."""
    own = set(device_times(torch, flush, n=2))
    both = device_times(torch, lambda: (flush(), fn()), n=n)
    return {k: v for k, v in both.items() if k not in own}


def host_ms(torch, fn, reps=7):
    """Median host-clock time of a call that ends in a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def k2_recorded(calls):
    """Within: each call the network makes to ``stereo.fused_volume`` (the
    entry of K2) appended to ``calls`` as its arguments."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    orig = stereo.fused_volume

    def rec(*args):
        calls.append(args)
        return orig(*args)
    stereo.fused_volume = rec
    try:
        yield
    finally:
        stereo.fused_volume = orig


def k2_on_path(torch, calls, card, label):
    """K2 on the calls a path made (``k2_recorded``): each replayed against
    its plain version (``stereo.fused_volume_plain``: the eager warp and the
    fusing add) in the U-Net's channels-last-3d layout, the same strides and
    the same bits in the (B, D, H, W, C) rows, then K2's device time per
    launch beside its bound (the fused volume written once and both feature
    maps read once, ``portbench/counts/k2.py``, over the card's memory
    bandwidth) and the plain version's. Returns (ms, plain ms, bound ms,
    shape (B, C, D, H, W), dtype)."""
    from portbench.counts import k2
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    from rgbmanip_tpu_torch.scripts.perfutil import HBM_BYTES_PER_S

    check(len(calls) == 2, f"{label}: {len(calls)} calls to fused_volume; an estimate "
          f"makes one a direction")
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    with torch.inference_mode():
        for args in calls:
            got = stereo.fused_volume(*args)
            want = stereo.fused_volume_plain(*args)
            check(got.is_contiguous(memory_format=torch.channels_last_3d)
                  and got.stride() == want.stride(),
                  f"{label}: K2's volume {tuple(got.shape)} has strides {got.stride()}, its "
                  f"plain twin's {want.stride()}: both are channels-last")
            rows, plain = got.permute(0, 2, 3, 4, 1), want.permute(0, 2, 3, 4, 1)
            check(got.shape == want.shape and got.dtype == want.dtype
                  and torch.equal(rows.view(bits[got.dtype]), plain.view(bits[want.dtype])),
                  f"{label}: K2 differs from the eager warp at {tuple(got.shape)} {got.dtype}")
            del got, want, rows, plain
        torch.cuda.synchronize()
        kern = device_times(torch, lambda: [stereo.fused_volume(*a) for a in calls], n=5)
        k2_ms = {n: v for n, v in kern.items() if "plane_sweep_fuse" in n}
        check(len(k2_ms) == 1, f"the profiler did not see K2's kernel: {sorted(kern)}")
        ms = sum(k2_ms.values()) / len(calls)
        plain = sum(device_times(torch, lambda: [stereo.fused_volume_plain(*a) for a in calls],
                                 n=3).values()) / len(calls)
    B, H, W, C = calls[0][0].shape
    D = calls[0][4].shape[1]
    dtype = calls[0][0].dtype
    bound = k2.launch_bytes(B, C, D, H, W, calls[0][0].element_size()) / HBM_BYTES_PER_S * 1e3
    say("time", f"{card} | K2 on {label}'s own calls, (B, C, D, H, W) = {(B, C, D, H, W)} "
        f"{dtype}: equal to the eager warp bit for bit in the channels-last layout, both "
        f"directions; device time per "
        f"launch {ms:.4f} ms ({bound / ms * 100:.1f}% of the {bound:.4f} ms bytes bound), "
        f"plain {plain:.4f} ms")
    return ms, plain, bound, (B, C, D, H, W), dtype


def unet_layouts(torch, dev, card):
    """K2's yardstick: the 3-D U-Net (``CostRegNet``, 32 channels in, base
    8, seeded weights, eval) in bf16 at the parity cell's volume (B, C, D, H,
    W) = (16, 32, 24, 224, 224), device time per forward on the volume as K2
    writes it (channels-last-3d, the card's layout: ``stereo.unet_input``)
    and on a contiguous NCDHW copy of it (the layout K2 wrote before), where
    cuDNN converts layouts and takes its direct dgrad for the transposed
    convolutions. Returns {"unet_ndhwc": ms, "unet_ncdhw": ms}."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    net = stereo.CostRegNet(32, base=8, dtype=torch.bfloat16)
    net = stereo.flax_init_(net, torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randn(16, 24, 224, 224, 32, generator=g, device=dev).to(torch.bfloat16)
    vol = stereo.unet_input(rows.permute(0, 4, 1, 2, 3))
    check(vol.data_ptr() == rows.data_ptr(), "unet_input copied K2's bf16 volume on the card")
    ncdhw = vol.contiguous()
    out = {}
    with torch.inference_mode():
        for name, x in (("unet_ndhwc", vol), ("unet_ncdhw", ncdhw)):
            out[name] = sum(device_times(torch, lambda: net(x), n=3).values())
    say("time", f"{card} | the bf16 U-Net at (16, 32, 24, 224, 224): {out['unet_ndhwc']:.3f} ms "
        f"a forward channels-last (K2's layout), {out['unet_ncdhw']:.3f} ms NCDHW")
    del rows, vol, ncdhw
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------- the evaluation --
def eval_round(np, torch, T, cfg, device, draws, drive=None):
    """One round of the flagship evaluation through ``rgbmanip_tpu_torch.train``'s
    functions on ``device``. Every estimate takes its point-sampling draws
    from ``draws``: made on the CPU from one seed on the first run, replayed
    on the second. Records each step's action, reward, view and estimate, the
    fused estimate, and the estimator's arguments. With ``drive`` (the first
    run's record) each step moves the camera by the first run's action and
    the skill acts on its fused estimate, while the record keeps this run's
    own: the two actors' f32 actions differ in the last bits, and a camera
    target moved by that much changes pixels at the edges of the rendered
    parts (tests/test_torch_rl_loop.py)."""
    from rgbmanip_tpu_torch.utils.logger import get_logger
    log = get_logger()
    rec = {"actions": [], "frames": [], "masks": [], "pred_bbox": [], "calls": [],
           "devices": set()}
    gen = torch.Generator().manual_seed(EVAL_DRAW_SEED)
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        est = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, est, manip, cfg["controller"], cfg, log,
                                    device=device)
        rec["param_devices"] = {p.device.type for p in est.model.parameters()} | \
            {p.device.type for p in ctrl.controller.model.parameters()}
        estimate, call = est._estimate, est._call_estimate

        def drawn(K, rgb1, mask1, ext1, rgb2, mask2, ext2, rand1, rand2):
            i = len(rec["calls"]) - 1
            if i == len(draws):
                B, n = rgb1.shape[0], est.img_size ** 2
                draws.append((torch.rand(B, n, generator=gen), torch.rand(B, n, generator=gen)))
            rec["devices"] |= {t.device.type for t in (K, rgb1, mask1, ext1, rgb2)}
            u1, u2 = draws[i]
            return estimate(K, rgb1, mask1, ext1, rgb2, mask2, ext2, u1.to(rgb1.device),
                            u2.to(rgb1.device))

        def kept(*args):
            rec["calls"].append(args)      # numpy arrays made anew for each call
            return call(*args)

        est._estimate, est._call_estimate = drawn, kept
        iface = ctrl.control_interface
        step, act = iface.step, iface.call_manipulation

        def rec_step(action, eval=False):
            rec["actions"].append(np.array(action, np.float64))
            if drive is not None:
                action = drive["actions"][len(rec["actions"]) - 1]
            out = step(action, eval=eval)
            t = (iface.accumulate_steps - 1) % iface.max_steps
            rec["frames"].append(iface.image_queue[t].copy())
            rec["masks"].append(iface.mask_queue[t].copy())
            rec["pred_bbox"].append(iface.pred_bbox[t].copy())
            return out

        def rec_act(estimation, eval=False):
            rec["fused"] = np.array(estimation)
            rec["stereo_ok"] = iface.stereo_ok().copy()
            rec["views_so_far"] = np.cumsum(iface.available, axis=0)
            rec["first_view"] = (iface.image_queue[0].copy(), iface.mask_queue[0].copy())
            return act(drive["fused"] if drive is not None else estimation, eval)

        iface.step, iface.call_manipulation = rec_step, rec_act
        t0 = time.perf_counter()
        rec["result"] = T.test(env, ctrl, cfg, log)
        if device.type == "cuda":
            torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        rec["phases"] = env.timer.summary()
        obs = env.get_observation()
        rec["success"] = np.array(obs["success"])
        rec["move"] = np.array(obs["total_move_distance"])
    finally:
        env.close()
    return rec


def k1_in_estimate_spans(path):
    """K1 kernels in a torch.profiler chrome trace whose launch lies inside
    an ``estimate`` range (the PhaseTimer's), and all K1 kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "estimate"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "crop_resize_normalize" in e.get("name", "")]
    inside = [e for e in k1 if any(a <= launch_ts.get(e["args"].get("correlation"), -1) <= b
                                   for a, b in spans)]
    return len(inside), len(k1), len(spans)


def round_gaps(np, card_rec, cpu_rec, N):
    """Card against CPU of two lock-stepped rounds (``eval_round``): the
    largest action gap, the (steps, N) per-step bbox gaps, which estimates
    came from one view duplicated, and the fused bbox gap."""
    adiff = max(float(np.abs(a - b).max())
                for a, b in zip(cpu_rec["actions"], card_rec["actions"]))
    dup = card_rec["views_so_far"][1:len(card_rec["pred_bbox"]) + 1] == 1
    bdiff = np.stack([np.abs(a - b).reshape(N, -1).max(-1) for a, b in
                      zip(cpu_rec["pred_bbox"], card_rec["pred_bbox"])])
    fdiff = float(np.abs(cpu_rec["fused"] - card_rec["fused"]).max())
    return adiff, bdiff, dup, fdiff


def flagship_eval(np, torch, dev, card):
    """The flagship evaluation on the card and on the CPU, and once more
    through ``train.main`` under the profiler. Returns K1's launches in the
    card round and the largest |kernel - plain| over the round's windows."""
    import tempfile

    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    cfg = load_config(FLAGSHIP + ["device=cuda"])
    N = int(cfg["task"]["num_envs"])
    draws = []
    k1.crop_resize_normalize.launches = 0
    k5.row_gather.launches = 0
    card_rec = eval_round(np, torch, T, cfg, dev, draws)
    launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                "row_gather": k5.row_gather.launches}
    n_est = len(card_rec["calls"])
    check(n_est >= 1 and launches["crop_resize_normalize"] == 2 * n_est,
          f"K1 launched {launches['crop_resize_normalize']} times in {n_est} estimates "
          f"of the round; the path launches it twice per estimate")
    check(card_rec["param_devices"] == {"cuda"} and card_rec["devices"] == {"cuda"},
          f"the estimator or the policy is not on the card: parameters on "
          f"{card_rec['param_devices']}, estimate inputs on {card_rec['devices']}")
    res = card_rec["result"]
    secs = card_rec["seconds"]
    say("eval", f"{card} | flagship evaluation on the card ({N} envs, seed 11, k=4, "
        f"consensus): success {res['success_rate']:.2f}% (not gated: {res['rounds']} "
        f"episodes), move distance {res['move_distance']:.3f} m; {secs:.2f} s for the "
        f"round, {secs / res['rounds']:.3f} s/episode incl. the estimator's first "
        f"call on this instance")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(card_rec["phases"].items()))
    say("eval", f"{card} | PhaseTimer split of the round (host clock; skill includes its "
        f"own sim moves): {split}")
    say("eval", f"{n_est} estimate calls of B={N} in the round ({n_est / N:.2f} per "
        f"episode; each call estimates every env), K1 launches {launches} "
        f"({launches['crop_resize_normalize'] / N:.2f} per episode, 2 per call)")

    # the host-to-device copy of one of the round's estimates
    args = card_rec["calls"][-1]
    types = (torch.float32, torch.float32, torch.bool, torch.float32, torch.float32,
             torch.bool, torch.float32)
    mb = sum(np.asarray(a).size * torch.empty((), dtype=t).element_size()
             for a, t in zip(args, types)) / 1e6

    def h2d():
        for a, t in zip(args, types):
            torch.as_tensor(a, dtype=t, device=dev)
    copy_ms = host_ms(torch, h2d, reps=7)
    say("eval", f"{card} | host-to-device copy per estimate (the inputs of the round's "
        f"last estimate, pageable numpy -> card, as _call_estimate makes it): {mb:.2f} MB "
        f"in {copy_ms:.2f} ms ({mb / copy_ms:.2f} GB/s), median of 7")

    # K1 against its plain version on every window the round fed it
    err = 0.0
    n_win = 0
    for a in card_rec["calls"]:
        for rgb, mask in ((a[1], a[2]), (a[4], a[5])):
            rgb_t = torch.as_tensor(rgb, device=dev)
            win = k1_windows(torch, torch.as_tensor(mask, device=dev), 192)
            out = k1.crop_resize_normalize(rgb_t, *win, 192)
            ref = k1.crop_resize_normalize_plain(rgb_t, *win, 192)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), "K1 differs from its plain version on a "
                  "window of the evaluation round")
            err = max(err, (out - ref).abs().max().item())
            n_win += rgb.shape[0]
    say("eval", f"K1 equals its plain version bit for bit on all {n_win} windows the "
        f"round fed it (S=192, rendered frames)")

    # the same round on the CPU, same draws, lock-stepped to the card's moves
    t0 = time.perf_counter()
    cpu_rec = eval_round(np, torch, T, load_config(FLAGSHIP + ["device=cpu"]),
                         torch.device("cpu"), draws, drive=card_rec)
    check(len(cpu_rec["actions"]) == len(card_rec["actions"]), "the CPU round took "
          "another number of steps")
    for i in range(2):
        check(np.array_equal(cpu_rec["first_view"][i], card_rec["first_view"][i]),
              "the first views differ between the card and the CPU rounds")
    for t, (a, b) in enumerate(zip(cpu_rec["frames"], card_rec["frames"])):
        check(np.array_equal(a, b) and np.array_equal(cpu_rec["masks"][t],
                                                       card_rec["masks"][t]),
              f"step {t + 1}: the rendered frames differ between the card and the CPU")
    adiff, bdiff, dup, fdiff = round_gaps(np, card_rec, cpu_rec, N)
    say("eval", f"card vs CPU, same draws and moves ({time.perf_counter() - t0:.1f} s for "
        f"the CPU round): frames and masks equal bit for bit at all "
        f"{len(card_rec['frames'])} steps; max |action diff| {adiff:.3g} (limit 1e-5); "
        f"max |pred_bbox diff| {bdiff[~dup].max(initial=0.0):.3g} m on the "
        f"{int((~dup).sum())} two-view estimates (limit 1e-3), "
        f"{bdiff[dup].max(initial=0.0):.3g} m on the {int(dup.sum())} estimates from one "
        f"view duplicated (not gated: the warp's in-frame test flips on the volume's "
        f"border for identical cameras); fused {fdiff:.3g} m (limit 1e-3); stereo_ok, "
        f"success and move distance equal: "
        f"{np.array_equal(cpu_rec['stereo_ok'], card_rec['stereo_ok'])}, "
        f"{np.array_equal(cpu_rec['success'], card_rec['success'])}, "
        f"{np.array_equal(cpu_rec['move'], card_rec['move'])}")
    check(adiff <= 1e-5, "card and CPU actions differ")
    check(bdiff[~dup].max(initial=0.0) <= 1e-3 and fdiff <= 1e-3,
          "card and CPU estimates differ")
    check(np.array_equal(cpu_rec["stereo_ok"], card_rec["stereo_ok"])
          and np.array_equal(cpu_rec["success"], card_rec["success"])
          and np.array_equal(cpu_rec["move"], card_rec["move"]),
          "card and CPU rounds end differently")

    # the user's command, through train.main, under the profiler
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        over = FLAGSHIP + ["device=cuda", f"train.save_dir={tmp}", f"train.log_dir={tmp}"]
        for attempt in range(2):
            os.environ["RGBMANIP_PROFILE"] = os.path.join(tmp, f"profile{attempt}")
            try:
                t0 = time.perf_counter()
                result = T.main(over)
                main_s = time.perf_counter() - t0
            finally:
                del os.environ["RGBMANIP_PROFILE"]
            inside, n_k1, n_spans = k1_in_estimate_spans(
                os.path.join(tmp, f"profile{attempt}", "trace.json"))
            if n_k1:
                break
        saved = []
        for r, _, fs in os.walk(tmp):
            if "result.json" in fs:
                with open(os.path.join(r, "result.json")) as f:
                    saved.append(json.load(f))
        check(result in saved, "train.main wrote no result.json of its result")
    say("eval", f"python -m rgbmanip_tpu_torch.train {' '.join(FLAGSHIP)} device=cuda "
        f"(train.main, RGBMANIP_PROFILE set): success {result['success_rate']:.2f}%, move "
        f"{result['move_distance']:.3f} m over {result['rounds']} episodes (the "
        f"estimator's own generator), result.json written; {main_s:.1f} s incl. set-up "
        f"and the profiler; the trace holds {n_k1} K1 kernels, {inside} launched inside "
        f"the {n_spans} 'estimate' ranges")
    check(inside >= 1, "the profiler recorded no K1 launch inside the loop's estimates")
    return launches, err


# ------------------------------------------ heuristic + AdaPose, inference --
def heuristic_round(np, torch, T, cfg, device, draws, drive=None):
    """One round of heuristic + AdaPose through ``rgbmanip_tpu_torch.train``'s
    functions on ``device``: the camera at the two fixed viewpoints, one
    estimate of the whole batch, the skill. The estimate takes its
    point-sampling draws from ``draws`` (made on the CPU from one seed on the
    first run, replayed on the second); with ``drive`` (the first run's
    record) the skill acts on the first run's bbox, since the closed-loop
    skill turns micrometres into centimetres of arm motion."""
    from rgbmanip_tpu_torch.utils.logger import get_logger
    log = get_logger()
    rec = {"calls": [], "bbox": [], "devices": set()}
    gen = torch.Generator().manual_seed(EVAL_DRAW_SEED)
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        est = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, est, manip, cfg["controller"], cfg, log,
                                    device=device)
        rec["param_devices"] = {p.device.type for p in est.model.parameters()}
        estimate, inner = est.estimate, est._estimate

        def drawn(*args):
            i = len(rec["calls"])
            if i == len(draws):
                n = est.img_size ** 2
                draws.append([torch.rand(args[1].shape[0], n, generator=gen)
                              for _ in range(2)])
            rec["devices"] |= {a.device.type for a in args[:7]}
            return inner(*args[:7], *(u.to(args[1].device) for u in draws[i]))

        def recorded(*args):
            bbox = np.asarray(estimate(*args))
            rec["calls"].append(args)      # numpy arrays made anew for each call
            rec["bbox"].append(bbox)
            return drive["bbox"][len(rec["bbox"]) - 1] if drive is not None else bbox

        est._estimate, est.estimate = drawn, recorded
        t0 = time.perf_counter()
        rec["result"] = T.test(env, ctrl, cfg, log)
        if device.type == "cuda":
            torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        rec["phases"] = env.timer.summary()
        obs = env.get_observation()
        rec["success"] = np.array(obs["success"])
        rec["move"] = np.array(obs["total_move_distance"])
    finally:
        env.close()
    return rec


def heuristic_eval(np, torch, dev, card):
    """Phase 14: heuristic + AdaPose, one round of 8 on ``pot_test`` and on
    ``mug_test`` on the card, with every launch counter set to 0 just before
    each round and read just after; K1 against its plain version on the
    round's windows; the same round on the CPU, lock-step. Returns K1's
    launches in the card rounds and the largest |kernel - plain|."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    total, err = 0, 0.0
    for task, stack in HEURISTIC.items():
        cfg = load_config(stack + HEURISTIC_RUN + ["device=cuda"])
        S = int(cfg["pose_estimator"]["img_size"])
        N = int(cfg["task"]["num_envs"])
        draws = []
        k1.crop_resize_normalize.launches = 0
        k5.row_gather.launches = 0
        card_rec = heuristic_round(np, torch, T, cfg, dev, draws)
        launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                    "row_gather": k5.row_gather.launches}
        n_est = len(card_rec["calls"])
        check(n_est == 1 and launches["crop_resize_normalize"] == 2 * n_est,
              f"{task}: K1 launched {launches['crop_resize_normalize']} times in "
              f"{n_est} estimates of the round; the path launches it twice per estimate")
        check(card_rec["param_devices"] == {"cuda"} and card_rec["devices"] == {"cuda"},
              f"{task}: the estimator is not on the card: parameters on "
              f"{card_rec['param_devices']}, estimate inputs on {card_rec['devices']}")
        total += launches["crop_resize_normalize"]
        res, secs = card_rec["result"], card_rec["seconds"]
        say("heuristic", f"{card} | {task} heuristic + AdaPose on the card "
            f"({cfg['pose_estimator']['checkpoint_path']}, {N} envs, seed 11): success "
            f"{res['success_rate']:.2f}% (not gated: {res['rounds']} episodes), move "
            f"distance {res['move_distance']:.3f} m; {secs:.2f} s for the round, "
            f"{secs / res['rounds']:.3f} s/episode incl. the estimator's first call on "
            f"this instance; launches {launches} (2 per round)")
        split = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(card_rec["phases"].items()))
        say("heuristic", f"{card} | {task} PhaseTimer split of the round (host clock; "
            f"skill includes its own sim moves): {split}")
        a = card_rec["calls"][0]
        for rgb, mask in ((a[1], a[2]), (a[4], a[5])):
            rgb_t = torch.as_tensor(rgb, device=dev)
            win = k1_windows(torch, torch.as_tensor(mask, device=dev), S)
            out = k1.crop_resize_normalize(rgb_t, *win, S)
            ref = k1.crop_resize_normalize_plain(rgb_t, *win, S)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"{task}: K1 differs from its plain version "
                  f"on a window of the round")
            err = max(err, (out - ref).abs().max().item())

        t0 = time.perf_counter()
        cpu_rec = heuristic_round(np, torch, T, load_config(stack + HEURISTIC_RUN +
                                                             ["device=cpu"]),
                                  torch.device("cpu"), draws, drive=card_rec)
        check(len(cpu_rec["calls"]) == n_est, f"{task}: the CPU round made another "
              f"number of estimates")
        for x, y in zip(cpu_rec["calls"][0], card_rec["calls"][0]):
            check(np.array_equal(x, y), f"{task}: the views or cameras differ between "
                  f"the card and the CPU rounds")
        bdiff = float(np.abs(cpu_rec["bbox"][0] - card_rec["bbox"][0]).max())
        n_valid = int((np.abs(card_rec["bbox"][0]).max(axis=(1, 2)) < 8.0).sum())
        same = (np.array_equal(cpu_rec["success"], card_rec["success"])
                and np.array_equal(cpu_rec["move"], card_rec["move"]))
        say("heuristic", f"{task} card vs CPU, same draws, the CPU's skill on the card's "
            f"bbox ({time.perf_counter() - t0:.1f} s for the CPU round): both views and "
            f"cameras equal bit for bit; max |bbox diff| {bdiff:.3g} m (limit 1e-3) over "
            f"{N} envs, {n_valid} valid; K1 equals its plain version bit for bit on the "
            f"round's {2 * N} windows; success and move distance equal: {same}")
        check(bdiff <= 1e-3, f"{task}: card and CPU estimates differ")
        check(n_valid > 0, f"{task}: no valid estimate: the comparison would be of "
              f"sentinel boxes")
        check(same, f"{task}: card and CPU rounds end differently")
    return total, err


def inference_batch(np, torch, dev, card):
    """Phase 14: ``train=collect`` writes 8 view pairs (``collect_pose``),
    then ``inference.main`` on the card estimates them at B=8 with every
    launch counter set to 0 just before it and read just after; the same
    batch on the card and on the CPU with the same draws; the estimate's
    wall time, device busy time and idle share at B=8. The estimator's
    default network warps bilinearly at full resolution, so K2 runs twice
    an estimate: on the card estimate's own calls it is held bit for bit
    against the eager warp, and timed. Returns K1's and K2's launches in
    ``inference.main`` and K2's row of the kernels line."""
    import tempfile

    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.models.pose_estimator import inference
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import plane_sweep as k2
    from rgbmanip_tpu_torch.ops import row_gather as k5

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        data = os.path.join(tmp, "pairs")
        t0 = time.perf_counter()
        T.main(COLLECT + ["device=cuda", f"controller.learn.save_dir={data}",
                          f"train.save_dir={tmp}", f"train.log_dir={tmp}"])
        files = inference.pair_files(data)
        check(len(files) == B_MAIN, f"train=collect wrote {len(files)} view pairs, "
              f"not {B_MAIN}")
        say("inference", f"train=collect (collect_pose, {B_MAIN} envs) wrote "
            f"{len(files)} view pairs in {time.perf_counter() - t0:.1f} s")
        k1.crop_resize_normalize.launches = 0
        k2.warp_fuse.launches = 0
        k5.row_gather.launches = 0
        t0 = time.perf_counter()
        result = inference.main(["--data_root", data])          # the card by default
        main_s = time.perf_counter() - t0
        launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                    "plane_sweep_fuse": k2.warp_fuse.launches,
                    "row_gather": k5.row_gather.launches}
        check(result["n"] == B_MAIN and launches["crop_resize_normalize"] == 2
              and launches["plane_sweep_fuse"] == 2,
              f"inference.main estimated {result['n']} pairs with {launches}; one batch "
              f"of {B_MAIN} launches K1 twice and K2 twice")
        say("inference", f"python -m rgbmanip_tpu_torch.models.pose_estimator.inference "
            f"--data_root <pairs> (the card by default; the estimator's default "
            f"architecture: resnet34 at stride 8, 224 px, volume scale 1, bilinear warp, "
            f"1024 points, weights made from seed 0): {result} in {main_s:.1f} s incl. "
            f"set-up; launches {launches} (2 per batch)")
        args = inference.stack_pairs([np.load(f) for f in files])

    cfg = inference.estimator_cfg()
    S = cfg["img_size"]
    g = torch.Generator().manual_seed(8)
    u = [torch.rand(B_MAIN, S * S, generator=g) for _ in range(2)]
    outs, k2_calls = {}, []
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        est = AdaPoseEstimator(cfg, device=d)
        t = [torch.from_numpy(a).to(d) for a in args]
        k2.warp_fuse.launches = 0
        with k2_recorded(k2_calls if name == "card" else []):
            bbox, valid, _ = est._estimate(*[x if x.dtype == torch.bool else x.float()
                                             for x in t], *(x.to(d) for x in u))
        outs[name] = (bbox.cpu().numpy(), valid.cpu().numpy())
        check(k2.warp_fuse.launches == (2 if name == "card" else 0),
              f"the {name} estimate launched K2 {k2.warp_fuse.launches} times")
        if name == "card":
            card_est = est
    bdiff = float(np.abs(outs["card"][0] - outs["cpu"][0]).max())
    vsame = bool((outs["card"][1] == outs["cpu"][1]).all())
    say("inference", f"B={B_MAIN} collected pairs, same draws and seeded weights, card vs "
        f"CPU: max |bbox diff| {bdiff:.3g} m (limit 1e-3), valid flags equal: {vsame} "
        f"({int(outs['cpu'][1].sum())}/{B_MAIN} valid)")
    check(bdiff <= 1e-3 and vsame, "card and CPU inference estimates disagree")
    check(outs["cpu"][1].any(), "no valid inference estimate: the comparison would be "
          "of sentinel boxes")

    def estimate():
        card_est.estimate(*args)       # numpy in and out, as inference.main calls it
    wall = host_ms(torch, estimate, reps=7)
    kernels = device_times(torch, estimate, n=5)
    busy = sum(kernels.values())
    mb = sum(a.nbytes for a in args) / 1e6
    say("time", f"{card} | inference estimate B={B_MAIN} on collected pairs (numpy in, "
        f"{mb:.1f} MB copied per batch): {wall:.2f} ms wall, {B_MAIN / wall * 1e3:.0f} "
        f"pairs/s; device busy {busy:.2f} ms per estimate, idle "
        f"{(1 - busy / wall) * 100:.0f}% of the wall time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, v in top[:6]:
        say("time", f"    {v:.4f} ms ({v / busy * 100:.1f}%) {name[:90]}")
    k2_row = k2_on_path(torch, k2_calls, card, "inference")
    del k2_calls
    return launches["crop_resize_normalize"], launches["plane_sweep_fuse"], k2_row


# ---------------------------------------------------------------- training --
def _capture(owner, name, keep):
    """Wrap ``owner.name`` so that each call first hands ``keep`` its
    arguments; returns the function that undoes it."""
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        keep(*args, **kwargs)
        return orig(*args, **kwargs)
    setattr(owner, name, wrapped)
    return lambda: setattr(owner, name, orig)


def ppo_training(np, torch, dev, card):
    """Phase 12: PPO training of the camera scheduler through ``train.main``
    (``train=controller``), two iterations of 16 transitions at 8 envs,
    resumed from the committed policy, with K1's counter set to 0 just
    before and read just after; then the last update on the card against
    the same update on the CPU, and the saved checkpoint read back. Returns
    K1's launches."""
    import tempfile

    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.algo.ppo import PPO
    from rgbmanip_tpu_torch.ops import crop_resize as k1

    runs, updates = [], []

    def keep_update(self, batch):
        updates.append((self.state_tree(), {k: v.detach().cpu().clone()
                                            for k, v in batch.items()}))
    undo = [_capture(PPO, "run", lambda self, *a, **k: runs.append(self)),
            _capture(PPO, "_update", keep_update)]
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        over = PPO_TRAIN + ["device=cuda", f"controller.learn.save_dir={tmp}",
                            f"train.save_dir={tmp}", f"train.log_dir={tmp}"]
        k1.crop_resize_normalize.launches = 0
        try:
            t0 = time.perf_counter()
            T.main(over)
            main_s = time.perf_counter() - t0
        finally:
            for u in undo:
                u()
        launches = k1.crop_resize_normalize.launches
        check(len(runs) == 1 and len(updates) == PPO_ITERS,
              f"train.main ran {len(runs)} trainers and {len(updates)} updates")
        ppo = runs[0]
        steps = PPO_ITERS * ppo.num_transitions
        check(ppo.device.type == "cuda" and
              {p.device.type for p in ppo.model.parameters()} == {"cuda"},
              "the policy did not train on the card")
        check(launches == 2 * steps, f"K1 launched {launches} times in {steps} rollout "
              f"steps; each step's estimate launches it twice")
        per_it = ", ".join(f"it {h['it']}: collect {h['collect_s']:.3f} s, learn "
                           f"{h['learn_s']:.3f} s" for h in ppo.history)
        split = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(ppo.timer.summary().items()))
        say("ppo", f"{card} | python -m rgbmanip_tpu_torch.train {' '.join(PPO_TRAIN)} "
            f"device=cuda: {PPO_ITERS} iterations of {ppo.num_transitions} transitions x "
            f"{ppo.num_envs} envs in {main_s:.1f} s incl. set-up; {per_it}; K1 launches "
            f"{launches} ({launches / steps:.0f} per rollout step)")
        say("ppo", f"{card} | PhaseTimer split of the {PPO_ITERS} iterations (host clock): "
            f"{split}; metrics of the last update (loss, surrogate, value loss, entropy, "
            f"kl): {np.array2string(ppo.history[-1]['metrics'], precision=4)}, lr "
            f"{ppo.lr:.3g}")

        # the last update again on the card and on the CPU
        tree, batch = updates[-1]
        pair = {}
        for d in (dev, torch.device("cpu")):
            p = PPO(ppo.env, ppo.cfg, seed=0, device=d)
            p.load_tree(tree)
            p._update({k: v.to(d) for k, v in batch.items()})
            pair[d.type] = p
        g, c = pair["cuda"].model.state_dict(), pair["cpu"].model.state_dict()
        diffs = {k: (g[k].cpu() - c[k]).abs().max().item() for k in c}
        actor = max(v for k, v in diffs.items() if not k.startswith("critic."))
        critic = max(v for k, v in diffs.items() if k.startswith("critic."))
        same_lrs = pair["cuda"].update_lrs == pair["cpu"].update_lrs
        say("ppo", f"the last update on the card vs the CPU, same batch and state "
            f"({len(pair['cpu'].update_lrs)} minibatch steps): learning rate after every "
            f"step equal: {same_lrs}; max |param diff| actor {actor:.3g} (limit 2e-5), "
            f"critic {critic:.3g} (limit 2e-4)")
        check(same_lrs and actor <= 2e-5 and critic <= 2e-4,
              "the PPO update differs between the card and the CPU")

        # the saved checkpoint read back into a fresh trainer
        it = ppo.current_learning_iteration
        path = os.path.join(tmp, f"model_{it}.ckpt")
        check(os.path.exists(path), f"train.main wrote no model_{it}.ckpt")
        back = PPO(ppo.env, ppo.cfg, seed=1, device=dev)
        back.load(path)
        mine, theirs = ppo.state_tree(), back.state_tree()
        from rgbmanip_tpu_torch.utils.checkpoint import flatten
        fa, fb = flatten(mine), flatten(theirs)
        same = sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)
        say("ppo", f"model_{it}.ckpt read back into a fresh trainer: parameters, Adam "
            f"moments, step count and lr equal: {same}")
        check(same and back.current_learning_iteration == it,
              "the saved PPO checkpoint does not restore the trainer")
    return launches


def training_stages(torch, trainer, batch, step_ms):
    """Device time per training step of the warp (K2), the point samples
    (K3) and the pose gathers (K4), forward and backward: each replayed,
    forward alone and forward with its backward, on the arguments one
    training forward gave it, the features requiring a gradient as they do
    in the step. Returns {stage: (calls, forward ms, backward ms)}."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    stages = {
        "warp (K2)": (stereo, "homo_warp_batched", None),
        "point samples (K3)": (stereo, "point_sample", None),
        "pose gathers (K4)": (stereo, "flat_gather", lambda table, idx: idx.dim() == 2),
    }
    calls = {k: [] for k in stages}
    fns = {k: getattr(owner, attr) for k, (owner, attr, _) in stages.items()}
    undo = []
    for k, (owner, attr, keep) in stages.items():
        def rec(*args, k=k, keep=keep):
            if keep is None or keep(*args):
                calls[k].append(tuple(a.detach() if torch.is_tensor(a) else a
                                      for a in args))
        undo.append(_capture(owner, attr, rec))
    trainer.model.train()
    try:
        trainer.loss(batch)
    finally:
        trainer.model.eval()
        for u in undo:
            u()
    out = {}
    for k, fn in fns.items():
        check(calls[k], f"the training forward made no call to {k}")
        args = [(a[0].clone().requires_grad_(True),) + a[1:] for a in calls[k]]

        def forward():
            with torch.no_grad():
                for a in args:
                    fn(*a)

        def both():
            outs = [fn(*a) for a in args]
            torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
        fwd = sum(device_times(torch, forward, n=5).values())
        fb = sum(device_times(torch, both, n=5).values())
        out[k] = (len(args), fwd, max(fb - fwd, 0.0))
    return out


def estimator_training(np, torch, dev, card):
    """Phase 13: the estimator's trainer through ``train_estimator.main`` at
    the production recipe (8 envs, reuse 8, 192 px), resumed from the
    committed head, 5 steps, with K1's counters set to 0 just before and
    read just after (the sampler crops with K1's clamping mode, the JAX
    trainer's border rule, twice a batch, and never with the renormalising
    one); one step's device time, top kernels and K2-K4's share of it,
    backward included; one step on the card against the CPU from the same
    parameters and batch; the saved head loaded back. Returns the clamping
    mode's launches."""
    import tempfile

    from rgbmanip_tpu_torch.models.pose_estimator import train_estimator as TE
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu_torch.models.pose_estimator.converter import to_jax_params
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.utils.checkpoint import flatten

    kept = []
    undo = _capture(EstimatorTrainer, "step", lambda self, batch: kept.append((self, batch)))
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        head = os.path.join(tmp, "head.ckpt")
        argv = EST_TRAIN_F32 + [f"steps={EST_STEPS}", f"resume={CKPT_EST}", f"save={head}",
                                f"log_dir={os.path.join(tmp, 'logs')}", "log_every=1",
                                "device=cuda"]
        zero_k1_counters(k1)
        try:
            t0 = time.perf_counter()
            est = TE.main(argv)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
        finally:
            undo()
        launches = k1.crop_resize_normalize_clamp.launches
        st = est.train_stats
        prepared = st["counts"]["prepare"]
        check(st["steps"] == EST_STEPS and len(kept) == EST_STEPS, "train_estimator.main "
              f"took {st['steps']} steps")
        check({p.device.type for p in est.model.parameters()} == {"cuda"},
              "the estimator did not train on the card")
        check(launches == 2 * prepared and prepared >= EST_STEPS
              and k1.crop_resize_normalize.launches == 0,
              f"K1's clamping mode launched {launches} times for {prepared} prepared "
              f"batches, the renormalising mode {k1.crop_resize_normalize.launches} times; "
              f"each batch launches the clamping mode twice")
        ph, n = st["phases"], st["counts"]
        replayed = statistics.median(st["step_seconds"][1:])
        steady = 1.0 / (replayed + ph.get("render", 0.0) / EST_REUSE)
        say("est-train", f"{card} | python -m rgbmanip_tpu_torch.models.pose_estimator."
            f"train_estimator {' '.join(EST_TRAIN_F32)} steps={EST_STEPS} resume={CKPT_EST} "
            f"device=cuda: {st['steps']} steps in {st['seconds']:.2f} s "
            f"({st['steps'] / st['seconds']:.2f} steps/s incl. the first step's warm-up; "
            f"{main_s:.1f} s with set-up); render {ph.get('render', 0.0):.3f} s "
            f"({n.get('render', 0)} fresh view pairs), prepare {ph['prepare']:.3f} s "
            f"({prepared} batches, K1 and labels), train_step {ph['train_step']:.3f} s; "
            f"host-to-device {st['h2d_bytes'] / 1e6:.2f} MB in all, "
            f"{st['h2d_bytes'] / 1e6 / st['steps']:.2f} MB per step; K1 clamping-mode "
            f"launches {launches} ({launches / prepared:.0f} per batch)")
        B = 8
        fresh_mb = n.get("render", 0) * 2 * B * H * W * (3 * 2 + 1) / 1e6  # f16 colour, mask
        per_batch_mb = (st["h2d_bytes"] / 1e6 - fresh_mb) / prepared
        say("est-train", f"{card} | steady state: a replayed step (steps 2-{EST_STEPS}, "
            f"median) {replayed * 1e3:.1f} ms; with the fresh render "
            f"({ph.get('render', 0.0):.3f} s) spread over its {EST_REUSE} uses, "
            f"{steady:.2f} steps/s; host-to-device: {fresh_mb / max(n.get('render', 1), 1):.2f} "
            f"MB per fresh view pair (its f16 colour and masks stay on the card for the "
            f"replays), {per_batch_mb:.3f} MB of labels and projections per batch, "
            f"{fresh_mb / max(n.get('render', 1), 1) / EST_REUSE + per_batch_mb:.2f} MB "
            f"per step at reuse {EST_REUSE}")

        # the saved head loaded back gives the trained estimator's estimate
        cfg = dict(est.cfg, load=True, checkpoint_path=head)
        back = AdaPoseEstimator(cfg, device=dev)
        args = [torch.from_numpy(a).to(dev) for a in pair(np, np.random.default_rng(4), 8)]
        g = torch.Generator().manual_seed(6)
        S = est.img_size
        u = [torch.rand(8, S * S, generator=g).to(dev) for _ in range(2)]
        b1, v1, _ = est._estimate(*args, *u)
        b0, _, _ = est._estimate(*args, *u)
        b2, v2, _ = back._estimate(*args, *u)
        diff = (b1 - b2).abs().max().item()
        again = (b1 - b0).abs().max().item()
        say("est-train", f"the saved head loaded back by AdaPoseEstimator: max |bbox diff| "
            f"{diff:.3g} m from the trained estimator's on 8 view pairs (limit 1e-5; the "
            f"trained estimator against itself, call to call: {again:.3g} m), valid flags "
            f"equal: {torch.equal(v1, v2)} ({int(v1.sum())} valid)")
        check(diff <= 1e-5 and torch.equal(v1, v2),
              "the saved estimator head does not give the trained estimate")

        # one step's device time, its top kernels and K2-K4's share
        trainer, batch = kept[-1]
        wall = host_ms(torch, lambda: trainer.step(batch), reps=5)
        kernels = device_times(torch, lambda: trainer.step(batch), n=3)
        busy = sum(kernels.values())
        say("est-train", f"{card} | one training step at B={batch['img1'].shape[0]}, "
            f"{batch['img1'].shape[1]} px (f32, TF32 off): {wall:.2f} ms wall, device busy "
            f"{busy:.2f} ms, idle {(1 - busy / wall) * 100:.0f}% of the wall time; "
            f"{1e3 / wall:.2f} train steps/s without the sampler")
        for name, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
            say("est-train", f"    {v:.4f} ms ({v / busy * 100:.1f}%) {name[:90]}")
        stages = training_stages(torch, trainer, batch, busy)
        bwd = sum(b for _, _, b in stages.values())
        for k, (calls, f, b) in stages.items():
            say("est-train", f"{card} | {k}: {calls} calls per step, forward {f:.4f} ms, "
                f"backward {b:.4f} ms ({b / busy * 100:.2f}% of the step's busy time)")
        say("est-train", f"K2-K4 backward together: {bwd:.4f} ms, {bwd / busy * 100:.2f}% of "
            f"a training step's device time")

        # one step on the card against the CPU, same parameters and batch
        sub = {k: v[:EST_CPU_ENVS] for k, v in batch.items()}
        out = {}
        for d in (dev, torch.device("cpu")):
            e = AdaPoseEstimator(cfg, device=d)
            total, parts = EstimatorTrainer(e.model, lr=1e-4).step(
                {k: v.to(d) for k, v in sub.items()})
            out[d.type] = (parts, [flatten(t) for t in to_jax_params(e.model)])
        part_rel = max(abs(out["cuda"][0][k] - out["cpu"][0][k]) / abs(out["cpu"][0][k])
                       for k in out["cpu"][0])
        (gp, gs), (cp, cs) = out["cuda"][1], out["cpu"][1]
        stats = max(float(np.abs(gs[k] - cs[k]).max() / (np.abs(cs[k]).max() + 1e-6))
                    for k in cs)
        params = max(float(np.abs(gp[k] - cp[k]).max()) for k in cp)
        say("est-train", f"one step on the card vs the CPU from the saved head on the last "
            f"batch's first {EST_CPU_ENVS} envs: loss parts {part_rel:.3g} relative (limit "
            f"1e-4), BatchNorm running statistics {stats:.3g} of their largest (limit "
            f"1e-4), parameters {params:.3g} (limit 2.1e-4: Adam's first step moves each "
            f"by +-1e-4, so an element whose gradient is near 0 may part by two steps)")
        check(part_rel <= 1e-4 and stats <= 1e-4 and params <= 2.1e-4,
              "the estimator's training step differs between the card and the CPU")

    return launches


# ------------------------------------------------ phase 15: bf16, generations --
def bf16_estimates(np, torch, dev, card):
    """Phase 15a: the bf16 estimate (``evaluate``'s default compute dtype):
    the flagship configuration with its checkpoint at B=8 and the paper
    size on seeded weights at B=16, each through ``estimate_full`` with
    every launch counter set to 0 just before and read just after (K1
    twice, both its bf16 entry point); K1-bf16 bit for bit against
    ``plain(...).to(bf16)`` on the estimate's windows; the card against the
    CPU, both bf16 (the first ``n_cpu`` envs), within twice the CPU's own
    bf16-to-f32 gap and 1e-3 m, with equal valid flags; the bf16-to-f32
    distance on the card, at least half the CPU's on the same envs; the
    wall, busy and idle times and top kernels of both dtypes. Returns K1's bf16 launches, the largest |kernel -
    plain| and one timing input (the flagship batch's view-1 frames and
    windows)."""
    from rgbmanip_tpu_torch.config.loader import load_group
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    bf16 = torch.bfloat16
    total = 0
    err = 0.0
    timing_input = None
    for name, cfg, B, n_cpu in (
            ("flagship", load_group("pose_estimator", "adapose_cabinet_fast",
                                    {"checkpoint_path": CKPT_EST}), B_MAIN, B_MAIN),
            ("paper", load_group("pose_estimator", "adapose_cabinet", PAPER_OVERRIDES),
             B_PAPER[1], BF16_PAPER_CPU)):
        S = int(cfg["img_size"])
        host = pair(np, np.random.default_rng(60 + B), B)
        inputs = tuple(torch.from_numpy(a).to(dev) for a in host)
        est16 = AdaPoseEstimator(cfg, device=dev, seed=0, dtype=bf16)
        est32 = AdaPoseEstimator(cfg, device=dev, seed=0)
        k1.crop_resize_normalize.launches = 0
        k1.crop_resize_normalize.launches_bf16 = 0
        k5.row_gather.launches = 0
        full = est16.estimate_full(*inputs)
        launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                    "crop_resize_normalize_bf16": k1.crop_resize_normalize.launches_bf16,
                    "row_gather": k5.row_gather.launches}
        check(launches == {"crop_resize_normalize": 2, "crop_resize_normalize_bf16": 2,
                           "row_gather": 0},
              f"{name} bf16 estimate: launches {launches}; it launches K1 twice, both "
              f"times its bf16 entry point, and nothing else")
        check(np.isfinite(full["bbox"]).all(), f"{name} bf16 estimate: non-finite bbox")
        total += launches["crop_resize_normalize_bf16"]
        n_win = 0
        for rgb, mask in ((inputs[1], inputs[2]), (inputs[4], inputs[5])):
            win = k1_windows(torch, mask, S)
            out = k1.crop_resize_normalize(rgb, *win, S, out_dtype=bf16)
            ref = k1.crop_resize_normalize_plain(rgb, *win, S).to(bf16)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"{name}: K1's bf16 entry point differs from "
                  f"plain(...).to(bf16) on the estimate's windows")
            err = max(err, (out.float() - ref.float()).abs().max().item())
            n_win += rgb.shape[0]
        if timing_input is None:
            timing_input = (inputs[1], k1_windows(torch, inputs[2], S), S)

        g = torch.Generator().manual_seed(70 + B)
        u = [torch.rand(B, S * S, generator=g) for _ in range(2)]
        b16, v16, _ = est16._estimate(*inputs, *(x.to(dev) for x in u))
        b32, v32, _ = est32._estimate(*inputs, *(x.to(dev) for x in u))
        both = (v16 & v32).cpu().numpy()
        own = float(np.abs(b16.cpu().numpy() - b32.cpu().numpy())[both].max(initial=0.0))
        cpu = {}
        for dt in (bf16, torch.float32):
            e = AdaPoseEstimator(cfg, device="cpu", seed=0, dtype=dt)
            bb, vv, _ = e._estimate(*(torch.from_numpy(a[:n_cpu]) for a in host),
                                    *(x[:n_cpu] for x in u))
            cpu[dt] = (bb.numpy(), vv.numpy())
        ok = cpu[bf16][1]
        gaps = np.abs(cpu[bf16][0] - cpu[torch.float32][0])[ok]
        gap = float(gaps.max(initial=0.0))
        d = float(np.abs(b16[:n_cpu].cpu().numpy() - cpu[bf16][0])[ok].max(initial=0.0))
        vsame = bool((v16[:n_cpu].cpu().numpy() == ok).all())
        bound = max(2 * gap, 1e-3)
        # bf16's rounding shows on the card as on the CPU, on the same envs:
        # a card that ran f32 would sit 0 from its own f32 estimate
        own_mean = float(np.abs((b16 - b32)[:n_cpu].cpu().numpy())[ok].mean())
        say("bf16", f"{name} ({S} px, B={B}) bf16: launches {launches}; K1-bf16 equals "
            f"plain(...).to(bf16) bit for bit on all {n_win} windows; card vs CPU (both "
            f"bf16, first {n_cpu} envs, same draws): max |bbox diff| {d:.3g} m (limit "
            f"{bound:.3g}: twice the CPU's own bf16-to-f32 gap {gap:.3g} m, at least "
            f"1e-3), valid flags equal: {vsame} ({int(ok.sum())}/{n_cpu} valid); on the "
            f"card bf16 vs f32: max |bbox diff| {own:.3g} m over {int(both.sum())}/{B} "
            f"envs valid in both, valid {int(v16.sum())} / {int(v32.sum())}; mean over "
            f"the compared envs {own_mean:.3g} m against the CPU's {gaps.mean():.3g} m "
            f"(at least half of it)")
        check(vsame and d <= bound, f"{name}: card and CPU bf16 estimates disagree")
        check(own_mean >= 0.5 * gaps.mean(), f"{name}: the card's bf16 estimate sits too "
              f"close to its own f32 estimate: it did not compute in bf16")
        check(ok.any(), f"{name}: no valid bf16 estimate on the CPU: the comparison "
              f"would be of sentinel boxes")

        for label, est in (("bf16", est16), ("f32", est32)):
            def estimate(est=est):
                est.estimate_full(*inputs)
            wall = host_ms(torch, estimate, reps=5)
            kernels = device_times(torch, estimate, n=3)
            busy = sum(kernels.values())
            say("time", f"{card} | {name} estimate B={B} {label} (inputs on the card): "
                f"{wall:.2f} ms wall, {B / wall * 1e3:.0f} view pairs/s; device busy "
                f"{busy:.2f} ms, idle {(1 - busy / wall) * 100:.0f}% of the wall time")
            for kname, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
                say("time", f"    {v:.4f} ms ({v / busy * 100:.1f}%) {kname[:90]}")
    return total, err, timing_input


def bf16_evaluate(np, torch, card):
    """Phase 15b: ``evaluate.main`` at its defaults (bf16, the card) with the
    mug arguments of ``scripts/r5_chain.sh:22-26``, 2 rounds of 8, with
    every launch counter set to 0 just before and read just after (K1's bf16
    entry point twice per round). Accuracy printed, not gated. Returns
    K1's bf16 launches."""
    from rgbmanip_tpu_torch.models.pose_estimator import evaluate as EV
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    k1.crop_resize_normalize.launches = 0
    k1.crop_resize_normalize.launches_bf16 = 0
    k5.row_gather.launches = 0
    t0 = time.perf_counter()
    stats = EV.main(EVAL_MUG)
    secs = time.perf_counter() - t0
    launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                "crop_resize_normalize_bf16": k1.crop_resize_normalize.launches_bf16,
                "row_gather": k5.row_gather.launches}
    check(launches == {"crop_resize_normalize": 4, "crop_resize_normalize_bf16": 4,
                       "row_gather": 0},
          f"evaluate.main: launches {launches}; 2 rounds launch K1 4 times, all its bf16 "
          f"entry point, and nothing else")
    say("bf16", f"{card} | python -m rgbmanip_tpu_torch.models.pose_estimator.evaluate "
        f"{' '.join(EVAL_MUG)} (bf16 and the card by default): "
        + " ".join(f"{k}={v:.4f}" for k, v in stats.items())
        + f" (not gated: 16 estimates) in {secs:.1f} s incl. set-up; launches {launches}")
    return launches["crop_resize_normalize_bf16"]


def one_step(torch, cfg, device, dtype, batch):
    """One ``EstimatorTrainer`` step of a fresh estimator from ``cfg``'s
    head: (loss parts, its (params, batch_stats) trees flattened, the step's
    gradient flattened in parameter order on the host)."""
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu_torch.models.pose_estimator.converter import to_jax_params
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer
    from rgbmanip_tpu_torch.utils.checkpoint import flatten

    e = AdaPoseEstimator(cfg, device=device, dtype=dtype)
    _, parts = EstimatorTrainer(e.model, lr=1e-4).step(
        {k: v.to(device) for k, v in batch.items()})
    grad = torch.cat([p.grad.reshape(-1).cpu() for p in e.model.parameters()
                      if p.grad is not None])
    return parts, [flatten(t) for t in to_jax_params(e.model)], grad


def bf16_training(np, torch, dev, card):
    """Phase 15c: ``train_estimator.main`` at its default (bf16) at the
    production recipe, resumed from the committed head, 3 steps, with K1's
    counters set to 0 just before and read just after (the sampler crops in
    f32: the f32 entry point of K1's clamping mode twice per batch);
    steps/s and one step's busy and idle time; one step on the card against
    the CPU from the saved head on the last batch and on each 2-env slice
    of it, with f32 steps beside them to show bf16's rounding on the card,
    and a control step on crops one pixel off that the limits must reject.
    Returns the clamping mode's f32 launches."""
    import tempfile

    from rgbmanip_tpu_torch.models.pose_estimator import train_estimator as TE
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer
    from rgbmanip_tpu_torch.ops import crop_resize as k1

    kept = []
    undo = _capture(EstimatorTrainer, "step", lambda self, batch: kept.append((self, batch)))
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        head = os.path.join(tmp, "head.ckpt")
        argv = EST_TRAIN + [f"steps={BF16_STEPS}", f"resume={CKPT_EST}", f"save={head}",
                            f"log_dir={os.path.join(tmp, 'logs')}", "log_every=1"]
        zero_k1_counters(k1)
        try:
            est = TE.main(argv)                       # bf16 and the card by default
            torch.cuda.synchronize()
        finally:
            undo()
        launches = k1.crop_resize_normalize_clamp.launches
        st = est.train_stats
        prepared = st["counts"]["prepare"]
        check(est.dtype == torch.bfloat16 and est.device.type == "cuda"
              and {p.dtype for p in est.model.parameters()} == {torch.float32},
              f"train_estimator.main trained in {est.dtype} on {est.device}, not bf16 "
              f"compute with f32 parameters on the card")
        check(launches == 2 * prepared and k1.crop_resize_normalize_clamp.launches_bf16 == 0
              and k1.crop_resize_normalize.launches == 0,
              f"K1's clamping mode launched {launches} times "
              f"({k1.crop_resize_normalize_clamp.launches_bf16} of them bf16), the "
              f"renormalising mode {k1.crop_resize_normalize.launches} times, for {prepared} "
              f"prepared batches; the sampler crops in f32 with the clamping mode, twice a "
              f"batch")
        trainer, batch = kept[-1]
        wall = host_ms(torch, lambda: trainer.step(batch), reps=5)
        kernels = device_times(torch, lambda: trainer.step(batch), n=3)
        busy = sum(kernels.values())
        replayed = statistics.median(st["step_seconds"][1:])
        say("bf16", f"{card} | python -m rgbmanip_tpu_torch.models.pose_estimator."
            f"train_estimator {' '.join(EST_TRAIN)} steps={BF16_STEPS} resume={CKPT_EST} "
            f"(bf16 and the card by default): {st['steps']} steps in {st['seconds']:.2f} s "
            f"({st['steps'] / st['seconds']:.2f} steps/s incl. the first step's warm-up; a "
            f"replayed step {replayed * 1e3:.1f} ms); one training step at B="
            f"{batch['img1'].shape[0]}: {wall:.2f} ms wall, device busy {busy:.2f} ms, idle "
            f"{(1 - busy / wall) * 100:.0f}%, {1e3 / wall:.2f} train steps/s without the "
            f"sampler; K1 clamping-mode launches {launches} (f32, the sampler's crops)")
        for name, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            say("bf16", f"    {v:.4f} ms ({v / busy * 100:.1f}%) {name[:90]}")

        # One bf16 step from the saved head on the whole last batch and on
        # each EST_CPU_ENVS-env slice of it, on the card and on the CPU, with
        # the CPU's f32 step beside each (and the card's beside each slice's)
        # to show bf16's rounding. Each loss part is held against a multiple
        # of the CPU's own bf16-to-f32 difference on the same envs: twice it
        # on the whole batch, BF16_SLICE_K times it on a slice, where
        # BatchNorm over two envs spreads the parts further. Both multiples
        # come from rgbmanip_tpu_torch/scripts/bf16_step_spread.py's readings
        # over six seeds (PERF.md, section 6), and a step on crops
        # BF16_SHIFT pixel off must fail both.
        cfg = dict(est.cfg, load=True, checkpoint_path=head)
        cpu = torch.device("cpu")

        def parts_gap(sub, k, card_runs):
            """(the card's runs by name, the CPU's bf16 and f32 runs, the
            CPU's own bf16-to-f32 difference and the limit by loss part, and
            for the card's bf16 and shifted runs the largest loss part's
            difference from the CPU's bf16 over its limit)."""
            off = dict(sub, **{n: torch.roll(sub[n], BF16_SHIFT, dims=2)
                               for n in ("img1", "img2")})
            runs = {name: one_step(torch, cfg, dev, dt, off if name == "shifted" else sub)
                    for name, dt in card_runs}
            c16, c32 = (one_step(torch, cfg, cpu, dt, sub)
                        for dt in (torch.bfloat16, torch.float32))
            c = {n: abs(c16[0][n] - c32[0][n]) / abs(c32[0][n]) for n in c16[0]}
            limit = {n: max(k * c[n], 1e-2) for n in c}
            worst = {name: max(abs(runs[name][0][n] - c16[0][n]) / abs(c16[0][n]) / limit[n]
                               for n in c) for name in ("card", "shifted")}
            return runs, c16, c32, c, limit, worst

        runs, c16, _, c, limit, whole = parts_gap(
            batch, 2, (("card", torch.bfloat16), ("shifted", torch.bfloat16)))
        g16 = runs["card"][0]
        say("bf16", f"  all {batch['img1'].shape[0]} envs: loss parts card bf16 vs CPU bf16, "
            f"relative (limit twice the CPU's own bf16-to-f32 difference, at least 1e-2): "
            + ", ".join(f"{n} {abs(g16[n] - c16[0][n]) / abs(c16[0][n]):.3g} ({limit[n]:.3g})"
                        for n in sorted(c)))
        worst, shifted, own, gap = 0.0, 0.0, 0.0, 0.0
        stats, params, cos = [], [], []     # np.max / np.min: a NaN fails the checks
        for lo in range(0, batch["img1"].shape[0], EST_CPU_ENVS):
            sub = {n: v[lo:lo + EST_CPU_ENVS] for n, v in batch.items()}
            runs, c16, c32, c, limit, w = parts_gap(
                sub, BF16_SLICE_K, (("card", torch.bfloat16), ("card f32", torch.float32),
                                    ("shifted", torch.bfloat16)))
            g16, g32 = runs["card"][0], runs["card f32"][0]
            say("bf16", f"  envs {lo}-{lo + EST_CPU_ENVS - 1}: loss parts card bf16 vs CPU "
                f"bf16, relative (limit {BF16_SLICE_K}x the CPU's own bf16-to-f32 "
                f"difference, at least 1e-2): "
                + ", ".join(f"{n} {abs(g16[n] - c16[0][n]) / abs(c16[0][n]):.3g} "
                            f"({limit[n]:.3g})" for n in sorted(c)))
            worst = float(np.max([worst, w["card"]]))
            shifted = float(np.max([shifted, w["shifted"]]))
            # bf16's rounding shows on the card as on the CPU: a card that
            # ran f32 would sit 0 from its own f32 step
            own += sum(abs(g16[n] - g32[n]) / abs(g32[n]) for n in c)
            gap += sum(c.values())
            (gp, gs), (cp, cs) = runs["card"][1], c16[1]
            stats += [float(np.abs(gs[n] - cs[n]).max() / (np.abs(cs[n]).max() + 1e-6))
                      for n in cs]
            params += [float(np.abs(gp[n] - cp[n]).max()) for n in cp]
            ga, gb = runs["card"][2], c16[2]
            cos.append(float(ga @ gb / ga.norm() / gb.norm()))
        stats, params, cos = float(np.max(stats)), float(np.max(params)), float(np.min(cos))
        say("bf16", f"one bf16 step on the card vs the CPU from the saved head: the largest "
            f"loss part's difference over its limit {whole['card']:.3g} on the whole batch, "
            f"{worst:.3g} on the {EST_CPU_ENVS}-env slices (at most 1 each); on crops "
            f"{BF16_SHIFT} px off {whole['shifted']:.3g} and {shifted:.3g} (more than 1 each); "
            f"the loss parts' bf16-to-f32 difference summed over the slices, card {own:.3g} "
            f"against the CPU's {gap:.3g} (at least half of it); gradient cosine card vs CPU, "
            f"least {cos:.5f} (at least 0.9); BatchNorm running statistics {stats:.3g} of "
            f"their largest (limit 1e-2), parameters {params:.3g} (limit 2.1e-4, two "
            f"learning rates and rounding), the largest over the slices")
        check(whole["card"] <= 1 and worst <= 1 and stats <= 1e-2 and params <= 2.1e-4,
              "the bf16 training step differs between the card and the CPU")
        check(whole["shifted"] > 1 and shifted > 1,
              f"the card-vs-CPU limits on the bf16 loss parts pass a step on crops "
              f"{BF16_SHIFT} px off: they would not see a fault of that size")
        check(own >= 0.5 * gap, "the card's bf16 training step sits too close to its own "
              "f32 step: it did not compute in bf16")
        check(cos >= 0.9, "the bf16 gradients on the card and the CPU point apart")
    return launches


def generations(np, torch, dev, card):
    """Phase 15d: every generation of ``make_estimator`` (v1, v3, v5,
    baseline, realworld) and v5 with ``volume_channels=8`` and with
    ``fuse_views``, at B=4 on seeded weights and the flagship knobs, each
    through ``estimate_full`` with the counters set to 0 just before and
    read just after (K1 twice), then card against CPU with the same draws
    and RANSAC hypotheses (1e-3 m, equal valid flags); and one round of
    heuristic + AdaPose with ``pose_estimator=adapose_baseline`` on
    ``cabinet_test`` (success printed: its released weights are not in the
    repo). Returns K1's f32 launches."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config, load_group
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5
    from rgbmanip_tpu_torch.ops.geometry import ransac_hypotheses

    total = 0
    B = GEN_B
    host = pair(np, np.random.default_rng(80), B)
    for version, over in GENERATIONS:
        knobs = {k: v for k, v in over.items() if k != "fuse_views"}
        cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                         {"load": False, "checkpoint_path": "", **knobs})
        S, N = int(cfg["img_size"]), int(cfg["n_pts"])
        label = version + "".join(f" {k}={v}" for k, v in over.items())

        def build(d):
            # fuse_views is the network's knob, not the estimator's
            e = make_estimator(version, cfg, device=d, seed=0)
            e.model.fuse_views = over.get("fuse_views", False)
            return e
        est = build(dev)
        inputs = tuple(torch.from_numpy(a).to(dev) for a in host)
        k1.crop_resize_normalize.launches = 0
        k1.crop_resize_normalize.launches_bf16 = 0
        k5.row_gather.launches = 0
        t0 = time.perf_counter()
        full = est.estimate_full(*inputs)
        first_s = time.perf_counter() - t0
        launches = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16,
                    k5.row_gather.launches)
        check(launches == (2, 0, 0), f"{label}: launches (K1 f32, K1 bf16, K5) {launches}; "
              f"an estimate launches K1 twice")
        check(np.isfinite(full["bbox"]).all(), f"{label}: non-finite bbox")
        total += launches[0]
        g = torch.Generator().manual_seed(90)
        u = [torch.rand(B, S * S, generator=g) for _ in range(2)]
        idx = ransac_hypotheses(g, B, N)
        out = {}
        for d, e in ((dev, est), (torch.device("cpu"), build(torch.device("cpu")))):
            bb, vv, _ = e._estimate(*(torch.from_numpy(a).to(d) for a in host),
                                    *(x.to(d) for x in u), idx.to(d))
            out[d.type] = (bb.cpu().numpy(), vv.cpu().numpy())
        bdiff = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
        vsame = bool((out["cuda"][1] == out["cpu"][1]).all())
        wall = host_ms(torch, lambda: est.estimate_full(*inputs), reps=3)
        say("gen", f"{label} ({S} px, B={B}, seeded weights): launches (K1 f32, K1 bf16, "
            f"K5) {launches}; card vs CPU: max |bbox diff| {bdiff:.3g} m (limit 1e-3), "
            f"valid flags equal: {vsame} ({int(out['cpu'][1].sum())}/{B} valid); estimate "
            f"{wall:.2f} ms wall on the card ({first_s:.2f} s for the first call)")
        check(bdiff <= 1e-3 and vsame, f"{label}: card and CPU estimates disagree")

    cfg = load_config(BASELINE_RUN + ["device=cuda"])
    N = int(cfg["task"]["num_envs"])
    k1.crop_resize_normalize.launches = 0
    k1.crop_resize_normalize.launches_bf16 = 0
    k5.row_gather.launches = 0
    rec = heuristic_round(np, torch, T, cfg, dev, [])
    launches = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16,
                k5.row_gather.launches)
    n_est = len(rec["calls"])
    check(n_est >= 1 and launches == (2 * n_est, 0, 0),
          f"adapose_baseline round: launches {launches} in {n_est} estimates")
    check(rec["param_devices"] == {"cuda"} and rec["devices"] == {"cuda"},
          "the baseline estimator is not on the card")
    total += launches[0]
    res = rec["result"]
    say("gen", f"{card} | python -m rgbmanip_tpu_torch.train {' '.join(BASELINE_RUN)} "
        f"device=cuda, one round: success {res['success_rate']:.2f}% over {res['rounds']} "
        f"episodes (not gated: seeded weights, the released .pth is not in the repo), "
        f"{rec['seconds']:.2f} s; launches (K1 f32, K1 bf16, K5) {launches}")
    return total


# ------------------------------------ phases 16-18: RL skill, URDF, real world --
def manip_rl_overrides(save_dir):
    """``manipulation=rl`` with the learn and policy blocks of
    ``controller/rl.yaml`` as overrides (neither package's config tree has
    a manipulation group carrying them)."""
    from rgbmanip_tpu_torch.config.loader import load_group
    rl = load_group("controller", "rl")
    learn = dict(rl["learn"], num_transitions_per_env=MANIP_RL_T, save_dir=save_dir)
    return ["manipulation.name=rl", f"manipulation.learn={json.dumps(learn)}",
            f"manipulation.policy={json.dumps(rl['policy'])}"]


def rl_manipulation(np, torch, dev, card):
    """Phase 16: ``RLManipulation`` through ``train.main`` (``train=controller
    train.train_controller=false train.train_manipulation=true``), one
    iteration of 16 transitions at 8 envs on ``open_cabinet`` with a fresh
    policy on the card; the same iteration on the CPU from the card's
    initial weights and by its actions (the rollout equal, the update's
    losses within 1e-3 relative, the learning rate equal, parameters within
    the bounds of phase 12); then ``play`` on the card, through the skill's
    ``plan_pathway`` in a ``train=test`` round of the gt stack. No kernel
    of the port runs on this path (a 41-input MLP): the launch counters,
    set to 0 before, stay 0."""
    import tempfile

    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.algo.ppo import PPO
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.utils.logger import get_logger

    runs, plays = [], []

    def keep_run(self, *a, **k):
        runs.append((self, {n: v.detach().cpu().clone()
                            for n, v in self.model.state_dict().items()}))
    undo = [_capture(PPO, "run", keep_run),
            _capture(PPO, "play", lambda self, *a, **k: plays.append(self))]
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        over = MANIP_RL + manip_rl_overrides(os.path.join(tmp, "ckpt")) + [
            f"train.save_dir={tmp}", f"train.log_dir={tmp}"]
        train_over = over + ["train=controller", "train.train_controller=false",
                             "train.train_manipulation=true", "train.iterations_per_epoch=1"]
        zero_k1_counters(k1)
        try:
            t0 = time.perf_counter()
            check(T.main(train_over + ["device=cuda"]) is None, "train.main returned a result")
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            played = T.main(over + ["train=test", "controller=gt_pose", "train.total_round=8",
                                    "device=cuda"])
            play_s = time.perf_counter() - t0
        finally:
            for u in undo:
                u()
        launches = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize_clamp.launches)
        check(len(runs) == 1, f"train.main ran {len(runs)} PPO trainers")
        ppo, start = runs[0]
        check(ppo.device.type == "cuda" and {p.device.type for p in ppo.model.parameters()}
              == {"cuda"}, "the skill's policy did not train on the card")
        check(ppo.obs_dim == 41 and ppo.act_dim == 8, f"the skill's spaces are obs "
              f"{ppo.obs_dim}, action {ppo.act_dim}; open_cabinet gives 41 and 8")
        check(os.path.exists(os.path.join(tmp, "ckpt", "model_1.ckpt")),
              "train.main wrote no model_1.ckpt of the skill")
        check(len(plays) >= 1 and all(p.device.type == "cuda" for p in plays)
              and played["rounds"] == 8, "the skill's play did not run on the card")
        check(launches == (0, 0), f"K1 launched {launches} times on a path without an "
              f"estimator")
        h = ppo.history[-1]
        say("manip-rl", f"{card} | python -m rgbmanip_tpu_torch.train {' '.join(MANIP_RL)} "
            f"manipulation.name=rl (learn and policy of controller/rl.yaml) train=controller "
            f"train.train_controller=false train.train_manipulation=true "
            f"train.iterations_per_epoch=1 device=cuda: obs {ppo.obs_dim}, action "
            f"{ppo.act_dim}, {ppo.num_transitions} transitions x {ppo.num_envs} envs in "
            f"{main_s:.1f} s incl. set-up; collect {h['collect_s']:.3f} s, learn "
            f"{h['learn_s']:.3f} s; metrics (loss, surrogate, value loss, entropy, kl) "
            f"{np.array2string(h['metrics'], precision=4)}, lr {ppo.lr:.3g}; then "
            f"train=test (gt stack, the skill's greedy play): {len(plays)} plays of "
            f"{ppo.num_transitions} steps, success {played['success_rate']:.2f}% over "
            f"{played['rounds']} episodes (not gated: one iteration of a fresh policy), "
            f"{play_s:.1f} s; K1 launches {launches}")

        # the same iteration on the CPU, lock-stepped to the card's actions
        cfg = load_config(train_over + ["device=cpu", f"manipulation.learn.save_dir="
                                        f"{os.path.join(tmp, 'cpu')}"])
        env = T.prepare_env(cfg["task"], cfg["dataset"], log=get_logger(), seed=cfg["seed"])
        try:
            manip = T.prepare_manipulation(env, cfg["manipulation"], get_logger(),
                                           device=torch.device("cpu"))
            cpu = manip.algo
            cpu.model.load_state_dict(start)
            actions = iter(ppo.storage.actions.copy())
            cpu.action_source = lambda: next(actions)
            t0 = time.perf_counter()
            manip.learn(1)
            cpu_s = time.perf_counter() - t0
        finally:
            env.close()
        gs, cs = ppo.storage, cpu.storage
        same = all(np.array_equal(getattr(gs, k), getattr(cs, k))
                   for k in ("obs", "states", "actions", "rewards", "dones"))
        mu = float(np.abs(gs.mu - cs.mu).max())
        val = float(max(np.abs(gs.values - cs.values).max(),
                        np.abs(gs.logprobs - cs.logprobs).max()))
        gm, cm = ppo.history[-1]["metrics"], cpu.history[-1]["metrics"]
        rel = float((np.abs(gm - cm) / np.maximum(np.abs(cm), 1e-6)).max())
        g = {n: p.detach().cpu() for n, p in ppo.model.named_parameters()}
        c = dict(cpu.model.named_parameters())
        actor = max((g[n] - c[n].detach()).abs().max().item() for n in c
                    if not n.startswith("critic."))
        critic = max((g[n] - c[n].detach()).abs().max().item() for n in c
                     if n.startswith("critic."))
        say("manip-rl", f"card vs CPU, the CPU from the card's initial weights and by its "
            f"actions ({cpu_s:.1f} s on the CPU): observations, states, rewards and dones "
            f"equal: {same}; max |mu diff| {mu:.3g} (limit 1e-5), values and log-probabilities "
            f"{val:.3g} (limit 1e-4); the update's losses {rel:.3g} relative (limit 1e-3); "
            f"lr equal: {ppo.lr == cpu.lr}; max |param diff| actor {actor:.3g} (limit 2e-5), "
            f"critic {critic:.3g} (limit 2e-4)")
        check(same and mu <= 1e-5 and val <= 1e-4, "the skill's rollouts differ between "
              "the card and the CPU")
        check(rel <= 1e-3 and ppo.lr == cpu.lr and actor <= 2e-5 and critic <= 2e-4,
              "the skill's update differs between the card and the CPU")


def urdf_fixtures(np, torch, dev, card):
    """Phase 17: the gt stack, one round of 8, on each of the four URDF
    fixture datasets through ``train.main`` on the card and on the CPU
    (equal success and move distance); then one round of the flagship
    evaluation on ``cabinet_urdf_fixture`` (``controller=rl``,
    ``adapose_cabinet_fast``, the committed checkpoints, 8 envs) on the
    card with the counters set to 0 just before and read just after (K1
    twice per estimate), lock-stepped on the CPU as phase 11 runs it.
    Returns K1's launches in the flagship round."""
    import tempfile

    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        rows = []
        for kind, (task, manip) in FIXTURES.items():
            over = [f"dataset={kind}_urdf_fixture", f"task={task}", f"manipulation={manip}",
                    f"train.save_dir={tmp}", f"train.log_dir={tmp}"] + FIXTURE_GT
            t0 = time.perf_counter()
            res = {d: T.main(over + [f"device={d}"]) for d in ("cuda", "cpu")}
            rows.append(f"{kind} {res['cuda']['success_rate']:.2f}% "
                        f"({time.perf_counter() - t0:.1f} s both)")
            check(res["cuda"] == res["cpu"] and res["cuda"]["rounds"] == 8,
                  f"{kind}_urdf_fixture: the gt stack ends differently on the card "
                  f"({res['cuda']}) and on the CPU ({res['cpu']})")
    say("urdf", f"gt stack, one round of 8 on each URDF fixture dataset through train.main, "
        f"card and CPU equal (success and move distance): " + ", ".join(rows))

    fixture = [a if not a.startswith("dataset=") else "dataset=cabinet_urdf_fixture"
               for a in FLAGSHIP]
    cfg = load_config(fixture + ["device=cuda"])
    N = int(cfg["task"]["num_envs"])
    draws = []
    zero_k1_counters(k1)
    k5.row_gather.launches = 0
    card_rec = eval_round(np, torch, T, cfg, dev, draws)
    launches = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize_clamp.launches,
                k5.row_gather.launches)
    n_est = len(card_rec["calls"])
    check(n_est >= 1 and launches == (2 * n_est, 0, 0),
          f"launches (K1, K1 clamp, K5) {launches} in {n_est} estimates of the fixture round")
    check(card_rec["param_devices"] == {"cuda"} and card_rec["devices"] == {"cuda"},
          "the estimator or the policy is not on the card")
    cpu_rec = eval_round(np, torch, T, load_config(fixture + ["device=cpu"]),
                         torch.device("cpu"), draws, drive=card_rec)
    check(len(cpu_rec["actions"]) == len(card_rec["actions"]) and all(
        np.array_equal(a, b) and np.array_equal(ma, mb) for a, b, ma, mb in zip(
            cpu_rec["frames"], card_rec["frames"], cpu_rec["masks"], card_rec["masks"])),
        "the fixture round's frames differ between the card and the CPU")
    adiff, bdiff, dup, fdiff = round_gaps(np, card_rec, cpu_rec, N)
    res = card_rec["result"]
    say("urdf", f"{card} | python -m rgbmanip_tpu_torch.train {' '.join(fixture)} device=cuda,"
        f" one round: success {res['success_rate']:.2f}% (not gated: {res['rounds']} "
        f"episodes), {card_rec['seconds']:.2f} s; launches (K1, K1 clamp, K5) {launches} "
        f"({n_est} estimates); card vs CPU lock-step: frames equal, max |action diff| "
        f"{adiff:.3g} (limit 1e-5), max |pred_bbox diff| {bdiff[~dup].max(initial=0.0):.3g} m "
        f"on the {int((~dup).sum())} two-view estimates (limit 1e-3), fused {fdiff:.3g} m "
        f"(limit 1e-3); success equal: {np.array_equal(cpu_rec['success'], card_rec['success'])}")
    check(adiff <= 1e-5 and bdiff[~dup].max(initial=0.0) <= 1e-3 and fdiff <= 1e-3,
          "the fixture round's estimates differ between the card and the CPU")
    check(np.array_equal(cpu_rec["success"], card_rec["success"]),
          "the fixture round ends differently on the card and on the CPU")
    return launches[0]


class FakeRobot:
    """A robot driver that goes where it is sent."""

    def __init__(self):
        self.pose = [0.4, 0.0, 0.5, 0.0, 1.0, 0.0, 0.0]
        self.gripper = 0.04

    def hand_pose(self):
        return self.pose

    def move_to(self, pose7, duration=0.0):
        self.pose = list(pose7)

    def set_gripper(self, width):
        self.gripper = width


class FakeCamera:
    """A camera driver that sees a textured 480x640 scene with a box whose
    place in the frame follows the hand (a seeded texture, shifted)."""

    def __init__(self, np, robot):
        self.np, self.robot = np, robot
        self.base = np.random.default_rng(18).uniform(0.1, 0.6, (H, W, 3)).astype(np.float32)

    def capture(self):
        np = self.np
        dx = int(round(float(self.robot.pose[1]) * 400))
        rgb = self.base.copy()
        rgb[190:290, 270 + dx:370 + dx] = (0.9, 0.3, 0.1)
        return rgb, np.full((H, W), 1.5, np.float32), np.asarray(REALWORLD_K)


class FakeSegmenter:
    def predict(self, rgb):
        return rgb[..., 0] > 0.85


def realworld_env(np, torch, dev, card):
    """Phase 18: the real-world env (``envs/realworld``) with fake robot,
    camera and segmenter drivers, and two estimates of the ``realworld``
    generation at ``adapose_cabinet_fast``'s widths on seeded weights on
    its 480x640 views (the second with an empty mask), each on the card
    and on the CPU with the same draws: the world bbox within 1e-3 m, equal
    valid flags, the empty mask's sentinel (every corner at 9 m or more).
    The counters are set to 0 just before the card's two estimates and read
    just after (K1 twice each). Returns K1's launches."""
    from rgbmanip_tpu_torch.config.loader import load_group
    from rgbmanip_tpu_torch.envs.realworld.base_realworld import BaseRealworldEnv
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.utils.transform import Pose

    robot = FakeRobot()
    env = BaseRealworldEnv(robot_driver=robot, camera_driver=FakeCamera(np, robot),
                           segmenter=FakeSegmenter())
    i1 = env.get_image()["camera0"]
    env.cam_move_to(Pose([0.45, 0.15, 0.55], [0.0, 1.0, 0.0, 0.0]).to_7d()[None])
    i2 = env.get_image()["camera0"]
    check(i1["Color"].shape == (1, H, W, 3) and i1["Mask"].any() and i2["Mask"].any()
          and not np.array_equal(i1["Mask"], i2["Mask"]), "the fake drivers gave no views")
    cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                     {"load": False, "checkpoint_path": ""})
    S = int(cfg["img_size"])
    ests = {d.type: make_estimator("realworld", cfg, device=d, seed=0)
            for d in (dev, torch.device("cpu"))}
    check(ests["cuda"].model.realworld_pts, "the realworld generation lacks its pose branch")
    g = torch.Generator().manual_seed(18)
    u = [torch.rand(1, S * S, generator=g) for _ in range(2)]
    empty = np.zeros_like(i1["Mask"])
    cases = {"views": i1["Mask"], "empty mask": empty}
    args = {k: (i1["Intrinsic"], i1["Color"], m, i1["Extrinsic"], i2["Color"], i2["Mask"],
                i2["Extrinsic"]) for k, m in cases.items()}
    out = {}
    zero_k1_counters(k1)
    for k, a in args.items():
        b, v, _ = ests["cuda"]._estimate(*(torch.from_numpy(np.asarray(x)).to(dev) for x in a),
                                         *(x.to(dev) for x in u))
        out[k] = (b.cpu().numpy(), v.cpu().numpy())
    torch.cuda.synchronize()
    launches = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize_clamp.launches)
    check(launches == (4, 0), f"launches (K1, K1 clamp) {launches} in 2 estimates")
    gaps = []
    for k, a in args.items():
        b, v, _ = ests["cpu"]._estimate(*(torch.from_numpy(np.asarray(x)) for x in a), *u)
        gaps.append(float(np.abs(out[k][0] - b.numpy()).max()))
        check(np.array_equal(out[k][1], v.numpy()) and gaps[-1] <= 1e-3,
              f"realworld estimate ({k}): card and CPU disagree, max |bbox diff| {gaps[-1]:.3g}")
    check(np.isfinite(out["views"][0]).all() and out["views"][1].all(),
          "no valid estimate on the env's views")
    check((out["empty mask"][0] >= 9.0).all(), "an empty mask did not give the sentinel")
    inputs = [torch.from_numpy(np.asarray(x)).to(dev) for x in args["views"]]
    wall = host_ms(torch, lambda: ests["cuda"].estimate_full(*inputs), reps=5)
    say("realworld", f"{card} | BaseRealworldEnv (fake robot, camera and segmenter), "
        f"make_estimator('realworld') at adapose_cabinet_fast's widths ({S} px) on seeded "
        f"weights, 480x640 views: launches (K1, K1 clamp) {launches} in 2 estimates; card vs "
        f"CPU max |bbox diff| {gaps[0]:.3g} m on the views, {gaps[1]:.3g} m with the empty "
        f"mask (limit 1e-3), valid flags equal, the empty mask's bbox the sentinel "
        f"(min corner coordinate {float(out['empty mask'][0].min()):.2f} m); estimate at B=1 "
        f"{wall:.2f} ms wall on the card")
    return launches[0]


# ------------------------------- phases 19-20: config generator, multi-device --
def yaml_tree(root):
    import yaml
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".yaml"):
                with open(os.path.join(d, n)) as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = yaml.safe_load(f)
    return out


def config_generator():
    """Phase 19: ``generate_cfg.main`` writes the generated tree into a
    temporary directory (``CFG`` pointed there); the flagship run's groups
    compose from it with ``load_config(..., cfg_root=...)`` as from the
    committed tree but for the hand-edited ``controller/rl``; the trees
    differ in exactly the listed files; a ``load_config`` without
    ``cfg_root`` afterwards reads the committed tree. Host only."""
    import tempfile

    from rgbmanip_tpu_torch.config import generate_cfg
    from rgbmanip_tpu_torch.config.loader import CFG_ROOT, load_config

    t0 = time.perf_counter()
    committed = load_config(GEN_FLAGSHIP)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        saved, generate_cfg.CFG = generate_cfg.CFG, tmp
        try:
            generate_cfg.main()
        finally:
            generate_cfg.CFG = saved
        gen, com = yaml_tree(tmp), yaml_tree(CFG_ROOT)
        composed = load_config(GEN_FLAGSHIP, cfg_root=tmp)
    check(len(gen) == 53, f"the generator wrote {len(gen)} files, not 52 groups + config.yaml")
    check(set(com) - set(gen) == GEN_NOT_WRITTEN and not set(gen) - set(com),
          f"generated vs committed files: missing {sorted(set(com) - set(gen))}, extra "
          f"{sorted(set(gen) - set(com))}")
    differ = {k for k in gen if gen[k] != com[k]}
    check(differ == GEN_HAND_EDITED, f"generated files that differ from the committed: "
          f"{sorted(differ)}")
    check(composed["device"] == "cuda" and "device" not in composed["controller"]["learn"],
          "the generated tree lacks the port's device key or keeps the JAX package's")
    parted = {k for k in committed if composed[k] != committed[k]}
    check(parted == {"controller"}, f"the flagship run composed from the generated tree "
          f"differs from the committed one in {sorted(parted)}")
    check(load_config(GEN_FLAGSHIP) == committed,
          "load_config without cfg_root no longer reads the committed tree")
    say("config", f"generate_cfg.main wrote {len(gen)} files into a temporary directory: "
        f"equal to the committed tree as dicts but for {sorted(differ)} (edited by hand) "
        f"and the {len(GEN_NOT_WRITTEN)} files it does not write; the flagship run's groups "
        f"({' '.join(GEN_FLAGSHIP)}) composed with cfg_root equal the committed composition "
        f"but for the controller, device: {composed['device']}; the next load_config "
        f"without cfg_root reads the committed tree; {time.perf_counter() - t0:.2f} s")


def entry_forward(np, torch, dev, card):
    """Phase 20a: ``graft_entry.entry()``'s bf16 forward (the flagship
    network at the JAX module's defaults, resnet34, B=2, 224 px, 1024
    points, 24 depths) on the card and on the CPU, with the f32 forward of
    the same weights on each; per output, the mean |card - CPU| of the bf16
    forwards within twice the CPU's own mean bf16-to-f32 difference (phase
    15's rule), and the card's own bf16-to-f32 difference at least half the
    CPU's (it computed in bf16). The network warps bilinearly at full
    resolution with no gradient, so K2 runs twice a forward: on the card
    forward's own calls it is held bit for bit against the eager warp, and
    timed. Returns the card's launches of K1 and K5, K2's, and K2's row of
    the kernels line."""
    from rgbmanip_tpu_torch import graft_entry
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import plane_sweep as k2
    from rgbmanip_tpu_torch.ops import row_gather as k5

    names = ("view1_nocs", "view1_depth", "view1_r")
    zero_k1_counters(k1)
    k2.warp_fuse.launches = 0
    k5.row_gather.launches = 0
    forward, args = graft_entry.entry()
    k2_calls = []
    with k2_recorded(k2_calls):
        card16 = [o.float().cpu() for o in forward(*args)]
    torch.cuda.synchronize()
    launches = (k1.crop_resize_normalize.launches + k1.crop_resize_normalize_clamp.launches,
                k5.row_gather.launches)
    k2_launches = k2.warp_fuse.launches
    check(k2_launches == 2, f"entry()'s bf16 forward launched K2 {k2_launches} times; "
          f"it launches it once a direction")
    outs = forward(*args)
    check([o.dtype for o in outs] == [torch.bfloat16, torch.float32, torch.bfloat16]
          and all(o.is_cuda for o in outs), "entry() did not run in bf16 on the card (the "
          "depth comes out of its f32 softmax)")
    B, _, N, _ = graft_entry.ENTRY_SHAPE
    check([tuple(o.shape) for o in card16] == [(B, N, 3), (B, N), (B, 3, 3)]
          and all(torch.isfinite(o).all() for o in card16), "entry(): bad outputs")
    wall = host_ms(torch, lambda: forward(*args), reps=5)

    def f32(device, a):
        net = graft_entry.flagship_net(torch.float32, device)
        with torch.no_grad():
            out = net(*a)
        return [out[n].float().cpu() for n in names]
    card32 = f32(dev, args)
    cpu_forward, cpu_args = graft_entry.entry(device="cpu")
    t0 = time.perf_counter()
    cpu16 = [o.float() for o in cpu_forward(*cpu_args)]
    cpu_s = time.perf_counter() - t0
    cpu32 = f32(torch.device("cpu"), cpu_args)
    for n, c16, c32, p16, p32 in zip(names, card16, card32, cpu16, cpu32):
        d = float((c16 - p16).abs().mean())
        gap = float((p16 - p32).abs().mean())
        own = float((c16 - c32).abs().mean())
        say("entry", f"{n}: card vs CPU (bf16) mean |diff| {d:.3g} (limit {2 * gap:.3g}: "
            f"twice the CPU's own bf16-to-f32 {gap:.3g}), max {float((c16 - p16).abs().max()):.3g}; "
            f"the card's own bf16-to-f32 {own:.3g} (at least {0.5 * gap:.3g})")
        check(d <= 2 * gap, f"entry(): card and CPU bf16 {n} disagree")
        check(own >= 0.5 * gap, f"entry(): the card's bf16 {n} sits too close to its f32: "
              f"it did not compute in bf16")
    _, S, _, D = graft_entry.ENTRY_SHAPE
    say("entry", f"{card} | entry() bf16 forward, B={B} {S} px resnet34 stride 8, a "
        f"{S}x{S}x{D} volume, bilinear warp: {wall:.2f} ms wall on the card (CPU {cpu_s:.1f} s); "
        f"launches (K1, K5) {launches}: neither is on this path; K2 {k2_launches} (twice a "
        f"forward)")
    k2_row = k2_on_path(torch, k2_calls, card, "entry()")
    del k2_calls
    return launches, k2_launches, k2_row


def multi_device(np, torch, dev, card):
    """Phase 20b: ``dryrun_multichip(torch.cuda.device_count())``, one rank
    per card through NCCL, with the same steps run unsharded on the CPU
    (f32, TF32 off) and on the card: the estimator's loss and parts and the
    PPO update's metrics within ``DRYRUN_RTOL``; the world size, the mesh
    and the ms per step, sharded and unsharded on the card (at world 1 the
    cost of the mesh path: the group's collectives and the DTensors).
    Returns the launches of K1 and K5 in this process (the ranks are
    others)."""
    from rgbmanip_tpu_torch import graft_entry

    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    n = torch.cuda.device_count()
    zero_k1_counters(k1)
    k5.row_gather.launches = 0
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(n)
    run_s = time.perf_counter() - t0
    launches = (k1.crop_resize_normalize.launches + k1.crop_resize_normalize_clamp.launches,
                k5.row_gather.launches)
    dp, tp = out["dp"], out["tp"]
    check(dp * tp == n, f"a {dp}x{tp} mesh over {n} cards")
    cpu = graft_entry.dryrun_steps(dp, tp, device="cpu")
    whole = graft_entry.dryrun_steps(dp, tp, device=dev)
    got = [out["estimator_loss"]] + [out["estimator_parts"][k] for k in sorted(cpu["estimator_parts"])]
    ref = [cpu["estimator_loss"]] + [cpu["estimator_parts"][k] for k in sorted(cpu["estimator_parts"])]
    est_err = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    ppo_err = max(abs(a - b) / abs(b) for a, b in zip(out["ppo_metrics"], cpu["ppo_metrics"]))
    if "production_loss" in out:
        a, b = out["production_loss"], cpu["production_loss"]
        check(abs(a - b) <= DRYRUN_RTOL * abs(b),
              f"the production-shape step's loss {a} against the CPU's {b}")
    say("multichip", f"{card} | dryrun_multichip({n}) through nccl: world {n}, mesh dp={dp} "
        f"tp={tp}, {run_s:.1f} s with process start; estimator loss {out['estimator_loss']:.6f} "
        f"and parts, largest relative difference from the unsharded step on the CPU "
        f"{est_err:.3g}; PPO metrics {[round(m, 6) for m in out['ppo_metrics']]}, "
        f"{ppo_err:.3g} (limit {DRYRUN_RTOL:g} each)")
    say("multichip", f"{card} | ms per step on the card (median of 3 calls after the "
        f"first): estimator "
        f"(resnet18, B={2 * dp}, 32 px) sharded {out['estimator_ms']:.2f}, unsharded "
        f"{whole['estimator_ms']:.2f}; PPO update (T=8, N={4 * dp}, 2x2 minibatches) sharded "
        f"{out['ppo_ms']:.2f}, unsharded {whole['ppo_ms']:.2f}")
    check(est_err <= DRYRUN_RTOL and ppo_err <= DRYRUN_RTOL,
          "the sharded steps on the card disagree with the unsharded steps on the CPU")
    return launches


# ------------------------------ phase 21: the sweep and the diagnostics --
def sweep_and_diagnostics(np, card):
    """Phase 21: the evaluation sweep and the failure diagnostics through the
    port's scripts, each run with every launch counter set to 0 just before
    it and read just after. Returns K1's launches over the learned-stack
    runs."""
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5
    from rgbmanip_tpu_torch.scripts import diag_flagship, eval_sweep, trace_mug_learned
    from rgbmanip_tpu_torch.utils.logger import get_logger

    def counted(what, fn):
        zero_k1_counters(k1)
        k5.row_gather.launches = 0
        t0 = time.perf_counter()
        try:
            out = fn()
        except SystemExit as e:       # a script's non-zero exit
            raise SmokeError(f"{what}: {e}")
        secs = time.perf_counter() - t0
        return out, k1.crop_resize_normalize.launches, secs

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "build", "phase21")
    sweeps = {}
    for name in ("cuda", "cpu"):
        os.makedirs(os.path.join(work, name), exist_ok=True)
        with contextlib.chdir(os.path.join(work, name)):   # the sweep writes docs/ here
            out, n, secs = counted(f"eval_sweep on {name}", lambda: eval_sweep.main(
                [str(SWEEP_ROUNDS), "gt_pose", "ground_truth", f"device={name}"]))
        sweeps[name] = out["results"]
        check(len(out["results"]) == 16 and n == 0,
              f"the gt sweep on {name}: {len(out['results'])} rows, K1 {n} launches")
        say("sweep", f"eval_sweep {SWEEP_ROUNDS} gt_pose ground_truth device={name}: 16 rows "
            f"of {SWEEP_ROUNDS} episodes in {secs:.1f} s, no error row")
    same = sweeps["cuda"] == sweeps["cpu"]
    say("sweep", f"gt rows on the card equal the CPU's, row for row: {same}; "
        + ", ".join(f"{k} {v['success']:.2f}%" for k, v in sweeps["cuda"].items()))
    check(same, "the gt sweep on the card differs from the CPU's")

    total, log = 0, get_logger()
    for family, (row, passthru) in SWEEP_FAMILIES.items():
        est = f"adapose_{family}_fast"
        res, n, secs = counted(f"{family} row", lambda: eval_sweep.sweep(
            [row], SWEEP_ROUNDS, "heuristic_pose", est, passthru + ["device=cuda"], log))
        (key, r), = res.items()
        check("error" not in r, f"heuristic + {est} row {key}: {r.get('error')}")
        check(n == 2, f"heuristic + {est} row {key}: K1 launched {n} times; one estimate "
              f"of the round launches it twice")
        total += n
        say("sweep", f"{card} | heuristic_pose + {est} row {key} on the card: success "
            f"{r['success']:.2f}% over {r['episodes']} episodes (not gated), move "
            f"{r['move']:.3f} m, {secs:.1f} s with the estimator's load; K1 {n} launches")

    with mock.patch.dict(os.environ, EST_CKPT=CKPT_EST):     # as scripts/r5_stageD.sh:18
        out, n, secs = counted("diag_flagship", lambda: diag_flagship.main(
            [CKPT_POLICY, "1", "8", "device=cuda"]))
    n_est = (len(out["rl"].rows) + len(out["heuristic"].rows)) // 8
    check(n_est > 0 and n == 2 * n_est, f"diag_flagship: K1 launched {n} times in {n_est} "
          f"recorded estimates (twice per estimate)")
    rows = np.array(out["rl"].rows + out["heuristic"].rows)
    check(np.isfinite(rows).all(), "diag_flagship recorded non-finite rows")
    total += n
    say("diag", f"{card} | diag_flagship {CKPT_POLICY} 1 8 with {CKPT_EST} on the card: "
        f"{n_est} estimates recorded (RL {len(out['rl'].rows) // 8}, heuristic "
        f"{len(out['heuristic'].rows) // 8}), success RL {out['rl_success']}/8 heuristic "
        f"{out['heuristic_success']}/8 (not gated); {secs:.1f} s; K1 {n} launches")

    rows, n, secs = counted("trace_mug_learned", lambda: trace_mug_learned.main(
        ["mug_test", "1", "device=cuda"]))
    check(len(rows) == 8 and np.isfinite(np.array(rows, np.float64)).all(),
          f"trace_mug_learned: {len(rows)} rows")
    check(n == 2, f"trace_mug_learned: K1 launched {n} times in one round (twice)")
    total += n
    say("trace", f"{card} | trace_mug_learned mug_test 1 on the card: 8 episodes, "
        f"{secs:.1f} s; K1 {n} launches")
    say("phase21", f"the sweep and the diagnostics in {time.perf_counter() - t_phase:.1f} s; "
        f"K1 {total} launches over the learned-stack runs")
    return total


# ------------------------------------------- phase 22: the timing scripts --
def script_rows(name, out):
    """The JSON objects a timing script prints, one per line, and every
    number in them by its place ("<line> <key> ..."); raises if there is
    none."""
    rows = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    check(rows, f"{name}: no JSON line in its output:\n{out[-2000:]}")

    def numbers(v, at):
        if isinstance(v, dict):
            for k, x in v.items():
                yield from numbers(x, f"{at} {k}")
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield at.strip(), v

    return rows, {k: v for i, r in enumerate(rows) for k, v in numbers(r, str(i))}


def view2_raised(ext2):
    """``bench.bench_inputs``' second extrinsics with the camera raised
    1 mm. The bench's two views share their orientation and their crop rows,
    so every ray of the cost volume's first and last rows lands exactly on
    the source's top or bottom border, where each device's last bit decides
    whether it falls inside; 1 mm moves those rays 0.04-0.9 px off the
    border at every depth hypothesis."""
    raised = ext2.clone()
    raised[:, 1, 3] += 1e-3
    return raised


def estimate_projections(torch, est, inputs, replay=None):
    """``est._estimate`` on ``inputs`` (moved to its device): its (bbox,
    valid) as numpy, the plane sweep's projections (px, py, inside) of each
    ``stereo._project`` call on the CPU, and how many in-or-out decisions
    were taken from ``replay``: the projections of the same estimate on
    another device. After checking that the two devices' coordinates agree
    within PROJ_TOL px and that their decisions differ only for rays within
    TIE_PX px of the source's border, where the last bit decides, each ray
    whose decision differs takes ``replay``'s decision and coordinates."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    project, calls, taken = stereo._project, [], [0]

    def projected(rot, trans, xyz, depth_values, H, W):
        px, py, inside = project(rot, trans, xyz, depth_values, H, W)
        calls.append(tuple(t.cpu() for t in (px, py, inside)))
        if replay is None:
            return px, py, inside
        check(len(calls) <= len(replay), "the replayed estimate projects more often")
        rpx, rpy, rin = replay[len(calls) - 1]
        cpx, cpy, cin = calls[-1]
        gap = max(float((cpx - rpx).abs().max()), float((cpy - rpy).abs().max()))
        check(gap <= PROJ_TOL, f"the two devices' projections part by {gap:.3g} px")
        tie = ((cpx.abs() < TIE_PX) | ((cpx - (W - 1)).abs() < TIE_PX)
               | (cpy.abs() < TIE_PX) | ((cpy - (H - 1)).abs() < TIE_PX))
        flip = cin != rin
        check(not bool((flip & ~tie).any()), f"{int((flip & ~tie).sum())} in-or-out "
              f"decisions differ for rays off the border")
        taken[0] += int(flip.sum())
        # a flipped ray takes the card's coordinates too: at the border the
        # bilinear taps of py = -1e-7 and of +1e-7 are a row apart
        return tuple(torch.where(flip, r, c).to(inside.device)
                     for r, c in ((rpx, cpx), (rpy, cpy), (rin, cin)))

    with mock.patch.object(stereo, "_project", projected):
        bbox, valid, _ = est._estimate(*(t.to(est.device) for t in inputs))
    check(replay is None or len(calls) == len(replay),
          f"{len(calls)} projections against {len(replay or ())} replayed")
    return (bbox.cpu().numpy(), valid.cpu().numpy()), calls, taken[0]


def bench_card_against_cpu(np, torch, ests, B, raised):
    """The bench's estimate (``rgbmanip_tpu_torch.bench``) at batch ``B``
    on ``ests["card"]`` against ``ests["cpu"]`` (the same knobs, weights and
    dtype): its inputs made on the card, the same point draws, on the
    bench's own views or, if ``raised``, with view 2 raised 1 mm
    (``view2_raised``). The CPU's run replays the card's border-tie
    decisions (``estimate_projections``: only ties may differ), and then
    the bbox must agree within 1e-3 m, the two-view rule of
    ``tests/test_torch_estimator.py``, and the valid flags equal. Returns
    (max |bbox diff| m, n valid, decisions replayed); raises on a
    disagreement."""
    from rgbmanip_tpu_torch import bench

    g = torch.Generator().manual_seed(5)
    u1, u2 = (torch.rand(B, ests["cpu"].img_size ** 2, generator=g) for _ in range(2))
    K, rgb1, mask, ext1, rgb2, ext2 = bench.bench_inputs(B, bench.SEED, ests["card"].device)
    if raised:
        ext2 = view2_raised(ext2)
    inputs = (K, rgb1, mask, ext1, rgb2, mask, ext2, u1, u2)
    (cbox, cvalid), calls, _ = estimate_projections(torch, ests["card"], inputs)
    (pbox, pvalid), _, taken = estimate_projections(torch, ests["cpu"], inputs, calls)
    bdiff = float(np.abs(cbox - pbox).max())
    check(np.isfinite(cbox).all() and (cvalid == pvalid).all() and bdiff <= 1e-3,
          f"the bench estimate at B={B} (view 2 raised: {raised}): card and CPU disagree "
          f"(valid {cvalid} / {pvalid}, max |bbox diff| {bdiff:.3g} m, limit 1e-3)")
    return bdiff, int(cvalid.sum()), taken


def timing_scripts(np, torch, dev, card):
    """Phase 22: each timing script of the port at a short size in its own
    process on the card (``TIMING_SCRIPTS``), all five side by side, so the
    times they print check the scripts, not the card; every number of the
    JSON lines they print finite and positive (K1's launch counts, checked
    exactly, non-negative); the bench's K1 launches, counted by the wrapper
    in its process with the counters set to 0 just before each row, 2 per
    estimate; then the bench estimate at B=8 in f32 on the card against the
    same inputs on the CPU (``bench_card_against_cpu``). Returns the bench's
    K1 launches (f32, bf16)."""
    import subprocess

    from rgbmanip_tpu_torch import bench

    t_phase = time.perf_counter()
    procs, outs = {}, {}
    with tempfile.TemporaryDirectory() as logs:
        try:
            for name, args in TIMING_SCRIPTS.items():    # all at once: each start-up takes seconds
                with open(os.path.join(logs, f"{name}.out"), "w") as o, \
                        open(os.path.join(logs, f"{name}.err"), "w") as e:
                    procs[name] = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                                                   stdout=o, stderr=e)
            for p in procs.values():
                p.wait(timeout=300)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for name in procs:
            outs[name] = tuple(open(os.path.join(logs, f"{name}.{k}")).read()
                               for k in ("out", "err"))
    secs = time.perf_counter() - t_phase
    launches = {"float32": 0, "bfloat16": 0}
    for name, args in TIMING_SCRIPTS.items():
        out, err = outs[name]
        check(procs[name].returncode == 0, f"{name} exited {procs[name].returncode}:\n"
              f"{out[-2000:]}\n{err[-3000:]}")
        rows, nums = script_rows(name, out)
        bad = {k: v for k, v in nums.items() if not (
            math.isfinite(v) and (v > 0 or k.split()[-1].startswith("launches") and v == 0))}
        check(not bad, f"{name}: numbers not finite and positive: {bad}")
        if name == "bench":
            last = rows[-1]
            check(last.get("metric") == "pose_estimation_fps" and last["vs_baseline"] is None,
                  f"bench: its last line is not the headline: {last}")
            # the headline batches (--batch 8 64) print first, in bf16
            best = max(rows[:2], key=lambda r: r["frames_per_s"])
            check(f"(B={best['B']}, {torch.cuda.get_device_name(0)}, bf16," in last["unit"],
                  f"bench: unit {last['unit']!r}")
            for r in rows[:-1]:
                bf16 = r["dtype"] == "bfloat16"
                check(r["launches"] == 2 * r["estimates"]
                      and r["launches_bf16"] == (r["launches"] if bf16 else 0),
                      f"bench B={r['B']} {r['dtype']}: K1 launched {r['launches']} times "
                      f"({r['launches_bf16']} bf16) in {r['estimates']} estimates; the "
                      f"estimate launches it twice")
                launches[r["dtype"]] += r["launches"]
        if name == "bench_sim_scaling":
            check([(r["n_envs"], r["n_threads"]) for r in rows] == [(1, 1), (8, 1)],
                  f"bench_sim_scaling: rows {rows}")
        say("scripts", f"{card} | {' '.join(args)} (side by side with the others: not "
            f"a measurement): " + ", ".join(f"{k} {v:.6g}" for k, v in nums.items()))
    say("scripts", f"the five scripts side by side in {secs:.1f} s")

    ests = {k: bench.estimator(CKPT_EST, torch.float32, d)
            for k, d in (("card", dev), ("cpu", torch.device("cpu")))}
    for raised, tag in ((False, "its own views"), (True, "view 2 raised 1 mm")):
        bdiff, n_valid, taken = bench_card_against_cpu(np, torch, ests, BENCH_B_CPU, raised)
        say("scripts", f"the bench estimate B={BENCH_B_CPU} f32 on {tag}, the same inputs and "
            f"draws on the card and on the CPU, the card's {taken} border-tie decisions "
            f"replayed on the CPU: max |bbox diff| {bdiff:.3g} m (limit 1e-3), valid flags "
            f"equal ({n_valid}/{BENCH_B_CPU} valid)")
    say("phase22", f"the timing scripts in {time.perf_counter() - t_phase:.1f} s; the "
        f"bench's K1 launches: f32 {launches['float32']}, bf16 {launches['bfloat16']}")
    return launches["float32"], launches["bfloat16"]


def k1_bf16_timing(torch, F, rgb, win, S, card):
    """Phase 15: K1's bf16 entry point's device time at the flagship bf16
    estimate's B=8 frames and windows, beside its bound (bf16 output), its
    plain version's (``plain(...).to(bf16)``) and ``F.grid_sample``'s.
    Returns ({"kernel", "plain", "library": ms}, bound ms, bound_by)."""
    from rgbmanip_tpu_torch.ops import crop_resize as k1

    grid = grid_for(torch, *win, S)
    bf16 = torch.bfloat16
    calls = {
        "kernel": lambda: k1.crop_resize_normalize(rgb, *win, S, out_dtype=bf16),
        "plain": lambda: k1.crop_resize_normalize_plain(rgb, *win, S).to(bf16),
        "library": lambda: F.grid_sample(rgb.permute(0, 3, 1, 2), grid, mode="bilinear",
                                         padding_mode="border", align_corners=False),
    }
    times = {k: device_times(torch, fn) for k, fn in calls.items()}
    kern = {n: v for n, v in times["kernel"].items() if "crop_resize_normalize_kernel" in n}
    check(len(kern) == 1, f"the profiler did not see K1's bf16 kernel: {sorted(times['kernel'])}")
    ms = {"kernel": sum(kern.values()), "plain": sum(times["plain"].values()),
          "library": sum(times["library"].values())}
    bound, bound_by = k1_bound(torch, *win, S, out_bytes=2)
    say("time", f"{card} | K1 bf16 entry point B={rgb.shape[0]} {H}x{W}->{S}, device time per "
        f"call: kernel {ms['kernel']:.4f} ms ({bound / ms['kernel'] * 100:.1f}% of the "
        f"{bound:.4f} ms {bound_by} bound, bf16 out), plain + cast {ms['plain']:.4f} ms, "
        f"grid_sample {ms['library']:.4f} ms")
    return ms, bound, bound_by


# ----------------------------------------------------------------- inputs --
def look_at(np, eye, target):
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, -1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    E = np.eye(4)
    E[:3, :3] = np.stack([x, y, z])
    E[:3, 3] = -E[:3, :3] @ eye
    return E.astype(np.float32)


def views(np, rng, B, actions=None):
    """One synthetic view per env: a textured background, one textured box
    (env 1 mod 4 puts it in the frame's top-left corner, env 3 mod 4 in the
    bottom-right one), its mask, and a camera around the scene whose eye the
    policy's action moves (the first 3 action values, squashed)."""
    rgb = rng.uniform(0.1, 0.7, size=(B, H, W, 3)).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    ext = np.zeros((B, 4, 4), np.float32)
    for b in range(B):
        h, w = rng.integers(60, 200), rng.integers(60, 240)
        if b % 4 == 1:
            y0, x0 = 0, 0
        elif b % 4 == 3:
            y0, x0 = H - h, W - w
        else:
            y0, x0 = rng.integers(0, H - h), rng.integers(0, W - w)
        mask[b, y0:y0 + h, x0:x0 + w] = True
        colour = rng.uniform(0.0, 1.0, size=3)
        rgb[b, y0:y0 + h, x0:x0 + w] = np.clip(
            colour + rng.normal(0.0, 0.08, size=(h, w, 3)), 0.0, 1.0)
        eye = np.array([0.0, -0.9, 0.5]) + rng.normal(scale=0.05, size=3)
        if actions is not None:
            eye += 0.1 * np.tanh(actions[b, :3])
        ext[b] = look_at(np, eye, [0.0, 0.0, 0.3])
    return rgb, mask, ext


def pair(np, rng, B, actions=None):
    K = np.repeat(np.asarray(K_CAM, np.float32)[None], B, axis=0)
    r1, m1, e1 = views(np, rng, B)
    r2, m2, e2 = views(np, rng, B, actions)
    return K, r1, m1, e1, r2, m2, e2


# ------------------------------------------------------------------- K1 ----
def k1_windows(torch, mask, S):
    """The (rmin, cmin, inv_ratio) windows prepare_model_input hands K1."""
    from rgbmanip_tpu_torch.ops.preprocess import mask_bbox_batched, square_window_batched
    y1, x1, y2, x2, _ = mask_bbox_batched(mask.float())
    rmin, rmax, cmin, _ = square_window_batched(y1, x1, y2, x2, H, W)
    h = (rmax - rmin).float()
    inv = h * torch.tensor(1.0 / S, dtype=torch.float32, device=h.device)
    return rmin.float(), cmin.float(), inv


def k1_bound(torch, rmin, cmin, inv, S, out_bytes=4, clamp=False):
    """Least time for K1 on these windows: each source pixel that a tap with
    a non-zero weight touches read once (12 B), each output value written
    once (``out_bytes``: 4 for f32, 2 for bf16), the windows read once;
    against ~11 f32 operations per output value. With ``clamp`` the windows
    are the clamping mode's (``inv`` is then the ratio) and so are the
    taps. Returns (ms, "bytes" or "operations")."""
    from rgbmanip_tpu_torch.ops.crop_resize import _clamp_taps, _hat_taps
    from rgbmanip_tpu_torch.scripts.perfutil import HBM_BYTES_PER_S

    def distinct(lo, inv_b, n):
        i0, i1, w0, w1 = (_clamp_taps if clamp else _hat_taps)(lo, inv_b, S, n)
        return int(torch.unique(torch.cat([i0[w0 > 0], i1[w1 > 0]])).numel())

    rmin, cmin, inv = rmin.cpu(), cmin.cpu(), inv.cpu()
    B = rmin.shape[0]
    src_px = sum(distinct(rmin[b:b + 1], inv[b:b + 1], H)
                 * distinct(cmin[b:b + 1], inv[b:b + 1], W) for b in range(B))
    out_values = B * S * S * 3
    nbytes = src_px * 12 + out_values * out_bytes + B * 12
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = out_values * 11 / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_for(torch, rmin, cmin, inv, S, clamp=False):
    """grid_sample grid (align_corners=False) of the same source coords;
    with ``clamp`` the windows are the clamping mode's (``inv`` is the
    ratio, divided by)."""
    ii = torch.arange(S, dtype=torch.float32, device=rmin.device)[None]
    step = (ii + 0.5) / inv[:, None] if clamp else (ii + 0.5) * inv[:, None]
    sy = rmin[:, None] + step - 0.5
    sx = cmin[:, None] + step - 0.5
    gy = (sy + 0.5) / H * 2 - 1
    gx = (sx + 0.5) / W * 2 - 1
    B = rmin.shape[0]
    return torch.stack([gx[:, None, :].expand(B, S, S), gy[:, :, None].expand(B, S, S)],
                       dim=-1).contiguous()


def zero_k1_counters(k1):
    """Both border modes' launch counters, and their bf16 entry points', to 0."""
    for fn in (k1.crop_resize_normalize, k1.crop_resize_normalize_clamp):
        fn.launches = 0
        fn.launches_bf16 = 0


def k1_clamp_windows(torch, mask, S):
    """The (rmin, cmin, ratio) windows prepare_model_input hands K1's
    clamping mode (ratio = S / side, a true division)."""
    from rgbmanip_tpu_torch.ops.preprocess import mask_bbox_batched, square_window_batched
    y1, x1, y2, x2, _ = mask_bbox_batched(mask.float())
    rmin, rmax, cmin, _ = square_window_batched(y1, x1, y2, x2, H, W)
    h = (rmax - rmin).float()
    return rmin.float(), cmin.float(), torch.full_like(h, S) / h


def sweep_clamp_windows(torch, dev, S):
    """(rmin, cmin, ratio) of every 80 px side from 40 to 440, centred, at
    the middle of the top and left edges and at the four frame corners, and
    the reversed window of an empty mask."""
    wins = []
    for side in range(40, 441, 80):
        wins += [((H - side) // 2, (W - side) // 2, side), (0, (W - side) // 2, side),
                 ((H - side) // 2, 0, side), (0, 0, side), (0, W - side, side),
                 (H - side, 0, side), (H - side, W - side, side)]
    wins.append((460, 540, -440))
    w = torch.tensor(wins, dtype=torch.float32, device=dev)
    return w[:, 0], w[:, 1], torch.full_like(w[:, 2], S) / w[:, 2]


def k1_clamp_check(torch, k1, rgb, win, S, tag):
    """K1's clamping mode against its plain version on the card: f32 and
    bf16 bit for bit (the plain version's fused multiply-adds are rounded
    once, as the kernel's). Returns the f32 max |error| (0)."""
    out = k1.crop_resize_normalize_clamp(rgb, *win, S)
    out16 = k1.crop_resize_normalize_clamp(rgb, *win, S, out_dtype=torch.bfloat16)
    ref = k1.crop_resize_normalize_clamp_plain(rgb, *win, S)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and torch.isfinite(out).all().item(),
          f"K1 clamp {tag}: bad output")
    bad = int((out != ref).sum().item())
    check(bad == 0, f"K1 clamp {tag} f32: {bad} values differ from the plain version, max "
          f"|diff| {(out - ref).abs().max().item():.3g}")
    check(out16.dtype == torch.bfloat16 and torch.equal(out16, ref.to(torch.bfloat16)),
          f"K1 clamp {tag} bf16: differs from plain(...).to(bf16)")
    return (out - ref).abs().max().item()


def k1_clamp_timing(torch, F, rgb, win, S, card, flush):
    """Phase 7: K1's clamping mode, f32 and bf16 entry points, at the
    service loop's first B=8 frames and windows: device time beside its
    byte bound, its plain version's and ``F.grid_sample``'s with
    ``padding_mode="border"`` (which clamps the coordinate, not the taps:
    the yardstick call, not the same function at the border), warm and
    with the L2 flushed by ``flush`` before each launch (the trainer crops
    frames it has not just read). Returns {dtype: ({"kernel", "plain",
    "library": ms}, bound ms, bound_by)} of the warm calls."""
    from rgbmanip_tpu_torch.ops import crop_resize as k1

    grid = grid_for(torch, *win, S, clamp=True)
    out = {}
    for dt, nbytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        calls = {
            "kernel": lambda: k1.crop_resize_normalize_clamp(rgb, *win, S, out_dtype=dt),
            "plain": lambda: k1.crop_resize_normalize_clamp_plain(rgb, *win, S, out_dtype=dt),
            "library": lambda: F.grid_sample(rgb.permute(0, 3, 1, 2), grid, mode="bilinear",
                                             padding_mode="border", align_corners=False),
        }

        def clamp_ms(times):
            kern = {n: v for n, v in times["kernel"].items()
                    if "crop_resize_normalize_kernel" in n}
            check(len(kern) == 1, f"the profiler did not see K1's clamping kernel: "
                  f"{sorted(times['kernel'])}")
            return {"kernel": sum(kern.values()), "plain": sum(times["plain"].values()),
                    "library": sum(times["library"].values())}
        ms = clamp_ms({k: device_times(torch, fn) for k, fn in calls.items()})
        cold = clamp_ms({k: cold_device_times(torch, fn, flush) for k, fn in calls.items()})
        bound, bound_by = k1_bound(torch, *win, S, out_bytes=nbytes, clamp=True)
        name = "f32" if dt == torch.float32 else "bf16"
        for label, t in (("warm", ms), (f"L2 flushed before each launch "
                                        f"({L2_FLUSH_BYTES / 2 ** 20:.0f} MiB written)", cold)):
            say("time", f"{card} | K1 clamping mode {name} B={rgb.shape[0]} {H}x{W}->{S}, "
                f"{label}, device time per call: kernel {t['kernel']:.4f} ms "
                f"({bound / t['kernel'] * 100:.1f}% of the {bound:.4f} ms {bound_by} bound), "
                f"plain {t['plain']:.4f} ms, grid_sample(border) {t['library']:.4f} ms")
        out[name] = (ms, bound, bound_by)
    return out


def k1_check(torch, k1, rgb, win, S, tag):
    """Kernel vs plain on the card: f32 within 1e-5, bf16 within one bf16
    ulp of the f32 plain version. Returns the f32 max |error|."""
    out = k1.crop_resize_normalize(rgb, *win, S)
    ref = k1.crop_resize_normalize_plain(rgb, *win, S)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(out.shape == ref.shape and torch.isfinite(out).all().item(),
          f"K1 {tag}: bad output")
    check(err <= 1e-5, f"K1 {tag} f32: max |kernel - plain| {err:.3g} > 1e-5")
    out16 = k1.crop_resize_normalize(rgb, *win, S, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    over = ((out16.float() - ref).abs() > ulp).sum().item()
    check(out16.dtype == torch.bfloat16 and over == 0,
          f"K1 {tag} bf16: {over} values more than one bf16 ulp from the f32 plain")
    return err


# ------------------------------------------------------------------- K5 ----
def k5_table(torch, shape, dtype, dev, seed=0):
    """A (B, S*S, C) table of normal values in ``dtype`` (a torch name)."""
    B, S, C, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, S * S, C, generator=g, device=dev).to(getattr(torch, dtype))


def k5_check(torch, k5, shape, dtype, dev):
    """Kernel vs plain on the card, bit-exact: a gather rounds nothing.
    Returns the max |error| (0)."""
    table = k5_table(torch, shape, dtype, dev)
    out = k5.row_gather(table, shape[3])
    ref = k5.row_gather_plain(table, shape[3])
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == table.dtype,
          f"K5 {shape} {dtype}: bad output")
    rows = int((out != ref).any(-1).sum().item())
    check(rows == 0, f"K5 {shape} {dtype}: {rows} rows differ from the plain version")
    return (out.float() - ref.float()).abs().max().item()


# ----------------------------------------------------------- the estimate --
def stage_ranking(torch, est, inputs, kernels):
    """Device time per estimate of the network's stages, each replayed on
    the arguments one estimate gave it: the PSPNet features, the 3-D U-Net,
    the plane-sweep warp (K2, ``homo_warp_batched``), the point samples
    (K3, ``point_sample``: NOCS features and depth) and the pose gathers
    (K4, ``flat_gather`` in ``pose_branch``); and the rank each would take
    among ``kernels``, the estimate's device time by kernel name. Returns
    {stage: (calls, ms, rank, (its top kernel, ms))}."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    net = est.model
    stages = {   # label: (owner, attribute, which calls to keep)
        "PSPNet": (net.img_extractor, "forward", None),
        "3-D U-Net": (net.cost_regularization, "forward", None),
        "warp (K2)": (stereo, "homo_warp_batched", None),
        "point samples (K3)": (stereo, "point_sample", None),
        # the warp's own taps go through flat_gather too, with 3-D indices
        "pose gathers (K4)": (stereo, "flat_gather", lambda table, idx: idx.dim() == 2),
    }
    orig = {k: getattr(owner, attr) for k, (owner, attr, _) in stages.items()}
    calls = {k: [] for k in stages}

    def recorder(k, keep):
        def rec(*args):
            if keep is None or keep(*args):
                calls[k].append(args)
            return orig[k](*args)
        return rec

    patched = []
    try:
        for k, (owner, attr, keep) in stages.items():
            patched.append((owner, attr, attr in vars(owner)))
            setattr(owner, attr, recorder(k, keep))
        est.estimate_full(*inputs)
    finally:
        for (owner, attr, had), k in zip(patched, stages):
            if had:
                setattr(owner, attr, orig[k])
            else:
                delattr(owner, attr)
    out = {}
    with torch.inference_mode():
        for k in stages:
            check(calls[k], f"the estimate made no call to {k}")
            per_kernel = device_times(torch, lambda: [orig[k](*a) for a in calls[k]], n=5)
            total = sum(per_kernel.values())
            rank = 1 + sum(v > total for v in kernels.values())
            out[k] = (len(calls[k]), total, rank,
                      max(per_kernel.items(), key=lambda kv: kv[1]))
    return out


# ----------------------------------------------- the probe and paper paths --
def probe_path(torch, dev):
    """Phase 8: the gather probe's ``run`` at its default shape, counters
    set to 0 just before and read just after. Returns the launches."""
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5
    from rgbmanip_tpu_torch.scripts import try_gather

    k1.crop_resize_normalize.launches = 0
    k5.row_gather.launches = 0
    probe = try_gather.run(device=dev)             # at its default shape
    launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                "row_gather": k5.row_gather.launches}
    check(probe["exact"] and launches["row_gather"] > 0,
          f"the probe did not go through K5: {launches}")
    say("probe", f"{try_gather.describe(probe)} | launches {launches} (1 checked, "
        f"the rest timed)")
    return launches


def paper_path(np, torch, dev):
    """Phase 9: the paper-size estimator on seeded weights at each batch of
    ``B_PAPER`` (K1 held against its plain version at the estimator's size,
    then the estimate with the counters set to 0 just before it and read
    just after), and card against CPU at ``B_PAPER_CPU``. Returns the
    estimator and its inputs by batch."""
    from rgbmanip_tpu_torch.config.loader import load_group
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    cfg = load_group("pose_estimator", "adapose_cabinet", PAPER_OVERRIDES)
    S = int(cfg["img_size"])
    t0 = time.perf_counter()
    paper = AdaPoseEstimator(cfg, device=dev, seed=0)
    m = paper.model
    check((m.backend, m.backbone_stride, m.volume_scale, m.warp_mode, paper.n_depth,
           paper.n_pts) == ("resnet34", 8, 2, "nearest", 24, 1024),
          f"adapose_cabinet is not the paper configuration: {paper._arch_meta()}")
    Sv = S // m.volume_scale
    say("paper", f"adapose_cabinet on {dev} in {time.perf_counter() - t0:.1f} s: "
        f"resnet34 at backbone stride 8, {S} px, a {Sv}x{Sv}x{paper.n_depth} volume, "
        f"{paper.n_pts} points; weights made from seed 0 (the released .pth files "
        f"are not in the repo)")
    inputs_by_b = {}
    for B in B_PAPER:
        inputs = tuple(torch.from_numpy(a).to(dev)
                       for a in pair(np, np.random.default_rng(30 + B), B))
        inputs_by_b[B] = inputs
        err = k1_check(torch, k1, inputs[1], k1_windows(torch, inputs[2], S), S,
                       f"paper B={B}")
        k1.crop_resize_normalize.launches = 0
        k5.row_gather.launches = 0
        full = paper.estimate_full(*inputs)
        launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                    "row_gather": k5.row_gather.launches}
        check(launches["crop_resize_normalize"] == 2,
              f"K1 launched {launches['crop_resize_normalize']} times in one "
              f"paper-size estimate; the path launches it twice")
        check(full["bbox"].shape == (B, 8, 3) and np.isfinite(full["bbox"]).all(),
              f"paper estimate B={B}: bad bbox")
        say("paper", f"B={B}: {int(full['valid'].sum())}/{B} estimates valid; launches "
            f"{launches} (K1 twice per estimate); K1 at {S} px vs plain max |err| "
            f"f32 {err:.3g} (limit 1e-5), bf16 within one ulp")

    cpu_paper = AdaPoseEstimator(cfg, device="cpu", seed=0)
    B = B_PAPER_CPU
    views_cpu = pair(np, np.random.default_rng(40), B)
    g = torch.Generator().manual_seed(6)
    u1 = torch.rand(B, S * S, generator=g)
    u2 = torch.rand(B, S * S, generator=g)
    outs = {}
    for name, e in (("card", paper), ("cpu", cpu_paper)):
        d = e.device
        bbox, valid, _ = e._estimate(*(torch.from_numpy(a).to(d) for a in views_cpu),
                                     u1.to(d), u2.to(d))
        outs[name] = (bbox.cpu().numpy(), valid.cpu().numpy())
    bdiff = float(np.abs(outs["card"][0] - outs["cpu"][0]).max())
    vsame = bool((outs["card"][1] == outs["cpu"][1]).all())
    say("paper-card-vs-cpu", f"B={B} same views, draws and seeded weights: max |bbox "
        f"diff| {bdiff:.3g} m (limit 1e-3), valid flags equal: {vsame} "
        f"({int(outs['cpu'][1].sum())}/{B} valid)")
    check(bdiff <= 1e-3 and vsame, "card and CPU paper-size estimates disagree")
    check(outs["cpu"][1].any(), "no valid paper-size estimate: the comparison would "
          "be of sentinel boxes")
    return paper, inputs_by_b


def k5_timings(torch, dev, card):
    """Phase 10: K5's device time per call beside its bound, its plain
    version's and ``index_select``'s, at the probe's shape in bf16, warm
    and with the L2 flushed before each launch (the 2.75 MB table stays in
    the L2 between warm calls, so a warm call can beat the HBM bound).
    Returns the L2-flushed ({"kernel", "plain", "library": ms}, bound ms,
    bound_by)."""
    from rgbmanip_tpu_torch.ops import row_gather as k5
    from rgbmanip_tpu_torch.scripts import try_gather
    from rgbmanip_tpu_torch.scripts.perfutil import HBM_BYTES_PER_S

    shape = try_gather.DEFAULT_SHAPE
    B, S, C, D = shape
    table = k5_table(torch, shape, "bfloat16", dev)
    flat_index = try_gather.flat_gather_index(B, S * S, D, dev)
    calls = {
        "kernel": lambda: k5.row_gather(table, D),
        "plain": lambda: k5.row_gather_plain(table, D),
        "library": lambda: try_gather.index_select_reference(table, D, flat_index),
    }
    def k5_ms(dev_ms):
        kern = {n: v for n, v in dev_ms["kernel"].items() if "row_gather_kernel" in n}
        check(len(kern) == 1, f"the profiler did not see K5's kernel: {sorted(dev_ms['kernel'])}")
        return {"kernel": sum(kern.values()), "plain": sum(dev_ms["plain"].values()),
                "library": sum(dev_ms["library"].values())}
    warm = k5_ms({k: device_times(torch, fn) for k, fn in calls.items()})
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    cold = k5_ms({k: cold_device_times(torch, fn, flush.zero_) for k, fn in calls.items()})
    del flush
    bound_bytes, probe_bytes = try_gather.traffic(*shape, 2)
    bound, bound_by = bound_bytes / HBM_BYTES_PER_S * 1e3, "bytes"
    for label, ms in (("warm", warm), (f"L2 flushed before each launch "
                                       f"({L2_FLUSH_BYTES / 2 ** 20:.0f} MiB written)", cold)):
        say("time", f"{card} | K5 (B, S, C, D) = {shape} bf16, {label}, device time per "
            f"call: kernel {ms['kernel']:.4f} ms ({bound / ms['kernel'] * 100:.1f}% of the "
            f"{bound:.4f} ms {bound_by} bound: table read once + output written once, "
            f"{bound_bytes / 1e6:.1f} MB; {probe_bytes / ms['kernel'] / 1e6:.0f} GB/s eff "
            f"in the JAX probe's counting, {probe_bytes / 1e6:.1f} MB), plain "
            f"{ms['plain']:.4f} ms, index_select {ms['library']:.4f} ms (its int64 index "
            f"{flat_index.numel() * 8 / 1e6:.1f} MB)")
    return cold, bound, bound_by


def regime_timings(card):
    """Phase 10: the gather-regime sweep (rows or bytes?) on the card."""
    from rgbmanip_tpu_torch.scripts import probe_gather_regime as regime

    say("time", f"{card} | gather regime: index_select of a bf16 table of "
        f"{regime.TABLE_ROWS} rows, int32 indices, CUDA events, best of reps")
    for r in regime.run("cuda"):
        say("time", f"    {regime.describe(r)}")


def paper_timings(torch, paper, inputs_by_b, card):
    """Phase 10: the paper estimate's wall time, device busy time, idle
    share and top kernels at each batch, and where its stages (the warp and
    the point gathers among them) rank among those kernels."""
    for B, inputs in inputs_by_b.items():
        def estimate():
            paper.estimate_full(*inputs)
        wall = host_ms(torch, estimate, reps=5)
        kernels = device_times(torch, estimate, n=3)
        busy = sum(kernels.values())
        say("time", f"{card} | paper estimate B={B} (inputs on the card, f32): "
            f"{wall:.2f} ms wall, {B / wall * 1e3:.0f} view pairs/s; device busy "
            f"{busy:.2f} ms per estimate, idle {(1 - busy / wall) * 100:.0f}% of the "
            f"wall time; {len(kernels)} kernel names")
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        for rank, (name, v) in enumerate(top[:12], start=1):
            say("time", f"    #{rank} {v:.4f} ms ({v / busy * 100:.1f}%) {name[:90]}")
        for stage, (n, ms, rank, (kname, kms)) in stage_ranking(torch, paper, inputs,
                                                                  kernels).items():
            say("time", f"    {stage}: {n} calls, {ms:.4f} ms per estimate "
                f"({ms / busy * 100:.1f}% of busy), would rank #{rank} of "
                f"{len(kernels)}; its top kernel {kms:.4f} ms {kname[:60]}")


# ------------------------------------------------------------------ main ---
def run():
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, REPO)
    try:
        from rgbmanip_tpu_torch.algo.ppo import PPOPolicy
        from rgbmanip_tpu_torch.config.loader import load_group
        from rgbmanip_tpu_torch.models.controller.rl_pose import consensus_fuse
        from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
        from rgbmanip_tpu_torch.ops import _build
        from rgbmanip_tpu_torch.ops import crop_resize as k1
        from rgbmanip_tpu_torch.ops import row_gather as k5
        from rgbmanip_tpu_torch.scripts import try_gather
        from rgbmanip_tpu_torch.scripts.perfutil import bench, card_line
        from rgbmanip_tpu_torch.sim import bindings as sim_bindings
    except ImportError as e:
        raise SmokeError(f"the port is not next to this script ({e})")

    # 1. card --------------------------------------------------------------
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("card", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | TF32 off "
        f"for convolutions and matmuls (f32 throughout)")

    # 2. build -------------------------------------------------------------
    kernels = ["crop_resize_normalize", "row_gather", "plane_sweep_fuse"]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        sim_lib = ex.submit(sim_bindings.build)     # g++, beside the nvcc builds
        _build.build_all(kernels)
        sim_lib = sim_lib.result()
    say("build", f"{len(kernels)} kernel(s) built with nvcc for sm_90a and the simulator "
        f"with g++ ({os.path.basename(sim_lib)}), all at once, in "
        f"{time.perf_counter() - t0:.1f} s into build/")
    for name, report in _build.PTXAS_REPORTS.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    # 3. each kernel against its plain version -----------------------------
    pe_cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                        {"checkpoint_path": CKPT_EST})
    S = int(pe_cfg["img_size"])
    rng = np.random.default_rng(0)
    for B in (B_MAIN, B_WIDE):
        _, r1, m1, _, _, _, _ = pair(np, rng, B)
        rgb = torch.from_numpy(r1).to(dev)
        win = k1_windows(torch, torch.from_numpy(m1).to(dev), S)
        err = k1_check(torch, k1, rgb, win, S, f"B={B}")
        say("k1", f"B={B} {H}x{W} -> {S}: kernel vs plain max |err| f32 {err:.3g} "
            f"(limit 1e-5), bf16 within one ulp; windows "
            f"{sorted(set(int(round(float(v) * S)) for v in win[2]))} px incl. "
            f"frame corners")
    _, r1, m1, _, _, _, _ = pair(np, rng, B_MAIN)
    m1[0] = False                      # an empty mask: rmin 460, rmax 20, side -440
    win = k1_windows(torch, torch.from_numpy(m1).to(dev), S)
    check(float(win[2][0]) < 0, "the empty mask did not give a reversed window")
    err = k1_check(torch, k1, torch.from_numpy(r1).to(dev), win, S, "reversed window")
    say("k1", f"B={B_MAIN} with a reversed window (empty mask, side "
        f"{float(win[2][0]) * S:.0f} px): kernel vs plain max |err| f32 {err:.3g}, bf16 "
        f"within one ulp")
    clamp_errs = []
    for B in (B_MAIN, B_WIDE):
        _, r1, m1, _, _, _, _ = pair(np, np.random.default_rng(30 + B), B)
        m1[0] = False                  # an empty mask: a reversed window
        win = k1_clamp_windows(torch, torch.from_numpy(m1).to(dev), S)
        clamp_errs.append(k1_clamp_check(torch, k1, torch.from_numpy(r1).to(dev), win, S,
                                         f"B={B}"))
    sweep = sweep_clamp_windows(torch, dev, S)
    g = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(sweep[0].shape[0], H, W, 3, generator=g, device=dev)
    clamp_errs.append(k1_clamp_check(torch, k1, rgb, sweep, S, "window sweep"))
    say("k1", f"clamping mode (the estimator trainer's crop): kernel equals plain bit for bit "
        f"in f32 and bf16 at B={B_MAIN} and B={B_WIDE} on the synthetic views' windows "
        f"(frame corners and a reversed window included) and on {sweep[0].shape[0]} swept "
        f"windows (sides 40-440 px centred, at the top and left edges and at the four "
        f"corners)")
    k5_errs = []
    probe_shape = try_gather.DEFAULT_SHAPE
    for shape, dtype in ((probe_shape, "bfloat16"), (K5_WRAP_SHAPE, "bfloat16"),
                         (probe_shape, "float32")):
        k5_errs.append(k5_check(torch, k5, shape, dtype, dev))
        say("k5", f"(B, S, C, D) = {shape} {dtype}: kernel equals plain bit for bit "
            f"(max |err| {k5_errs[-1]:.3g})")

    # 4. load --------------------------------------------------------------
    t0 = time.perf_counter()
    est = AdaPoseEstimator(pe_cfg, device="cuda", seed=0)
    policy = PPOPolicy.from_checkpoint(CKPT_POLICY, load_group("controller", "rl")["policy"],
                                       device="cuda")
    say("load", f"{CKPT_EST} and {CKPT_POLICY} on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5. the service loop ---------------------------------------------------
    ctrl = load_group("controller", "rl")["controller"]
    M = int(ctrl["max_steps"]) + 1
    srng = np.random.default_rng(11)
    obs = srng.normal(size=(B_MAIN, 60)).astype(np.float32)
    inputs = [pair(np, srng, B_MAIN) for _ in range(STEPS)]   # made before the run
    pred_bbox = np.zeros((M, B_MAIN, 8, 3), np.float32)
    pair_dist = np.zeros((M, B_MAIN), np.float32)
    step_inputs = []
    n_valid = 0
    k1.crop_resize_normalize.launches = 0
    k5.row_gather.launches = 0
    t0 = time.perf_counter()
    for t in range(1, STEPS + 1):
        obs[:, -M:] = 0.0
        obs[:, -M + t - 1] = 1.0
        actions = policy.act_inference(obs)
        K, r1, m1, e1, _, _, _ = inputs[t - 1]
        r2, m2, e2 = views(np, np.random.default_rng(100 + t), B_MAIN, actions)
        step_inputs.append((K, r1, m1, e1, r2, m2, e2))
        full = est.estimate_full(K, r1, m1, e1, r2, m2, e2)
        pred_bbox[t] = full["bbox"]
        n_valid += int(full["valid"].sum())
        c1 = -np.einsum("nij,ni->nj", e1[:, :3, :3], e1[:, :3, 3])
        c2 = -np.einsum("nij,ni->nj", e2[:, :3, :3], e2[:, :3, 3])
        pair_dist[t] = np.linalg.norm(c1 - c2, axis=-1)
        obs[:, :6] = actions[:, :6]   # the next observation carries the action
    fused = consensus_fuse(pred_bbox, STEPS, stereo_ok=pair_dist >= 0.04)
    loop_s = time.perf_counter() - t0
    launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches,
                "row_gather": k5.row_gather.launches}
    check(launches["crop_resize_normalize"] == 2 * STEPS,
          f"K1 launched {launches['crop_resize_normalize']} times in {STEPS} "
          f"estimates; the path launches it twice per estimate")
    check(np.isfinite(pred_bbox[1:]).all() and pred_bbox.shape == (M, B_MAIN, 8, 3),
          "non-finite per-step bboxes")
    check(fused.shape == (B_MAIN, 8, 3) and np.isfinite(fused).all(), "bad fused bbox")
    check(actions.shape == (B_MAIN, 12) and np.isfinite(actions).all(), "bad actions")
    say("service", f"B={B_MAIN}, {STEPS} steps (actor -> estimate -> fuse) in "
        f"{loop_s:.2f} s incl. first-call warm-up; {n_valid}/{STEPS * B_MAIN} "
        f"per-step estimates valid; launches {launches} (2 per estimate)")

    # 6. card against CPU ---------------------------------------------------
    K, r1, m1, e1, r2, m2, e2 = step_inputs[0]
    g = torch.Generator().manual_seed(5)
    u1 = torch.rand(B_MAIN, S * S, generator=g)
    u2 = torch.rand(B_MAIN, S * S, generator=g)
    cpu_est = AdaPoseEstimator(pe_cfg, device="cpu")
    as_t = torch.from_numpy
    outs = {}
    for name, e, d in (("cuda", est, dev), ("cpu", cpu_est, torch.device("cpu"))):
        bbox, valid, _ = e._estimate(*(as_t(a).to(d) for a in (K, r1, m1, e1, r2, m2, e2)),
                                     u1.to(d), u2.to(d))
        outs[name] = (bbox.cpu().numpy(), valid.cpu().numpy())
    bdiff = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    vsame = bool((outs["cuda"][1] == outs["cpu"][1]).all())
    say("card-vs-cpu", f"B={B_MAIN} same views and draws: max |bbox diff| {bdiff:.3g} m "
        f"(limit 1e-3), valid flags equal: {vsame}")
    check(bdiff <= 1e-3 and vsame, "card and CPU estimates disagree")

    # 7. timings ------------------------------------------------------------
    rows = []
    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    for B, Sk in ((B_MAIN, S), (B_WIDE, S), (B_PAPER[1], S_PAPER)):
        if B == B_MAIN:   # the service loop's first view-1 batch and windows
            rgb = torch.from_numpy(step_inputs[0][1]).to(dev)
            win = k1_windows(torch, torch.from_numpy(step_inputs[0][2]).to(dev), Sk)
        else:
            _, rw, mw, _, _, _, _ = pair(np, np.random.default_rng(1), B)
            rgb = torch.from_numpy(rw).to(dev)
            win = k1_windows(torch, torch.from_numpy(mw).to(dev), Sk)
        err = k1_check(torch, k1, rgb, win, Sk, f"timed B={B} S={Sk}")
        grid = grid_for(torch, *win, Sk)
        calls = {
            "kernel": lambda x: k1.crop_resize_normalize(x, *win, Sk),
            "plain": lambda x: k1.crop_resize_normalize_plain(x, *win, Sk),
            "library": lambda x: F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear",
                                               padding_mode="border", align_corners=False),
        }

        def k1_ms(times):
            kern = {n: v for n, v in times["kernel"].items()
                    if "crop_resize_normalize_kernel" in n}
            check(len(kern) == 1, f"the profiler did not see K1's kernel: {sorted(times['kernel'])}")
            return {"kernel": sum(kern.values()), "plain": sum(times["plain"].values()),
                    "library": sum(times["library"].values())}

        ms = k1_ms({k: device_times(torch, lambda fn=fn: fn(rgb)) for k, fn in calls.items()})
        call_ms = {k: bench(fn, rgb, iters=20, reps=5) for k, fn in calls.items()}
        bound, bound_by = k1_bound(torch, *win, Sk)
        lib = calls["library"](rgb).permute(0, 2, 3, 1)
        mean = torch.tensor(k1.IMAGENET_MEAN, device=dev)
        std = torch.tensor(k1.IMAGENET_STD, device=dev)
        lib_err = ((lib - mean) / std - calls["kernel"](rgb)).abs().max().item()
        say("time", f"{card} | K1 B={B} {H}x{W}->{Sk} f32, device time per call: "
            f"kernel {ms['kernel']:.4f} ms ({bound / ms['kernel'] * 100:.1f}% of the "
            f"{bound:.4f} ms {bound_by} bound), plain {ms['plain']:.4f} ms, "
            f"grid_sample {ms['library']:.4f} ms (|diff| {lib_err:.2g} after "
            f"normalising) | back-to-back calls, CUDA events: wrapper "
            f"{call_ms['kernel']:.4f} ms, plain {call_ms['plain']:.4f} ms, "
            f"grid_sample {call_ms['library']:.4f} ms")
        if B == B_MAIN:   # the frames (29.5 MB) stay in L2 between warm calls
            cold = k1_ms({k: cold_device_times(torch, lambda fn=fn: fn(rgb), flush_buf.zero_)
                          for k, fn in calls.items()})
            say("time", f"{card} | K1 B={B} {H}x{W}->{Sk} f32, L2 flushed before each "
                f"launch ({L2_FLUSH_BYTES / 2 ** 20:.0f} MiB written), device time per "
                f"call: kernel {cold['kernel']:.4f} ms ({bound / cold['kernel'] * 100:.1f}% "
                f"of the bound), plain {cold['plain']:.4f} ms, grid_sample "
                f"{cold['library']:.4f} ms")
        rows.append((B, ms, bound, bound_by, err))
    clamp_rows = k1_clamp_timing(
        torch, F, torch.from_numpy(step_inputs[0][1]).to(dev),
        k1_clamp_windows(torch, torch.from_numpy(step_inputs[0][2]).to(dev), S), S, card,
        flush_buf.zero_)
    del flush_buf

    for B in (B_MAIN, B_WIDE):
        K, r1, m1, e1, r2, m2, e2 = (as_t(a).to(dev) for a in
                                    pair(np, np.random.default_rng(2), B))

        def estimate():
            est.estimate_full(K, r1, m1, e1, r2, m2, e2)
        wall = host_ms(torch, estimate, reps=7)
        kernels = device_times(torch, estimate, n=5)
        busy = sum(kernels.values())
        say("time", f"{card} | estimate B={B} (inputs on the card, f32): {wall:.2f} ms "
            f"wall, {B / wall * 1e3:.0f} view pairs/s; device busy {busy:.2f} ms "
            f"per estimate, idle {(1 - busy / wall) * 100:.0f}% of the wall time")
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        for name, v in top[:20 if B == B_MAIN else 6]:
            say("time", f"    {v:.4f} ms ({v / busy * 100:.1f}%) {name[:90]}")
    obs_t = torch.from_numpy(obs).to(dev)
    ms = host_ms(torch, lambda: policy.model.actor(obs_t), reps=21)
    ms_np = host_ms(torch, lambda: policy.act_inference(obs), reps=21)
    say("time", f"{card} | act_inference B={B_MAIN}: {ms_np:.3f} ms numpy in/out, "
        f"{ms:.3f} ms on-card tensors")

    # 8. the gather probe ----------------------------------------------------
    probe_launches = probe_path(torch, dev)

    # 9. the paper-size estimate ---------------------------------------------
    paper, paper_inputs = paper_path(np, torch, dev)

    # 10. timings of the probe path and the paper-size estimate ---------------
    k5_ms, k5_bound_ms, k5_bound_by = k5_timings(torch, dev, card)
    regime_timings(card)
    paper_timings(torch, paper, paper_inputs, card)

    # 11. the flagship evaluation --------------------------------------------
    eval_launches, eval_err = flagship_eval(np, torch, dev, card)

    # 12. PPO training of the camera scheduler ---------------------------------
    ppo_launches = ppo_training(np, torch, dev, card)

    # 13. the estimator's training ---------------------------------------------
    est_launches = estimator_training(np, torch, dev, card)

    # 14. heuristic + AdaPose on pot and mug; collect -> inference -------------
    heur_launches, heur_err = heuristic_eval(np, torch, dev, card)
    inf_launches, inf_k2_launches, k2_f32 = inference_batch(np, torch, dev, card)

    # 15. bf16 (the JAX package's default compute dtype); every generation -----
    bf16_launches, bf16_err, (t_rgb, t_win, t_S) = bf16_estimates(np, torch, dev, card)
    bf16_launches += bf16_evaluate(np, torch, card)
    bf16_train_launches = bf16_training(np, torch, dev, card)
    gen_launches = generations(np, torch, dev, card)
    k1_16_ms, k1_16_bound, k1_16_by = k1_bf16_timing(torch, F, t_rgb, t_win, t_S, card)

    # 16. RLManipulation: PPO on the joint-space actions ------------------------
    rl_manipulation(np, torch, dev, card)

    # 17. the URDF fixture datasets ---------------------------------------------
    urdf_launches = urdf_fixtures(np, torch, dev, card)

    # 18. the real-world env ------------------------------------------------------
    realworld_launches = realworld_env(np, torch, dev, card)

    # 19. the config generator ----------------------------------------------------
    config_generator()

    # 20. multi-device: entry() and dryrun_multichip through nccl -----------------
    entry_launches, entry_k2_launches, k2_bf16 = entry_forward(np, torch, dev, card)
    unet_ms = unet_layouts(torch, dev, card)
    dryrun_launches = multi_device(np, torch, dev, card)
    check(entry_launches == dryrun_launches == (0, 0),
          f"entry() and the dryrun launched (K1, K5) {entry_launches} and {dryrun_launches}")

    # 21. the evaluation sweep and the failure diagnostics ------------------------
    sweep_launches = sweep_and_diagnostics(np, card)

    # 22. the timing scripts -------------------------------------------------------
    bench_launches, bench_bf16_launches = timing_scripts(np, torch, dev, card)

    B, ms, bound, bound_by, err = rows[0]
    return card, {"kernels": [{
        "name": "crop_resize_normalize",
        "route": "cuda",
        "source": "rgbmanip_tpu_torch/csrc/crop_resize_normalize.cu",
        "replaces": "rgbmanip_tpu/ops/pallas_preprocess.py:55",
        "launches": (eval_launches["crop_resize_normalize"] + ppo_launches + heur_launches
                     + inf_launches + gen_launches + urdf_launches + realworld_launches
                     + sweep_launches + bench_launches),
        "max_abs_err": max(err, eval_err, heur_err),
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": ms["library"],
    }, {
        "name": "crop_resize_normalize_bf16",
        "route": "cuda",
        "source": "rgbmanip_tpu_torch/csrc/crop_resize_normalize.cu",
        "replaces": "rgbmanip_tpu/ops/pallas_preprocess.py:55",
        "launches": bf16_launches + bench_bf16_launches,
        "max_abs_err": bf16_err,
        "ms": k1_16_ms["kernel"],
        "plain_ms": k1_16_ms["plain"],
        "bound_ms": k1_16_bound,
        "bound_by": k1_16_by,
        "library_ms": k1_16_ms["library"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "rgbmanip_tpu_torch/csrc/crop_resize_normalize.cu",
        "replaces": "rgbmanip_tpu/ops/pallas_preprocess.py:55",
        "launches": n,
        "max_abs_err": max(clamp_errs),
        "ms": clamp_rows[dt][0]["kernel"],
        "plain_ms": clamp_rows[dt][0]["plain"],
        "bound_ms": clamp_rows[dt][1],
        "bound_by": clamp_rows[dt][2],
        "library_ms": clamp_rows[dt][0]["library"],
    } for name, dt, n in (("crop_resize_normalize_clamp", "f32",
                           est_launches + bf16_train_launches),
                          ("crop_resize_normalize_clamp_bf16", "bf16", 0))] + [{
        "name": "row_gather",
        "route": "cuda",
        "source": "rgbmanip_tpu_torch/csrc/row_gather.cu",
        "replaces": "scripts/try_pallas_gather.py:43",
        "launches": probe_launches["row_gather"],
        "max_abs_err": max(k5_errs),
        "ms": k5_ms["kernel"],
        "plain_ms": k5_ms["plain"],
        "bound_ms": k5_bound_ms,
        "bound_by": k5_bound_by,
        "library_ms": k5_ms["library"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "rgbmanip_tpu_torch/csrc/plane_sweep_fuse.cu",
        "replaces": "rgbmanip_tpu/models/pose_estimator/nets/stereo.py:38",
        "launches": n,
        "max_abs_err": 0.0,         # held bit for bit on every call of the path
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": "bytes",
        # the layer after K2 in each dtype's layout: in bf16 the U-Net on
        # K2's channels-last volume and on an NCDHW copy; f32 runs NCDHW
        "library_ms": library,
        "shape": list(shape),
    } for name, n, (ms, plain, bound, shape, _), library in (
        ("plane_sweep_fuse", inf_k2_launches, k2_f32, None),
        ("plane_sweep_fuse_bf16", entry_k2_launches, k2_bf16, unet_ms))]}


def main():
    t0 = time.perf_counter()
    try:
        card, kernels_line = run()
    except SmokeError as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
    import torch
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
