#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py    # from the repo root, on a machine with a card

The script drives three paths of the port. The main one is the flagship
evaluation's estimate/policy/fuse service (``controller=rl``,
``pose_estimator=adapose_cabinet_fast`` with
``checkpoints/estimator_fast_cabinet_aug_r5.ckpt``, 8 envs): per step the PPO
actor picks the next camera pose, the estimator turns each env's last two
640x480 views into a world bbox, and ``consensus_fuse`` merges the per-step
bboxes. The second is the row-gather probe (``scripts/try_gather.py``, the
one entry point of kernel K5) at its default shape; the third the
paper-size estimator (``adapose_cabinet``: resnet34 at backbone stride 8,
224 px, a 112x112x24 cost volume, 1024 points) on weights made from a seed,
since its released weights are not in the repo. The views are synthetic
and made from a seed; the simulator is not ported yet. Each path runs with
every launch counter set to 0 just before it and read just after. Phases:

  1. card: name, power limit, versions; TF32 off for the f32 phases
  2. build every kernel of the path with nvcc (sm_90a), all at once
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

Phase 3 also holds K1 against its plain version on a reversed window (an
empty mask gives a window of negative side), and K5, bit-exact, at
(16, 112, 32, 24) in bf16 and f32 and at (1, 640, 8, 2), where the index
arithmetic wraps around int32.

Any failure exits non-zero. The line before the last is the kernels' JSON,
the line before that the card's name and power limit, and the last line is
``{"ok": true, "device": {...}}``. Without a card the script exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

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
K_CAM = ((439.3, 0.0, 320.0), (0.0, 439.3, 240.0), (0.0, 0.0, 1.0))


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_times(torch, fn, n=20, attempts=3):
    """Device time per call, by kernel name: torch.profiler over ``n`` calls
    after one warm-up call. A profile now and then holds no device events at
    all; the calls are then profiled again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / n / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
        if out:
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


def k1_bound(torch, rmin, cmin, inv, S):
    """Least time for K1 on these windows: each source pixel that a tap with
    a non-zero weight touches read once (12 B), each output value written
    once, the windows read once; against ~11 f32 operations per output
    value. Returns (ms, "bytes" or "operations")."""
    from rgbmanip_tpu_torch.ops.crop_resize import _hat_taps
    from rgbmanip_tpu_torch.scripts.perfutil import HBM_BYTES_PER_S

    def distinct(lo, inv_b, n):
        i0, i1, w0, w1 = _hat_taps(lo, inv_b, S, n)
        return int(torch.unique(torch.cat([i0[w0 > 0], i1[w1 > 0]])).numel())

    rmin, cmin, inv = rmin.cpu(), cmin.cpu(), inv.cpu()
    B = rmin.shape[0]
    src_px = sum(distinct(rmin[b:b + 1], inv[b:b + 1], H)
                 * distinct(cmin[b:b + 1], inv[b:b + 1], W) for b in range(B))
    out_values = B * S * S * 3
    nbytes = src_px * 12 + out_values * 4 + B * 12            # f32 out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = out_values * 11 / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_for(torch, rmin, cmin, inv, S):
    """grid_sample grid (align_corners=False) of the same source coords."""
    ii = torch.arange(S, dtype=torch.float32, device=rmin.device)[None]
    sy = rmin[:, None] + (ii + 0.5) * inv[:, None] - 0.5
    sx = cmin[:, None] + (ii + 0.5) * inv[:, None] - 0.5
    gy = (sy + 0.5) / H * 2 - 1
    gx = (sx + 0.5) / W * 2 - 1
    B = rmin.shape[0]
    return torch.stack([gx[:, None, :].expand(B, S, S), gy[:, :, None].expand(B, S, S)],
                       dim=-1).contiguous()


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
    version's and ``index_select``'s, at the probe's shape in bf16.
    Returns ({"kernel", "plain", "library": ms}, bound ms, bound_by)."""
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
    dev_ms = {k: device_times(torch, fn) for k, fn in calls.items()}
    kern = {n: v for n, v in dev_ms["kernel"].items() if "row_gather_kernel" in n}
    check(len(kern) == 1, f"the profiler did not see K5's kernel: {sorted(dev_ms['kernel'])}")
    ms = {"kernel": sum(kern.values()), "plain": sum(dev_ms["plain"].values()),
          "library": sum(dev_ms["library"].values())}
    bound_bytes, probe_bytes = try_gather.traffic(*shape, 2)
    bound, bound_by = bound_bytes / HBM_BYTES_PER_S * 1e3, "bytes"
    say("time", f"{card} | K5 (B, S, C, D) = {shape} bf16, device time per call: "
        f"kernel {ms['kernel']:.4f} ms ({bound / ms['kernel'] * 100:.1f}% of the "
        f"{bound:.4f} ms {bound_by} bound: table read once + output written once, "
        f"{bound_bytes / 1e6:.1f} MB; {probe_bytes / ms['kernel'] / 1e6:.0f} GB/s eff "
        f"in the JAX probe's counting, {probe_bytes / 1e6:.1f} MB), plain "
        f"{ms['plain']:.4f} ms, index_select {ms['library']:.4f} ms (its int64 index "
        f"{flat_index.numel() * 8 / 1e6:.1f} MB)")
    return ms, bound, bound_by


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
    kernels = ["crop_resize_normalize", "row_gather"]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    say("build", f"{len(kernels)} kernel(s) built with nvcc for sm_90a in "
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

    B, ms, bound, bound_by, err = rows[0]
    return card, {"kernels": [{
        "name": "crop_resize_normalize",
        "route": "cuda",
        "source": "rgbmanip_tpu_torch/csrc/crop_resize_normalize.cu",
        "replaces": "rgbmanip_tpu/ops/pallas_preprocess.py:54",
        "launches": launches["crop_resize_normalize"],
        "max_abs_err": err,
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": ms["library"],
    }, {
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
    }]}


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
