#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py    # from the repo root, on a machine with a card

The main path is the flagship evaluation's estimate/policy/fuse service
(``controller=rl``, ``pose_estimator=adapose_cabinet_fast`` with
``checkpoints/estimator_fast_cabinet_aug_r5.ckpt``, 8 envs): per step the PPO
actor picks the next camera pose, the estimator turns each env's last two
640x480 views into a world bbox, and ``consensus_fuse`` merges the per-step
bboxes. The views are synthetic and made from a seed; the simulator is not
ported yet. Phases:

  1. card: name, power limit, versions; TF32 off for the f32 phases
  2. build every kernel of the path with nvcc (sm_90a), all at once
  3. each kernel against its plain PyTorch version on the card
  4. load the estimator and the policy onto the card
  5. the service loop, B=8, 4 steps, with every launch counter set to 0
     just before it and read just after
  6. the same estimate on the card and on the CPU (plain path)
  7. timings: each kernel's device time (torch.profiler) beside its bound,
     its plain version's and the library call's; back-to-back call times
     (CUDA events); estimate wall time, device busy time and the kernels
     that take it, at B=8 and B=64

Any failure exits non-zero. The line before the last is the kernels' JSON,
the line before that the card's name and power limit, and the last line is
``{"ok": true, "device": {...}}``. Without a card the script exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 480, 640
STEPS, B_MAIN, B_WIDE = 4, 8, 64
CKPT_EST = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
CKPT_POLICY = "checkpoints/ppo_rl_coadapt_model_165.ckpt"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
K_CAM = ((439.3, 0.0, 320.0), (0.0, 439.3, 240.0), (0.0, 0.0, 1.0))


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, reps=5):
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_times(torch, fn, n=20):
    """Device time per call, by kernel name: torch.profiler over ``n`` calls
    after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {e.key: e.self_device_time_total / n / 1e3 for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    check(out, "torch.profiler recorded no device time")
    return out


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
    kernels = ["crop_resize_normalize"]
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
    launches = {"crop_resize_normalize": k1.crop_resize_normalize.launches}
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
    for B in (B_MAIN, B_WIDE):
        if B == B_MAIN:   # the service loop's first view-1 batch and windows
            rgb = torch.from_numpy(step_inputs[0][1]).to(dev)
            win = k1_windows(torch, torch.from_numpy(step_inputs[0][2]).to(dev), S)
        else:
            _, rw, mw, _, _, _, _ = pair(np, np.random.default_rng(1), B)
            rgb = torch.from_numpy(rw).to(dev)
            win = k1_windows(torch, torch.from_numpy(mw).to(dev), S)
        err = k1_check(torch, k1, rgb, win, S, f"timed B={B}")
        grid = grid_for(torch, *win, S)
        nchw = rgb.permute(0, 3, 1, 2)
        calls = {
            "kernel": lambda: k1.crop_resize_normalize(rgb, *win, S),
            "plain": lambda: k1.crop_resize_normalize_plain(rgb, *win, S),
            "library": lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                             padding_mode="border", align_corners=False),
        }
        dev_ms = {k: device_times(torch, fn) for k, fn in calls.items()}
        kern = {n: v for n, v in dev_ms["kernel"].items() if "crop_resize_normalize_kernel" in n}
        check(len(kern) == 1, f"the profiler did not see K1's kernel: {sorted(dev_ms['kernel'])}")
        ms = {"kernel": sum(kern.values()), "plain": sum(dev_ms["plain"].values()),
              "library": sum(dev_ms["library"].values())}
        call_ms = {k: cuda_ms(torch, fn) for k, fn in calls.items()}
        bound, bound_by = k1_bound(torch, *win, S)
        lib = calls["library"]().permute(0, 2, 3, 1)
        mean = torch.tensor(k1.IMAGENET_MEAN, device=dev)
        std = torch.tensor(k1.IMAGENET_STD, device=dev)
        lib_err = ((lib - mean) / std - calls["kernel"]()).abs().max().item()
        say("time", f"{card} | K1 B={B} {H}x{W}->{S} f32, device time per call: "
            f"kernel {ms['kernel']:.4f} ms ({bound / ms['kernel'] * 100:.1f}% of the "
            f"{bound:.4f} ms {bound_by} bound), plain {ms['plain']:.4f} ms, "
            f"grid_sample {ms['library']:.4f} ms (|diff| {lib_err:.2g} after "
            f"normalising) | back-to-back calls, CUDA events: wrapper "
            f"{call_ms['kernel']:.4f} ms, plain {call_ms['plain']:.4f} ms, "
            f"grid_sample {call_ms['library']:.4f} ms")
        rows.append((B, ms, bound, bound_by, err))

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
