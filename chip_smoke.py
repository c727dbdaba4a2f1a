#!/usr/bin/env python3
"""Hold each hand-written kernel of the PyTorch port on one NVIDIA card
against its plain version, at the shapes the port's main path hands it, and
time it.

    python3 chip_smoke.py    # from the repo root, on a machine with a card

The main path is the estimate, ``AdaPoseEstimator.estimate_full`` on the
card, built and fed as the benchmark builds and feeds it
(``portbench/drivers/estimate.py``: the configuration's knobs and weights,
one batch of the cell's view pairs, seed 0). The runs (``RUNS``), each with
every launch counter set to 0 just before it and read just after, and with
the arguments of every call to a kernel's wrapper recorded:

  - the flagship evaluation's estimate: ``adapose_cabinet_fast`` at B=8 in
    f32 (its configurations name no dtype): K1 twice;
  - the three bf16 cells at their own batch and dtype (``fast.estimate_b128``,
    ``paper.estimate_b16``, ``parity.estimate_b16``): K1's bf16 entry point
    twice an estimate, K2 twice in parity and never in the others, K7 (the
    U-Net's ``prob`` convolution) twice in each;
  - the f32 cell ``v1.estimate_b16_f32``, the original network at B=16: K1
    twice, K2 twice at (16, 32, 24, 224, 224), K7 never (v1 has no U-Net);
  - the parity network in f32 at B=8, the volume of the estimator's
    inference harness, (8, 32, 24, 224, 224): K1 twice, K2 twice, K7 never;
  - the estimator trainer's crop (``SimViewSampler._prepare``:
    ``prepare_model_input(..., border="clamp")`` at 192 px, 1024 points) of
    the flagship run's views: K1's clamping mode twice;
  - the gather probe, ``scripts/try_gather.py``'s ``run`` at its default
    shape, the one entry point of K5 (no main path runs it).

Then each wrapper again on every recorded call, against its plain version:
K1 in f32 and both border modes bit for bit, its bf16 entry points bit for
bit ``plain(..., out_dtype=bf16)``, K2 bit for bit
``stereo.fused_volume_plain`` in the channels-last layout both write, K5 bit
for bit; K7, which sums in another order than its plain version (cuDNN's
convolution), against the f64-accumulated convolution to the card tests'
tolerance (``prob_conv.reference_gaps``); K1 also on a reversed window (an
empty mask) and a sweep of centred, edge and corner windows, K5 also in f32
and at (1, 640, 8, 2), where its index arithmetic wraps around int32. Last,
each kernel's device time a launch (torch.profiler) on the first run that
launched it (so K2 in f32 on the v1 cell's calls; K7 on the parity and the
paper cells' calls), beside its bound (its least bytes and operations,
``portbench/counts``, over the card's peaks, ``portbench/counts/peaks.py``),
its plain version's and one library call's: ``F.grid_sample`` of the same
coordinates for K1 (border padding) and K2 (zero padding, one tap set a
depth, no fusing add), ``index_select`` for K5, and for K7 ``F.conv3d`` in
bf16 on the channels-last volume (cuDNN), which is also its plain version.

Any failure exits 1. The last three lines are the card's name and power
limit, the kernels' JSON line and ``{"ok": true, "device": {...}}``. Without
a card the script exits 1 and prints no result. The port's paths, card
against the CPU, are held by the card tests (``python -m pytest
--noconftest tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 480, 640
SEED = 0
# (label, configuration, workload, overrides of the workload); each kernel is
# timed on the first run that launched it
RUNS = (("flagship B=8 f32", "adapose_cabinet_fast", "fast.estimate_b128",
         {"batch": 8, "dtype": "float32"}),
        ("fast.estimate_b128", "adapose_cabinet_fast", "fast.estimate_b128", {}),
        ("paper.estimate_b16", "adapose_cabinet", "paper.estimate_b16", {}),
        ("parity.estimate_b16", "adapose_cabinet_parity", "parity.estimate_b16", {}),
        ("v1.estimate_b16_f32", "adapose_cabinet_v1", "v1.estimate_b16_f32", {}),
        ("parity B=8 f32", "adapose_cabinet_parity", "parity.estimate_b16",
         {"batch": 8, "dtype": "float32"}))
TRAIN_CROP = (192, 1024)       # the estimator trainer's img_size and n_pts
K5_EXTRA = (((16, 112, 32, 24), "float32"), ((1, 640, 8, 2), "bfloat16"))
# the kernels line's rows: (name, the calls it is timed on, bf16, (source, TPU kernel))
K1_SRC = ("rgbmanip_tpu_torch/csrc/crop_resize_normalize.cu",
          "rgbmanip_tpu/ops/pallas_preprocess.py:55")
K2_SRC = ("rgbmanip_tpu_torch/csrc/plane_sweep_fuse.cu",
          "rgbmanip_tpu/models/pose_estimator/nets/stereo.py:38")
K5_SRC = ("rgbmanip_tpu_torch/csrc/row_gather.cu", "scripts/try_pallas_gather.py:43")
K7_SRC = ("rgbmanip_tpu_torch/csrc/prob_conv3d.cu", "none")
# K7's rows: the runs whose calls it is timed on
K7_TIMED_ON = ("parity.estimate_b16", "paper.estimate_b16")
ROWS = (("crop_resize_normalize", "renormalise", False, K1_SRC),
        ("crop_resize_normalize_bf16", "renormalise", True, K1_SRC),
        ("crop_resize_normalize_clamp", "clamp", False, K1_SRC),
        ("crop_resize_normalize_clamp_bf16", "clamp", True, K1_SRC),
        ("plane_sweep_fuse", "k2", False, K2_SRC),
        ("plane_sweep_fuse_bf16", "k2", True, K2_SRC),
        ("row_gather", "k5", True, K5_SRC))


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def device_times(torch, fn, n=20, attempts=10):
    """Device time a call, by kernel name: torch.profiler over ``n`` calls
    after one warm-up call. A profile now and then holds no device events;
    the calls are then profiled again, up to ``attempts`` times."""
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


@contextlib.contextmanager
def recorded(calls):
    """Within: every call to a kernel's wrapper, as the port's modules call
    it, appended to ``calls[kind]`` as (args, kwargs): "renormalise" and
    "clamp" (K1's border modes), "k2", "k5", "k7"."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    from rgbmanip_tpu_torch.ops import preprocess, prob_conv
    from rgbmanip_tpu_torch.scripts import try_gather

    hooks = ((preprocess, "crop_resize_normalize", "renormalise"),
             (preprocess, "crop_resize_normalize_clamp", "clamp"),
             (stereo, "fused_volume", "k2"), (try_gather, "row_gather", "k5"),
             (prob_conv, "prob_conv3d", "k7"))
    origs = [getattr(m, name) for m, name, _ in hooks]
    for (m, name, kind), orig in zip(hooks, origs):
        def rec(*args, _orig=orig, _kind=kind, **kw):
            calls.setdefault(_kind, []).append((args, kw))
            return _orig(*args, **kw)
        setattr(m, name, rec)
    try:
        yield
    finally:
        for (m, name, _), orig in zip(hooks, origs):
            setattr(m, name, orig)


def launches(calls, k2_bf16=False):
    """Every launch counter, by row of the kernels line. K2 counts its
    launches in both dtypes together: they go to the row of ``k2_bf16``. K7
    keeps no counter outside a span: its launches are its calls recorded in
    ``calls`` (its wrapper launches once a call, or raises)."""
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import plane_sweep as k2
    from rgbmanip_tpu_torch.ops import row_gather as k5
    r, c = k1.crop_resize_normalize, k1.crop_resize_normalize_clamp
    n = {"crop_resize_normalize": r.launches - r.launches_bf16,
         "crop_resize_normalize_bf16": r.launches_bf16,
         "crop_resize_normalize_clamp": c.launches - c.launches_bf16,
         "crop_resize_normalize_clamp_bf16": c.launches_bf16,
         "plane_sweep_fuse": 0, "plane_sweep_fuse_bf16": 0,
         "row_gather": k5.row_gather.launches, "prob_conv3d_bf16": len(calls.get("k7", ()))}
    n["plane_sweep_fuse_bf16" if k2_bf16 else "plane_sweep_fuse"] = k2.warp_fuse.launches
    return n


def zero_launches():
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import plane_sweep as k2
    from rgbmanip_tpu_torch.ops import row_gather as k5
    for fn in (k1.crop_resize_normalize, k1.crop_resize_normalize_clamp):
        fn.launches = fn.launches_bf16 = 0
    k2.warp_fuse.launches = k5.row_gather.launches = 0


# ------------------------------------------------------------- the runs ----
def path_runs(torch, dev):
    """Each run of ``RUNS``, the trainer's crop and the probe, with the
    counters set to 0 just before and read just after, checked against the
    counts the path launches. Returns [(label, launches, calls)]."""
    import numpy as np

    from portbench import harness as PH
    from portbench.drivers import estimate as D
    from rgbmanip_tpu_torch.ops.preprocess import prepare_model_input
    from rgbmanip_tpu_torch.scripts import try_gather

    out = []
    for label, config, workload, over in RUNS:
        cfg = PH.load_json(PH.HERE, "configs", f"{config}.json")
        wl = dict(PH.load_json(PH.HERE, "workloads", f"{workload}.json"), pool=1, **over)
        x = D.inputs(wl, SEED, dev)[0]
        est = D.program(cfg, D.DTYPES[wl["dtype"]], SEED, dev)
        est.generator = torch.Generator(device=dev).manual_seed(1)
        calls = {}
        zero_launches()
        with recorded(calls):
            full = D.call(est, x)
        B, bf16 = int(wl["batch"]), wl["dtype"] == "bfloat16"
        n = launches(calls, k2_bf16=bf16)
        k2 = 2 if cfg["warp_mode"] == "bilinear" else 0
        want = {k: 0 for k in n}
        want["crop_resize_normalize_bf16" if bf16 else "crop_resize_normalize"] = 2
        want["plane_sweep_fuse_bf16" if bf16 else "plane_sweep_fuse"] = k2
        want["prob_conv3d_bf16"] = 2 if bf16 else 0
        check(n == want, f"{label}: launches {n}, the path launches {want}")
        check(full["bbox"].shape == (B, 8, 3) and bool(np.isfinite(full["bbox"]).all()),
              f"{label}: bbox {full['bbox'].shape}, not all finite")
        say("path", f"{label}: {cfg['name']} ({cfg['backend']}, {cfg['img_size']} px, "
            f"{cfg['warp_mode']} warp), B={B} {wl['dtype']}: {int(full['valid'].sum())}/{B} "
            f"valid; launches {dict((k, v) for k, v in n.items() if v)}")
        out.append((label, n, calls))
        if label.startswith("flagship"):
            crop_views = x
        del est, x, full
        torch.cuda.empty_cache()

    S, n_pts = TRAIN_CROP
    calls = {}
    g = torch.Generator(device=dev).manual_seed(2)
    zero_launches()
    with recorded(calls):
        for v in ("1", "2"):
            prepare_model_input(crop_views[f"rgb{v}"], crop_views[f"mask{v}"],
                                crop_views["K"], g, S, n_pts, border="clamp")
    n = launches(calls)
    check(n["crop_resize_normalize_clamp"] == 2 and sum(n.values()) == 2,
          f"the trainer's crop: launches {n}; it launches the clamping mode once a view")
    say("path", f"the estimator trainer's crop of the flagship run's views, {S} px: "
        f"launches {dict((k, v) for k, v in n.items() if v)}")
    out.append(("trainer crop", n, calls))

    calls = {}
    zero_launches()
    with recorded(calls):
        probe = try_gather.run(device=dev)
    n = launches(calls)
    check(probe["exact"] and n["row_gather"] > 0 and sum(n.values()) == n["row_gather"],
          f"the probe did not go through K5 alone: {n}")
    say("path", f"{try_gather.describe(probe)} | launches {n['row_gather']}")
    out.append(("probe", n, calls))
    return out


# ----------------------------------------------- each kernel against plain --
def k1_equal(torch, k1, args, kw, mode, tag):
    """K1 (``mode``: "renormalise" or "clamp") against its plain version on
    one call's arguments, in f32 and bf16, bit for bit."""
    wrap, plain = ((k1.crop_resize_normalize, k1.crop_resize_normalize_plain)
                   if mode == "renormalise" else
                   (k1.crop_resize_normalize_clamp, k1.crop_resize_normalize_clamp_plain))
    kw = dict(kw)
    kw.pop("out_dtype", None)
    for dt in (torch.float32, torch.bfloat16):
        got, want = wrap(*args, **kw, out_dtype=dt), plain(*args, **kw, out_dtype=dt)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == dt and got.shape == want.shape
              and torch.equal(got, want),
              f"K1 {mode} {tag} {dt}: {int((got != want).sum())} values differ from plain")


def swept_windows(torch, dev, S):
    """(rmin, cmin, inv_ratio, ratio) of every 80 px side from 40 to 440,
    centred, at the middle of the top and left edges and at the four frame
    corners, and the reversed window of an empty mask."""
    wins = []
    for side in range(40, 441, 80):
        wins += [((H - side) // 2, (W - side) // 2, side), (0, (W - side) // 2, side),
                 ((H - side) // 2, 0, side), (0, 0, side), (0, W - side, side),
                 (H - side, 0, side), (H - side, W - side, side)]
    wins.append((460, 540, -440))
    w = torch.tensor(wins, dtype=torch.float32, device=dev)
    inv = w[:, 2] * torch.tensor(1.0 / S, dtype=torch.float32, device=dev)
    return w[:, 0], w[:, 1], inv, torch.full_like(w[:, 2], S) / w[:, 2]


def k2_equal(torch, args, tag):
    """K2 against its plain version on one recorded call: the same
    channels-last strides and the same bits in the (B, D, H, W, C) rows."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    with torch.inference_mode():
        got, want = stereo.fused_volume(*args), stereo.fused_volume_plain(*args)
        torch.cuda.synchronize()
        check(got.is_contiguous(memory_format=torch.channels_last_3d)
              and got.stride() == want.stride() and got.dtype == want.dtype,
              f"K2 {tag}: strides {got.stride()} {got.dtype}, its plain twin's "
              f"{want.stride()} {want.dtype}")
        rows, plain = got.permute(0, 2, 3, 4, 1), want.permute(0, 2, 3, 4, 1)
        check(torch.equal(rows.view(bits[got.dtype]), plain.view(bits[want.dtype])),
              f"K2 {tag}: differs from the eager warp at {tuple(got.shape)} {got.dtype}")


def k7_held(torch, args, tag):
    """K7 on one recorded call against the f64-accumulated convolution, as
    the card tests hold it."""
    from rgbmanip_tpu_torch.ops import prob_conv

    with torch.inference_mode():
        out = prob_conv.prob_conv3d(*args)
        torch.cuda.synchronize()
        gaps = prob_conv.reference_gaps(out, *args)
    check(gaps["held"], f"K7 {tag}: not held to the f64 reference at "
          f"{tuple(args[0].shape)}: {gaps}")
    return gaps


def against_plain(torch, dev, runs):
    """Every recorded call of every run against its plain version (K7 against
    the f64 reference), then the swept and reversed windows and K5's other
    shapes."""
    from rgbmanip_tpu_torch.ops import crop_resize as k1
    from rgbmanip_tpu_torch.ops import row_gather as k5

    for label, _, calls in runs:
        for mode in ("renormalise", "clamp"):
            for i, (args, kw) in enumerate(calls.get(mode, [])):
                k1_equal(torch, k1, args, kw, mode, f"{label} call {i}")
        for i, (args, _) in enumerate(calls.get("k2", [])):
            k2_equal(torch, args, f"{label} call {i}")
        for i, (args, _) in enumerate(calls.get("k5", [])):
            got, want = k5.row_gather(*args), k5.row_gather_plain(*args)
            check(torch.equal(got, want), f"K5 {label} call {i}: differs from plain")
        gaps = [k7_held(torch, args, f"{label} call {i}")
                for i, (args, _) in enumerate(calls.get("k7", []))]
        held = {k: len(v) for k, v in calls.items()}
        say("plain", f"{label}: every recorded call equals its plain version bit for bit "
            f"(K1 in f32 and bf16), K7's held to the f64 reference: {held}"
            + (f"; K7 {gaps}" if gaps else ""))
    S = TRAIN_CROP[0]
    rmin, cmin, inv, ratio = swept_windows(torch, dev, S)
    g = torch.Generator(device=dev).manual_seed(3)
    rgb = torch.rand(rmin.shape[0], H, W, 3, generator=g, device=dev)
    k1_equal(torch, k1, (rgb, rmin, cmin, inv), {"out_size": S}, "renormalise", "sweep")
    k1_equal(torch, k1, (rgb, rmin, cmin, ratio), {"out_size": S}, "clamp", "sweep")
    for shape, dtype in K5_EXTRA:
        B, Sk, C, D = shape
        table = torch.randn(B, Sk * Sk, C, generator=g, device=dev).to(getattr(torch, dtype))
        check(torch.equal(k5.row_gather(table, D), k5.row_gather_plain(table, D)),
              f"K5 {shape} {dtype}: differs from plain")
    say("plain", f"K1 both border modes, f32 and bf16, on {rmin.shape[0]} swept windows "
        f"(sides 40-440 px centred, at the edges and corners, and a reversed window of "
        f"side -440) at {S} px; K5 at {[s for s, _ in K5_EXTRA]}: bit for bit")


# ------------------------------------------------------------- timings ----
def k1_grid(torch, rmin, cmin, step):
    """``F.grid_sample``'s grid (align_corners=False) of output row/column i
    at source rmin/cmin + (i + 0.5) * step - 0.5."""
    S = step.shape[1]
    sy, sx = rmin[:, None] + step - 0.5, cmin[:, None] + step - 0.5
    gy, gx = (sy + 0.5) / H * 2 - 1, (sx + 0.5) / W * 2 - 1
    B = rmin.shape[0]
    return torch.stack([gx[:, None, :].expand(B, S, S), gy[:, :, None].expand(B, S, S)],
                       dim=-1).contiguous()


def k1_row(torch, mode, bf16, args, kw):
    """(calls {"kernel", "plain", "library"}, bound ms, bound_by, shape) of
    K1 on one recorded call."""
    import torch.nn.functional as F

    from portbench.counts import k1 as count
    from portbench.counts.peaks import FLOPS_PER_S, HBM_BYTES_PER_S
    from rgbmanip_tpu_torch.ops import crop_resize as k1

    rgb, rmin, cmin, scale = args
    S = int(kw["out_size"])
    dt = torch.bfloat16 if bf16 else torch.float32
    ii = torch.arange(S, dtype=torch.float32, device=rgb.device)[None] + 0.5
    if mode == "renormalise":
        wrap, plain, inv, step = (k1.crop_resize_normalize, k1.crop_resize_normalize_plain,
                                  scale, ii * scale[:, None])
    else:   # the clamping mode takes the ratio; the bytes are counted on its inverse
        wrap, plain, inv, step = (k1.crop_resize_normalize_clamp,
                                  k1.crop_resize_normalize_clamp_plain, 1.0 / scale,
                                  ii / scale[:, None])
    grid = k1_grid(torch, rmin, cmin, step)
    calls = {"kernel": lambda: wrap(rgb, rmin, cmin, scale, S, out_dtype=dt),
             "plain": lambda: plain(rgb, rmin, cmin, scale, S, out_dtype=dt),
             "library": lambda: F.grid_sample(rgb.permute(0, 3, 1, 2), grid, mode="bilinear",
                                              padding_mode="border", align_corners=False)}
    nbytes = count.crop_bytes(rmin, cmin, inv, S, H, W, 2 if bf16 else 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rmin.shape[0] * S * S * 3 * count.OPS_PER_VALUE / FLOPS_PER_S["float32"] * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return calls, *bound, [int(rgb.shape[0]), H, W, S]


def k2_row(torch, calls_k2):
    """The same for K2 on a run's two recorded calls (one a direction); its
    times are a launch's."""
    import torch.nn.functional as F

    from portbench.counts import k2 as count
    from portbench.counts.peaks import HBM_BYTES_PER_S
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    args = [a for a, _ in calls_k2]
    src, _, src_proj, ref_proj, depth = args[0]
    B, Hf, Wf, C = src.shape
    D = depth.shape[1]
    rot, trans = stereo._relative_projection(src_proj, ref_proj)
    px, py, _ = stereo._project(rot, trans, stereo._pixel_rays(Hf, Wf, src.device), depth,
                                Hf, Wf)
    grid = torch.stack([px / (Wf - 1) * 2 - 1, py / (Hf - 1) * 2 - 1], dim=-1)
    grid = grid.reshape(B, D * Hf, Wf, 2).to(src.dtype)
    n = len(args)

    def each(fn):
        return lambda: [fn(*a) for a in args]
    calls = {"kernel": each(stereo.fused_volume), "plain": each(stereo.fused_volume_plain),
             "library": lambda: [F.grid_sample(a[0].permute(0, 3, 1, 2), grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=True)
                                 for a in args]}
    bound = count.launch_bytes(B, C, D, Hf, Wf, src.element_size()) / HBM_BYTES_PER_S * 1e3
    return calls, bound, "bytes", [B, C, D, Hf, Wf], n


def k5_row(torch, args):
    from portbench.counts.peaks import HBM_BYTES_PER_S
    from rgbmanip_tpu_torch.ops import row_gather as k5
    from rgbmanip_tpu_torch.scripts import try_gather

    table, D = args
    B, HW, C = table.shape
    S = int(round(HW ** 0.5))
    index = try_gather.flat_gather_index(B, HW, D, table.device)
    calls = {"kernel": lambda: k5.row_gather(table, D),
             "plain": lambda: k5.row_gather_plain(table, D),
             "library": lambda: try_gather.index_select_reference(table, D, index)}
    bound_bytes, _ = try_gather.traffic(B, S, C, D, table.element_size())
    return calls, bound_bytes / HBM_BYTES_PER_S * 1e3, "bytes", [B, S, C, D]


def k7_row(torch, args):
    """The same for K7 on one recorded call. Its bound: the volume read once
    and the output written once."""
    import torch.nn.functional as F

    from portbench.counts.peaks import HBM_BYTES_PER_S
    from rgbmanip_tpu_torch.ops import prob_conv

    x, w = args
    B, C, D, H, W = x.shape
    wb = w.to(torch.bfloat16)
    calls = {"kernel": lambda: prob_conv.prob_conv3d(x, w),
             "plain": lambda: prob_conv.prob_conv3d_plain(x, w),
             "library": lambda: F.conv3d(x, wb, None, 1, 1)}
    n = B * D * H * W
    bound = n * (C + 1) * x.element_size() / HBM_BYTES_PER_S * 1e3
    return calls, bound, "bytes", [B, C, D, H, W]


KERNEL_NAMES = {"renormalise": "crop_resize_normalize_kernel",
                "clamp": "crop_resize_normalize_kernel", "k2": "plane_sweep_fuse",
                "k5": "row_gather_kernel", "k7": "prob_conv3d_kernel"}


def timings(torch, runs, card):
    """One entry of the kernels line per row of ``ROWS``, then K7's on each
    run of ``K7_TIMED_ON``."""
    with torch.inference_mode():
        rows = [row_timing(torch, runs, card, *row) for row in ROWS]
        return rows + [row_timing(torch, runs, card, "prob_conv3d_bf16", "k7", True, K7_SRC,
                                  label) for label in K7_TIMED_ON]


def row_timing(torch, runs, card, name, kind, bf16, src, timed_on=None):
    total = sum(n[name] for _, n, _ in runs)
    # the run ``timed_on``, else the first run that launched this row, else
    # (the clamping bf16 entry point, which no path runs) the first that
    # launched its f32 twin
    pick = ([r for r in runs if r[0] == timed_on] or [r for r in runs if r[1][name]]
            or [r for r in runs if r[2].get(kind)])
    label, _, calls = pick[0]
    per, err = 1, 0.0
    if kind == "k7":
        fns, bound, bound_by, shape = k7_row(torch, calls["k7"][0][0])
        # against the f64 reference, where the other rows equal their plain version
        err = k7_held(torch, calls["k7"][0][0], label)["max_err"]
    elif kind == "k2":
        own = [c for c in calls["k2"]
               if (c[0][0].dtype == torch.bfloat16) == bf16]
        fns, bound, bound_by, shape, per = k2_row(torch, own)
    elif kind == "k5":
        fns, bound, bound_by, shape = k5_row(torch, calls["k5"][0][0])
    else:
        args, kw = calls[kind][0]
        fns, bound, bound_by, shape = k1_row(torch, kind, bf16, args, kw)
    times = {k: device_times(torch, fn, n=5 if kind in ("k2", "k7") else 20)
             for k, fn in fns.items()}
    kern = {k: v for k, v in times["kernel"].items() if KERNEL_NAMES[kind] in k}
    check(len(kern) == 1, f"{name}: the profiler did not see the kernel: {sorted(times['kernel'])}")
    ms = {"kernel": sum(kern.values()) / per, "plain": sum(times["plain"].values()) / per,
          "library": sum(times["library"].values()) / per}
    say("time", f"{card} | {name} on {label}'s call, shape {shape}: {ms['kernel']:.4f} ms a "
        f"launch ({bound / ms['kernel'] * 100:.1f}% of the {bound:.4f} ms {bound_by} bound), "
        f"plain {ms['plain']:.4f} ms, library {ms['library']:.4f} ms")
    return {"name": name, "route": "cuda", "source": src[0], "replaces": src[1],
            "launches": total, "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"],
            "shape": shape, "timed_on": label}


# ----------------------------------------------------------------- main ----
def run():
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, REPO)
    try:
        from rgbmanip_tpu_torch.ops import _build
        from rgbmanip_tpu_torch.scripts.perfutil import card_line
    except ImportError as e:
        raise SmokeError(f"the port is not next to this script ({e})")

    # 1. card
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("card", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | TF32 off")

    # 2. build
    kernels = ["crop_resize_normalize", "row_gather", "plane_sweep_fuse", "prob_conv3d"]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    say("build", f"{len(kernels)} kernels built with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in _build.PTXAS_REPORTS.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    # 3. the main path's runs, 4. each kernel against its plain version, 5. timings
    runs = path_runs(torch, dev)
    against_plain(torch, dev, runs)
    return card, {"kernels": timings(torch, runs, card)}


def main():
    t0 = time.perf_counter()
    try:
        card, kernels_line = run()
    except SmokeError as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
    import torch
    say("done", f"every kernel held and timed in {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
