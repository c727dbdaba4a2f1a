"""Batched pose estimates: a closed loop of ``AdaPoseEstimator.estimate_full``
at the cell's batch, on view pairs made on the device from the seed.

Traffic (the workload file): ``batch`` view pairs a call, a pool of
``pool`` distinct batches cycled. Each pair's geometry is a row of the view
table ``traffic/<views>.json``, which records what the flagship evaluation
hands its estimator (``capture_views.py``): both views' mask windows, taken
as the masks' bounding rectangles, camera extrinsics and intrinsics. The rows are drawn once from the traffic's ``traffic_seed``, and
``--seed`` deals them to the batches in another order with its own 640 x
480 noise RGB, so that every seed does the same work. The point-sampling
draws come from a generator the benchmark seeds before each call.

Correctness: once the window has closed and the program is freed, the
configuration's reference (``harness.reference``: ``reference/v5.py`` unless
its ``"reference"`` key names another generation's) recomputes
``check_calls`` calls drawn from the seed on the same inputs and draws, in
float32, and ``compare`` holds the program's outputs to it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness as H
from portbench.counts import flops, k1
from portbench.reference import net as RN
from portbench.reference import weights as RW

H_IMG, W_IMG = 480, 640
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the configuration file's keys that are the estimator's knobs
KNOBS = ("name", "task_name", "img_size", "n_pts", "use_depth", "direct_regression",
         "real_world", "backend", "backbone_stride", "volume_scale", "n_depth", "d_min",
         "d_interval", "warp_mode")


def knobs(cfg):
    """The estimator's knobs, with ``arch`` where the configuration names the
    network (without it the program builds the v3-v5 network)."""
    e = {k: cfg[k] for k in KNOBS}
    if "arch" in cfg:
        e["arch"] = cfg["arch"]
    return e


def _masks(win, device):
    """(B, H, W) rectangles of inclusive windows ``win`` (B, 4): y0, x0, y1, x1."""
    w = torch.as_tensor(win, device=device)[:, :, None, None]
    rows = torch.arange(H_IMG, device=device)[None, :, None]
    cols = torch.arange(W_IMG, device=device)[None, None, :]
    return (rows >= w[:, 0]) & (rows <= w[:, 2]) & (cols >= w[:, 1]) & (cols <= w[:, 3])


def _pairs(wl):
    """The traffic's ``pool`` x ``batch`` view pairs, rows of its view table
    drawn with its fixed ``traffic_seed`` (without replacement while the
    table holds enough): windows (n, 2, 4), extrinsics (n, 2, 4, 4) and
    intrinsics (n, 3, 3). A row with an empty mask is left out: the
    evaluation had no view of the part there, and its zero matrices are no
    geometry."""
    t = H.load_json(H.HERE, "traffic", f"{wl['views']}.json")
    if list(t["image"]) != [H_IMG, W_IMG]:
        raise ValueError(f"the view table's image is {t['image']}, not {[H_IMG, W_IMG]}")
    n = int(wl["pool"]) * int(wl["batch"])
    rows = [r for r in t["pairs"] if r["win1"] and r["win2"]]
    idx = np.random.default_rng(int(wl["traffic_seed"])).choice(
        len(rows), size=n, replace=n > len(rows))
    win = np.array([[rows[i]["win1"], rows[i]["win2"]] for i in idx])
    ext = np.array([[rows[i]["ext1"], rows[i]["ext2"]] for i in idx]).reshape(n, 2, 4, 4)
    K = np.array([rows[i]["K"] for i in idx]).reshape(n, 3, 3)
    return win, ext, K


def inputs(wl, seed, device):
    """The pool of ``wl["pool"]`` input batches for ``seed``: dicts of K,
    rgb1, mask1, ext1, rgb2, mask2, ext2 on ``device``. Every seed gets the
    traffic's same view pairs (``_pairs``) in another order, with its own
    noise RGB."""
    B, P = int(wl["batch"]), int(wl["pool"])
    win, ext, K = _pairs(wl)
    order = np.random.default_rng(H.derive(seed, 2)).permutation(P * B)
    g = torch.Generator(device=device).manual_seed(H.derive(seed, 1))
    out = []
    for p in range(P):
        idx = order[p * B:(p + 1) * B]
        rgb = torch.rand(2, B, H_IMG, W_IMG, 3, generator=g, device=device)
        e = torch.tensor(ext[idx], dtype=torch.float32, device=device)
        out.append({
            "K": torch.tensor(K[idx], dtype=torch.float32, device=device),
            "rgb1": rgb[0], "mask1": _masks(win[idx, 0], device), "ext1": e[:, 0].contiguous(),
            "rgb2": rgb[1], "mask2": _masks(win[idx, 1], device), "ext2": e[:, 1].contiguous()})
    return out


def reference_net(cfg, seed, device):
    """The configuration's reference network with the cell's weights: the
    checkpoint read by the reference's own reader, or drawn from the seed."""
    net = H.reference(cfg).network(cfg).eval()
    if "checkpoint" in cfg["weights"]:
        state = RW.net_state(RW.read_checkpoint(f"{H.ROOT}/{cfg['weights']['checkpoint']}"), net)
    else:
        state = RW.seeded_state(net, H.derive(seed, 3), device)
    net.load_state_dict(state, strict=False)
    return net.to(device)


def program(cfg, dtype, seed, device):
    """The program's estimator for the cell: ``AdaPoseEstimator`` built from
    the configuration's knobs, on the checkpoint or on the seeded weights."""
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    e = knobs(cfg)
    if "checkpoint" in cfg["weights"]:
        e.update(load=True, checkpoint_path=cfg["weights"]["checkpoint"])
        return AdaPoseEstimator(e, device=device, dtype=dtype)
    e.update(load=False)
    est = AdaPoseEstimator(e, device=device, dtype=dtype)
    state = reference_net(cfg, seed, device).state_dict()
    missing, unexpected = est.model.load_state_dict(state, strict=False)
    if unexpected or [k for k in missing if not k.endswith("num_batches_tracked")]:
        raise RuntimeError(f"seeded weights do not fit the program: {missing} {unexpected}")
    return est


def draws(cfg, B, draw_seed, device):
    """The point-sampling draws of one call, as the estimate consumes them
    from a generator seeded with ``draw_seed``: view 1's (B, S*S), then
    view 2's."""
    S = int(cfg["img_size"])
    g = torch.Generator(device=device).manual_seed(draw_seed)
    return (torch.rand((B, S * S), generator=g, device=device),
            torch.rand((B, S * S), generator=g, device=device))


def call(est, x):
    return est.estimate_full(x["K"], x["rgb1"], x["mask1"], x["ext1"], x["rgb2"],
                             x["mask2"], x["ext2"])


def reference_outputs(net, cfg, x, u1, u2, quant=None):
    with torch.no_grad(), RN.quantize(net, quant):
        r = H.reference(cfg).estimate(net, cfg, x["K"], x["rgb1"], x["mask1"], x["ext1"],
                                      x["rgb2"], x["mask2"], x["ext2"], u1, u2)
    return {k: v.cpu().numpy() for k, v in r.items()}


def gaps(prog, ref):
    """Per view pair: the largest gap of a bbox corner coordinate between the
    two sides, over the reference box's largest corner offset from its
    centre. An invalid pair's answer is the sentinel box, so a pair valid on
    one side only reads a gap of about 20 or more."""
    pb, rb = prog["bbox"].astype(np.float64), ref["bbox"].astype(np.float64)
    size = np.abs(rb - rb.mean(1, keepdims=True)).reshape(len(rb), -1).max(1)
    return np.abs(pb - rb).reshape(len(rb), -1).max(1) / np.maximum(size, 1e-12)


def compare(pairs, yard=None):
    """The numbers that decide ``correct`` (the workload file's ``limits``
    names which), from (program, reference) output pairs: the median, the
    90th percentile and the widest relative bbox gap over every view pair,
    and the pairs whose ``valid`` flag differs. With ``yard``, (reference
    with bf16 operands, reference) pairs of the same calls, also the median
    gap over the yard's median gap (the program's gap in units of what bf16
    rounding alone costs this network on these inputs), and the widest of a
    pair's gap over that pair's yard gap, floored at the yard's median: one
    pair answered wrong stands out of it."""
    rel = np.concatenate([gaps(p, r) for p, r in pairs])
    out = {"bbox_gap_p50": float(np.median(rel)), "bbox_gap_p90": float(np.quantile(rel, 0.9)),
           "bbox_gap_max": float(rel.max()),
           "valid_mismatch": float(sum(int((np.asarray(p["valid"]) != np.asarray(r["valid"]))
                                           .sum()) for p, r in pairs))}
    if yard is not None:
        ygap = np.concatenate([gaps(p, r) for p, r in yard])
        unit = max(float(np.median(ygap)), 1e-30)
        out["bbox_gap_p50_ratio"] = float(np.median(rel) / unit)
        out["bbox_gap_pair_ratio"] = float((rel / np.maximum(ygap, unit)).max())
    return out


def checks(numbers, limits):
    return [(k, numbers[k], limits[k], bool(numbers[k] <= limits[k])) for k in limits]


def run(run, t0):
    cfg, wl, dev = run.cfg, run.wl, run.device
    dtype = DTYPES[wl["dtype"]]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B = int(wl["batch"])
    pool = inputs(wl, run.seed, dev)
    est = program(cfg, dtype, run.seed, dev)
    draw_base = H.derive(run.seed, 4)
    gen = torch.Generator(device=dev)
    est.generator = gen
    for i in range(int(wl["warmup_calls"])):
        gen.manual_seed(draw_base + 2 ** 40 + i)
        call(est, pool[i % len(pool)])
    run.tracer.prime(lambda: call(est, pool[0]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    crop_work = [k1.estimate_bytes(x, int(cfg["img_size"]), dtype) for x in pool]
    outputs, lat = [], []
    traced_bytes = traced_ops = 0
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    deadline = start + run.seconds
    k = 0
    while time.perf_counter() < deadline:
        run.tracer.tick()
        traced = run.tracer.active
        gen.manual_seed(draw_base + k)
        x = pool[k % len(pool)]
        with H.span("estimate_full"):
            t = time.perf_counter()
            outputs.append(call(est, x))
            lat.append(time.perf_counter() - t)
        if traced:
            traced_bytes += crop_work[k % len(pool)][0]
            traced_ops += crop_work[k % len(pool)][1]
        k += 1
    end = time.perf_counter()
    run.tracer.tick(last=True)
    run.window_s = end - start - run.tracer.paused
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.counts.update(estimates=k * B, traced_k1_bytes=traced_bytes, traced_k1_ops=traced_ops,
                      flops=k * flops.estimate_flops(cfg, B), dtype=wl["dtype"])
    del est
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng(H.derive(run.seed, 5))
    picked = sorted(rng.choice(k, size=min(int(wl["check_calls"]), k), replace=False))
    net = reference_net(cfg, run.seed, dev)
    pairs, yard = [], []
    for i in picked:
        u1, u2 = draws(cfg, B, draw_base + int(i), dev)
        x = pool[i % len(pool)]
        ref = reference_outputs(net, cfg, x, u1, u2)
        pairs.append((outputs[i], ref))
        if any(name.endswith("_ratio") for name in wl["limits"]):
            yard.append((reference_outputs(net, cfg, x, u1, u2, bf16), ref))
    numbers = compare(pairs, yard or None)
    return {"e2e": {"estimates_per_s": k * B / run.window_s,
                    "estimate_p95_ms": H.quantile(lat, 0.95) * 1e3,
                    "setup_s": setup_s},
            "attempted": k * B, "failed": 0, "peak": peak,
            "checks": checks(numbers, wl["limits"])}


def bf16(x):
    """bf16 rounding of an f32 tensor (to nearest even)."""
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x):
    """Per-tensor scaled float8 (e4m3) rounding of an f32 tensor: the
    control's precision, one step below bf16."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def tf32(x):
    """TF32 rounding of an f32 tensor (10 mantissa bits, to nearest even):
    what a TF32 tensor-core product reads of its operands."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


CONTROLS = {"bfloat16": fp8, "float32": tf32}


def readings(cfg, wl, seed, device, calls=None):
    """The numbers compared for one seed, for the program (its timed entry on
    ``calls`` calls drawn as a run draws them) and for the control (the
    reference in the precision one step below the cell's, in the program's
    place), each against the float32 reference."""
    dtype = DTYPES[wl["dtype"]]
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B = int(wl["batch"])
    pool = inputs(wl, seed, device)
    est = program(cfg, dtype, seed, device)
    draw_base = H.derive(seed, 4)
    calls = int(calls or wl["check_calls"])
    est.generator = torch.Generator(device=device)
    outs = []
    for k in range(calls):
        est.generator.manual_seed(draw_base + k)
        outs.append(call(est, pool[k % len(pool)]))
    del est
    gc.collect()
    net = reference_net(cfg, seed, device)
    prog, ctrl, yard = [], [], []
    for k in range(calls):
        u1, u2 = draws(cfg, B, draw_base + k, device)
        x = pool[k % len(pool)]
        ref = reference_outputs(net, cfg, x, u1, u2)
        prog.append((outs[k], ref))
        ctrl.append((reference_outputs(net, cfg, x, u1, u2, CONTROLS[wl["dtype"]]), ref))
        yard.append((reference_outputs(net, cfg, x, u1, u2, bf16), ref))
    return {"program": compare(prog, yard), "control": compare(ctrl, yard)}
