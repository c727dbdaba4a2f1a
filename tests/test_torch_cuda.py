"""The port on the card: the CUDA kernels against their plain PyTorch
versions, and every path that runs the estimator or the policy on the card
against the same path on the CPU: the estimates (flagship, paper size,
bf16, every generation), the service loop, the flagship evaluation round,
the heuristic rounds, both trainers through their ``main``, the RL skill,
the URDF fixtures, the real-world env, ``graft_entry``, the sweep, the
diagnostics and the timing scripts.

These tests need an NVIDIA card and skip without one (a CUDA kernel has no
CPU mode), but for one that holds the port's CPU bf16 path on that
machine's PyTorch and runs anywhere. The file imports neither JAX nor the
JAX package, so it runs on the machine with the card, from the repo root:
python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.algo.ppo import PPOPolicy
from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
from rgbmanip_tpu_torch.ops import crop_resize as k1
from rgbmanip_tpu_torch.ops import row_gather as k5
from rgbmanip_tpu_torch.scripts import perfutil

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, S = 480, 640, 192
# (rmin, cmin, side): centred, both frame corners, a 440 px window
WINDOWS = [(180, 260, 120), (0, 0, 40), (20, 100, 440), (440, 600, 40)]
FAST = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
POLICY = "checkpoints/ppo_rl_coadapt_model_165.ckpt"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def window(dev):
    w = torch.tensor(WINDOWS, dtype=torch.float32, device=dev)
    return w[:, 0], w[:, 1], w[:, 2] * torch.tensor(1.0 / S, device=dev)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_plain(cuda, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    rgb = torch.rand(len(WINDOWS), H, W, 3, generator=g, device=cuda)
    win = window(cuda)
    before = k1.crop_resize_normalize.launches
    out = k1.crop_resize_normalize(rgb, *win, S, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert k1.crop_resize_normalize.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (len(WINDOWS), S, S, 3)
    ref = k1.crop_resize_normalize_plain(rgb, *win, S)
    if out_dtype == torch.float32:
        # the same taps and weights, rounded at the same places
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        # the kernel rounds its f32 result once: within one bf16 ulp
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
        assert ((out.float() - ref).abs() <= ulp).all()


def test_k1_kernel_rejects_a_strided_frame(cuda):
    rgb = torch.zeros(1, W, H, 3, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        k1.crop_resize_normalize(rgb, *[t[:1] for t in window(cuda)], S)


def sweep_windows(S):
    """(rmin, cmin, side) windows for the kernel-vs-plain sweep: every 40 px
    side from 40 to 440, each centred and at each of the four frame corners
    (so at all four borders), and two reversed windows (a negative side): the
    one an empty mask gives, and one that runs past the top-left corner."""
    wins = []
    for side in range(40, 441, 40):
        wins += [((H - side) // 2, (W - side) // 2, side), (0, 0, side), (0, W - side, side),
                 (H - side, 0, side), (H - side, W - side, side)]
    return wins + [(460, 540, -440), (30, 20, -120)]


def batches(windows, B, dev):
    """The windows in batches of B (the last one filled up from the start),
    as (rmin, cmin, inv_ratio) with inv_ratio = side * f32(1 / S), as
    ``prepare_model_input`` computes it."""
    wins = list(windows)
    wins += wins[:(-len(wins)) % B]
    for i in range(0, len(wins), B):
        w = torch.tensor(wins[i:i + B], dtype=torch.float32, device=dev)
        yield w[:, 0], w[:, 1], w[:, 2]


def k1_windows(mask, size):
    """The (rmin, cmin, inv_ratio) windows ``prepare_model_input`` hands K1
    for (B, H, W) masks."""
    from rgbmanip_tpu_torch.ops.preprocess import mask_bbox_batched, square_window_batched

    y1, x1, y2, x2, _ = mask_bbox_batched(mask.float())
    rmin, rmax, cmin, _ = square_window_batched(y1, x1, y2, x2, H, W)
    inv = (rmax - rmin).float() * torch.tensor(1.0 / size, device=mask.device)
    return rmin.float(), cmin.float(), inv


def assert_k1_equals_plain_on(calls, size, dev):
    """K1 bit for bit against its plain version on both views' windows of
    each recorded estimate (its (K, rgb1, mask1, ext1, rgb2, mask2, ext2)
    as numpy arrays)."""
    for args in calls:
        for rgb, mask in ((args[1], args[2]), (args[4], args[5])):
            rgb = torch.as_tensor(np.asarray(rgb), dtype=torch.float32, device=dev)
            win = k1_windows(torch.as_tensor(np.asarray(mask), device=dev), size)
            out = k1.crop_resize_normalize(rgb, *win, size)
            assert torch.equal(out, k1.crop_resize_normalize_plain(rgb, *win, size))


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("S_out", [64, 192, 224, 65])
def test_k1_kernel_equals_plain_over_the_window_sweep(cuda, S_out, B):
    """f32 bit for bit (the same operations, rounded at the same places);
    bf16 bit for bit ``plain(...).to(bf16)``: the kernel rounds its f32
    result once, to nearest even. S = 65 makes a row of S * 3 values that is
    not a whole number of 4-value vectors."""
    g = torch.Generator(device=cuda).manual_seed(S_out + B)
    rgb = torch.rand(B, H, W, 3, generator=g, device=cuda)
    scale = torch.tensor(1.0 / S_out, dtype=torch.float32, device=cuda)
    for rmin, cmin, side in batches(sweep_windows(S_out), B, cuda):
        win = (rmin, cmin, side * scale)
        before = k1.crop_resize_normalize.launches
        out = k1.crop_resize_normalize(rgb, *win, S_out)
        out16 = k1.crop_resize_normalize(rgb, *win, S_out, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert k1.crop_resize_normalize.launches == before + 2
        ref = k1.crop_resize_normalize_plain(rgb, *win, S_out)
        assert out.shape == ref.shape == (B, S_out, S_out, 3)
        bad = (out != ref).any(-1).nonzero()
        assert bad.numel() == 0, f"S={S_out} B={B}: first (b, y, x) differing {bad[:4].tolist()}"
        assert torch.equal(out16, ref.to(torch.bfloat16))


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("S_out", [64, 192, 224, 65])
def test_k1_clamp_kernel_equals_plain_over_the_window_sweep(cuda, S_out, B):
    """K1's clamping mode (the estimator trainer's crop) over the same
    windows, with ratio = S / side as ``prepare_model_input`` computes it:
    f32 and bf16 bit for bit against its plain version (the plain version's
    fused multiply-adds are rounded once, as the kernel's)."""
    g = torch.Generator(device=cuda).manual_seed(S_out + B + 1)
    rgb = torch.rand(B, H, W, 3, generator=g, device=cuda)
    for rmin, cmin, side in batches(sweep_windows(S_out), B, cuda):
        win = (rmin, cmin, torch.full_like(side, S_out) / side)
        before = (k1.crop_resize_normalize_clamp.launches, k1.crop_resize_normalize.launches)
        out = k1.crop_resize_normalize_clamp(rgb, *win, S_out)
        out16 = k1.crop_resize_normalize_clamp(rgb, *win, S_out, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert (k1.crop_resize_normalize_clamp.launches,
                k1.crop_resize_normalize.launches) == (before[0] + 2, before[1])
        ref = k1.crop_resize_normalize_clamp_plain(rgb, *win, S_out)
        bad = (out != ref).any(-1).nonzero()
        assert bad.numel() == 0, f"S={S_out} B={B}: first (b, y, x) differing {bad[:4].tolist()}"
        assert torch.equal(out16, ref.to(torch.bfloat16))


def test_k1_kernel_equals_plain_on_a_frame_of_odd_width(cuda):
    """W = 642: a frame row of 1,926 floats is not a whole number of 16-byte
    vectors, so the kernel's vertical pass takes scalar loads."""
    Wo = 642
    g = torch.Generator(device=cuda).manual_seed(1)
    rgb = torch.rand(4, H, Wo, 3, generator=g, device=cuda)
    w = torch.tensor([(180, 260, 120), (0, Wo - 40, 40), (20, 100, 440), (460, 540, -440)],
                     dtype=torch.float32, device=cuda)
    win = (w[:, 0], w[:, 1], w[:, 2] * torch.tensor(1.0 / S, device=cuda))
    out = k1.crop_resize_normalize(rgb, *win, S)
    assert torch.equal(out, k1.crop_resize_normalize_plain(rgb, *win, S))
    clamp = (w[:, 0], w[:, 1], torch.full_like(w[:, 2], S) / w[:, 2])
    out = k1.crop_resize_normalize_clamp(rgb, *clamp, S)
    assert torch.equal(out, k1.crop_resize_normalize_clamp_plain(rgb, *clamp, S))


def test_k1_kernel_rejects_a_misaligned_frame(cuda):
    rgb = torch.zeros(H * W * 3 + 1, device=cuda)[1:].view(1, H, W, 3)
    assert rgb.is_contiguous() and rgb.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="aligned"):
        k1.crop_resize_normalize(rgb, *[t[:1] for t in window(cuda)], S)


def scene(B, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.1, 0.7, size=(2, B, H, W, 3)).astype(np.float32)
    mask = np.zeros((2, B, H, W), bool)
    mask[:, :, 150:300, 200:380] = True
    mask[:, 1:, :, :] = False
    mask[:, 1:, 0:80, 0:90] = True                      # corner object
    ext = np.tile(np.eye(4, dtype=np.float32), (2, B, 1, 1))
    ext[:, :, 2, 3] = 0.8
    ext[1, :, 0, 3] = 0.1
    K = np.tile(np.array([[439.3, 0, 320], [0, 439.3, 240], [0, 0, 1]], np.float32),
                (B, 1, 1))
    return K, rgb, mask, ext


def test_estimate_on_card_matches_cpu(cuda):
    cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                     {"checkpoint_path": "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"})
    gpu, cpu = AdaPoseEstimator(cfg, device=cuda), AdaPoseEstimator(cfg, device="cpu")
    B = 2
    K, rgb, mask, ext = scene(B)
    g = torch.Generator().manual_seed(1)
    u = [torch.rand(B, S * S, generator=g) for _ in range(2)]
    outs = []
    for est, d in ((gpu, cuda), (cpu, torch.device("cpu"))):
        t = [torch.from_numpy(a).to(d) for a in (K, rgb[0], mask[0], ext[0],
                                                  rgb[1], mask[1], ext[1])]
        before = k1.crop_resize_normalize.launches
        bbox, valid, _ = est._estimate(*t, u[0].to(d), u[1].to(d))
        launched = k1.crop_resize_normalize.launches - before
        assert launched == (2 if d.type == "cuda" else 0)
        outs.append((bbox.cpu().numpy(), valid.cpu().numpy()))
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    # f32 with TF32 off on both; cuDNN and the CPU sum in another order
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=1e-3)


def test_policy_on_card_matches_cpu(cuda):
    path = "checkpoints/ppo_rl_coadapt_model_165.ckpt"
    obs = np.random.default_rng(0).normal(size=(8, 60)).astype(np.float32)
    a_gpu = PPOPolicy.from_checkpoint(path, device=cuda).act_inference(obs)
    a_cpu = PPOPolicy.from_checkpoint(path, device="cpu").act_inference(obs)
    np.testing.assert_allclose(a_gpu, a_cpu, rtol=0, atol=1e-5)


def test_service_loop_on_card(cuda):
    """The estimate/policy/fuse service on the card at the evaluation's B=8
    for 4 steps: the committed policy's action moves each step's second
    camera, the flagship estimate (K1 exactly twice a step) turns each view
    pair into a bbox and ``consensus_fuse`` merges the steps; every output
    finite. The first step's estimate again on the CPU with the same point
    draws: equal valid flags, the bbox within 1e-3 m."""
    from rgbmanip_tpu_torch.models.controller.rl_pose import consensus_fuse

    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": FAST})
    rl = load_group("controller", "rl")
    est = AdaPoseEstimator(cfg, device=cuda)
    policy = PPOPolicy.from_checkpoint(POLICY, rl["policy"], device=cuda)
    B, steps, M = 8, 4, int(rl["controller"]["max_steps"]) + 1
    obs = np.random.default_rng(11).normal(size=(B, 60)).astype(np.float32)
    pred = np.zeros((M, B, 8, 3), np.float32)
    dist = np.zeros((M, B), np.float32)
    before = k1.crop_resize_normalize.launches
    for t in range(1, steps + 1):
        obs[:, -M:] = 0.0
        obs[:, -M + t - 1] = 1.0
        actions = policy.act_inference(obs)
        K, rgb, mask, ext = scene(B, seed=t)
        ext[1, :, :3, 3] += 0.1 * np.tanh(actions[:, :3])
        args = (K, rgb[0], mask[0], ext[0], rgb[1], mask[1], ext[1])
        if t == 1:
            first = args
        pred[t] = est.estimate_full(*args)["bbox"]
        dist[t] = np.linalg.norm(ext[0, :, :3, 3] - ext[1, :, :3, 3], axis=-1)
        obs[:, :6] = actions[:, :6]       # the next observation carries the action
    fused = consensus_fuse(pred, steps, stereo_ok=dist >= 0.04)
    assert k1.crop_resize_normalize.launches - before == 2 * steps
    assert np.isfinite(pred[1:]).all() and np.isfinite(fused).all() and fused.shape == (B, 8, 3)
    assert actions.shape == (B, 12) and np.isfinite(actions).all()

    g = torch.Generator().manual_seed(5)
    u = [torch.rand(B, S * S, generator=g) for _ in range(2)]
    out = {}
    for name, e in (("card", est), ("cpu", AdaPoseEstimator(cfg, device="cpu"))):
        bbox, valid, _ = e._estimate(*(torch.from_numpy(a).to(e.device) for a in first),
                                     *(x.to(e.device) for x in u))
        out[name] = (bbox.cpu().numpy(), valid.cpu().numpy())
    np.testing.assert_array_equal(out["card"][1], out["cpu"][1])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape,dtype", [((16, 112, 32, 24), torch.bfloat16),
                                         ((1, 640, 8, 2), torch.bfloat16),
                                         ((16, 112, 32, 24), torch.float32)],
                         ids=["probe-bf16", "int32-overflow", "probe-f32"])
def test_k5_kernel_matches_plain(cuda, shape, dtype):
    """Bit for bit: a gather rounds nothing. (1, 640, 8, 2) wraps the index
    arithmetic around int32."""
    B, S_, C, D = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn(B, S_ * S_, C, generator=g, device=cuda).to(dtype)
    before = k5.row_gather.launches
    out = k5.row_gather(table, D)
    torch.cuda.synchronize()
    assert k5.row_gather.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, D, S_ * S_, C)
    assert torch.equal(out, k5.row_gather_plain(table, D))


def test_k5_kernel_rejects_a_misaligned_table(cuda):
    table = torch.zeros(2 * 64 * 8 + 1, device=cuda)[1:].view(2, 64, 8)
    with pytest.raises(ValueError, match="aligned"):
        k5.row_gather(table, 2)


def test_bench_times_on_the_card(cuda):
    table = torch.randn(2, 64, 32, device=cuda).to(torch.bfloat16)
    ms = perfutil.bench(k5.row_gather, table, 3, iters=3, reps=2)
    assert 0.0 < ms < 1e3


def test_paper_estimate_on_card_matches_cpu(cuda):
    """adapose_cabinet (resnet34 at stride 8, 224 px, 112x112x24 volume) on
    weights made from one seed on both sides."""
    cfg = load_group("pose_estimator", "adapose_cabinet")
    gpu, cpu = AdaPoseEstimator(cfg, device=cuda), AdaPoseEstimator(cfg, device="cpu")
    B, Sp = 2, int(cfg["img_size"])
    K, rgb, mask, ext = scene(B, seed=3)
    g = torch.Generator().manual_seed(2)
    u = [torch.rand(B, Sp * Sp, generator=g) for _ in range(2)]
    m = gpu.model
    assert (m.backend, m.backbone_stride, m.volume_scale, m.warp_mode, gpu.n_depth,
            gpu.n_pts) == ("resnet34", 8, 2, "nearest", 24, 1024)
    outs = []
    for est, d in ((gpu, cuda), (cpu, torch.device("cpu"))):
        t = [torch.from_numpy(a).to(d) for a in (K, rgb[0], mask[0], ext[0],
                                                  rgb[1], mask[1], ext[1])]
        before = k1.crop_resize_normalize.launches
        bbox, valid, _ = est._estimate(*t, u[0].to(d), u[1].to(d))
        assert k1.crop_resize_normalize.launches - before == (2 if d.type == "cuda" else 0)
        outs.append((bbox.cpu().numpy(), valid.cpu().numpy()))
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[1][1].any(), "no valid estimate: the comparison would be of sentinels"
    # f32 with TF32 off on both; cuDNN and the CPU sum in another order
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=1e-3)


def test_k1_kernel_equals_plain_on_rendered_views(cuda):
    """K1 on the simulator's frames: one reset of ``OpenCabinetEnv`` at the
    evaluation's 8 envs, the camera at ControlInterface's first view, the
    crop windows of the rendered handle masks, S=192; bit for bit."""
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.train import prepare_env
    from rgbmanip_tpu_torch.utils.transform import lookat_quat

    cfg = load_config(["dataset=cabinet_test", "controller=rl", "task.num_envs=8",
                       "seed=11"])
    env = prepare_env(cfg["task"], cfg["dataset"], seed=11)
    try:
        env.reset()
        ctrl = cfg["controller"]["controller"]
        pos = [ctrl["pose_min"][0], 0.0, (ctrl["pose_min"][2] + ctrl["pose_max"][2]) / 2]
        pose = np.tile(np.concatenate([pos, lookat_quat(np.array([1.0, 0.0, -0.2]))]), (8, 1))
        env.cam_move_to(pose, time=2, wait=1, planner="path", robot_frame=True,
                        skip_move=True)
        cam = env.get_image()["camera0"]
    finally:
        env.close()
    assert cam["Mask"].any(), "no env saw its handle"
    rgb = torch.from_numpy(cam["Color"]).to(cuda)
    win = k1_windows(torch.from_numpy(cam["Mask"]).to(cuda), S)
    out = k1.crop_resize_normalize(rgb, *win, S)
    assert torch.equal(out, k1.crop_resize_normalize_plain(rgb, *win, S))


# the flagship evaluation as scripts/r5_cabinet_evals.sh runs it, one round
FLAGSHIP = ["task=open_cabinet", "manipulation=open_cabinet", "controller=rl",
            f"controller.load={POLICY}", "pose_estimator=adapose_cabinet_fast",
            f"pose_estimator.checkpoint_path={FAST}", "controller.estimate_fusion=consensus",
            "controller.early_stop=4", "train=test", "train.total_round=8",
            "task.num_envs=8", "seed=11"]


def play_round(over, device, draws, hook=None):
    """One round through ``train``'s functions on ``device`` with the
    overrides ``over``. Each estimate takes its point-sampling draws from
    ``draws`` (made on the CPU from one seed on the first run, replayed on
    the second). ``hook(est, ctrl, rec)``, if given, installs a case's
    recording on the estimator and the controller before the round. Returns
    the record ``rec``: the estimator's ``size``, the devices of its
    parameters (``param_devices``) and of every estimate's inputs
    (``devices``), the round's ``result``, each env's ``success`` and
    ``move``, and what the hook recorded."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.utils.logger import get_logger

    cfg = load_config(over + [f"device={device.type}"])
    log = get_logger()
    gen = torch.Generator().manual_seed(11)
    rec = {"devices": set()}
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        est = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, est, manip, cfg["controller"], cfg, log,
                                    device=device)
        rec["size"] = est.img_size
        rec["param_devices"] = {p.device.type for p in est.model.parameters()}
        inner, n_est = est._estimate, []

        def drawn(*args):
            i = len(n_est)
            n_est.append(i)
            if i == len(draws):
                draws.append([torch.rand(args[1].shape[0], est.img_size ** 2, generator=gen)
                              for _ in range(2)])
            rec["devices"] |= {a.device.type for a in args[:7]}
            return inner(*args[:7], *(u.to(args[1].device) for u in draws[i]))
        est._estimate = drawn
        if hook is not None:
            hook(est, ctrl, rec)
        rec["result"] = T.test(env, ctrl, cfg, log)
        obs = env.get_observation()
        rec["success"] = np.array(obs["success"])
        rec["move"] = np.array(obs["total_move_distance"])
    finally:
        env.close()
    return rec


def flagship_hook(drive=None):
    """The flagship round's recording: each step's action, frame, mask and
    per-step bbox, the fused bbox and the estimator's arguments. With
    ``drive`` (the first run's record) the camera moves by the first run's
    actions and the skill acts on its fused bbox, while the record keeps
    this run's own: the actors' f32 actions differ in the last bits, and a
    camera moved by that much changes pixels at the rendered parts' edges."""
    def hook(est, ctrl, rec):
        rec.update(actions=[], frames=[], masks=[], pred_bbox=[], calls=[])
        rec["param_devices"] |= {p.device.type for p in ctrl.controller.model.parameters()}
        call = est._call_estimate

        def kept(*args):
            rec["calls"].append(args)      # numpy arrays made anew for each call
            return call(*args)
        est._call_estimate = kept
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
    return hook


@pytest.mark.parametrize("dataset", ["cabinet_test", "cabinet_urdf_fixture"])
def test_flagship_round_on_card_matches_cpu(cuda, dataset):
    """One round of the flagship evaluation (8 envs, seed 11, k=4,
    consensus) on the card, K1 exactly twice an estimate (its clamping mode
    and K5 never) and bit for bit its plain version on every window the
    round fed it; then on the CPU,
    lock-stepped to the card's camera moves and fused bbox with the same
    draws: the rendered frames and masks equal, the actions within 1e-5, the
    two-view estimates and the fused bbox within 1e-3 m, ``stereo_ok``,
    success and move distance equal. An estimate from one view duplicated
    is not held: the warp's in-frame test flips on the volume's border for
    identical cameras. Also on the cabinet URDF fixture."""
    over = FLAGSHIP + [f"dataset={dataset}"]
    draws = []
    counters = (k1.crop_resize_normalize, k1.crop_resize_normalize_clamp, k5.row_gather)
    before = [f.launches for f in counters]
    card = play_round(over, cuda, draws, flagship_hook())
    n_est = len(card["calls"])
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert n_est >= 1 and launched == [2 * n_est, 0, 0]
    assert card["param_devices"] == card["devices"] == {"cuda"}
    assert_k1_equals_plain_on(card["calls"], card["size"], cuda)

    cpu = play_round(over, torch.device("cpu"), draws, flagship_hook(drive=card))
    assert len(cpu["actions"]) == len(card["actions"])
    for a, b in zip(cpu["first_view"] + tuple(cpu["frames"]) + tuple(cpu["masks"]),
                    card["first_view"] + tuple(card["frames"]) + tuple(card["masks"])):
        np.testing.assert_array_equal(a, b)
    N = len(card["fused"])
    assert max(float(np.abs(a - b).max())
               for a, b in zip(cpu["actions"], card["actions"])) <= 1e-5
    dup = card["views_so_far"][1:len(card["pred_bbox"]) + 1] == 1
    gaps = np.stack([np.abs(a - b).reshape(N, -1).max(-1)
                     for a, b in zip(cpu["pred_bbox"], card["pred_bbox"])])
    assert gaps[~dup].max(initial=0.0) <= 1e-3
    assert float(np.abs(cpu["fused"] - card["fused"]).max()) <= 1e-3
    for k in ("stereo_ok", "success", "move"):
        np.testing.assert_array_equal(cpu[k], card[k], err_msg=k)


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
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "crop_resize_normalize" in e.get("name", "")]
    inside = [e for e in kernels if any(a <= launch_ts.get(e["args"].get("correlation"), -1) <= b
                                        for a, b in spans)]
    return len(inside), len(kernels)


def test_the_flagship_command_under_the_profiler_launches_k1_inside_estimates(cuda, tmp_path):
    """``python -m rgbmanip_tpu_torch.train`` with the flagship evaluation's
    arguments and ``RGBMANIP_PROFILE`` set, in its own process: after a
    torch.profiler session of that length (some 10^5 device events), the
    profiler (torch 2.11) records only part of the device events of later
    sessions in the same process, and the card tests after this one profile
    too. It writes ``result.json`` of its 8 episodes, and the trace holds
    K1 launches inside the loop's ``estimate`` ranges. A profile now and
    then holds no device events: the run is made once more if the first
    trace holds no K1 kernel."""
    for attempt in range(2):
        run = tmp_path / f"run{attempt}"
        res = subprocess.run(
            [sys.executable, "-m", "rgbmanip_tpu_torch.train", *FLAGSHIP, "dataset=cabinet_test",
             "device=cuda", f"train.save_dir={run}", f"train.log_dir={run}"], cwd=REPO,
            env=dict(os.environ, RGBMANIP_PROFILE=str(run / "profile")), capture_output=True,
            text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        inside, n_k1 = k1_in_estimate_spans(run / "profile" / "trace.json")
        if n_k1:
            break
    results = [json.loads(p.read_text()) for p in run.rglob("result.json")]
    assert len(results) == 1 and results[0]["rounds"] == 8
    assert inside >= 1


def ppo_pair(cuda):
    """The committed policy with its Adam state, in a trainer on the card
    and one on the CPU, and a seeded (16, 8) batch at its own action
    distribution whose minibatches 2 and 4 carry old means shifted by 0.3
    (the adaptive rate both rises and falls)."""
    from rgbmanip_tpu_torch.algo.ppo import PPO, compute_gae
    from rgbmanip_tpu_torch.utils.tools import Box

    class Spaces:
        num_envs = 8
        observation_space = Box(-1.5, 1.5, shape=(60,))
        state_space = Box(-1.5, 1.5, shape=(75,))
        action_space = Box(-1.5, 1.5, shape=(12,))

    cfg = load_group("controller", "rl")
    pair = {}
    for d in (cuda, torch.device("cpu")):
        pair[d.type] = PPO(Spaces(), cfg, seed=0, device=d)
        pair[d.type].load("checkpoints/ppo_rl_coadapt_model_165.ckpt")
    rng = np.random.default_rng(1)
    T, N = 16, 8
    obs = torch.from_numpy(rng.uniform(-1, 1, (T, N, 60)).astype(np.float32))
    states = torch.from_numpy(rng.uniform(-1, 1, (T, N, 75)).astype(np.float32))
    with torch.no_grad():
        mean, std, value = pair["cpu"].model(obs, states)
        sigma = std.expand_as(mean).clone()
        mu = mean.clone().reshape(T * N, 12)
        mu[32:64] += 0.3
        mu[96:128] += 0.3
        mu = mu.reshape(T, N, 12)
        actions = mean + std * torch.from_numpy(rng.normal(size=(T, N, 12)).astype(np.float32))
        from rgbmanip_tpu_torch.algo.ppo import gaussian_logprob
        logprobs = gaussian_logprob(mu, sigma, actions)
        rewards = torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32))
        dones = torch.from_numpy((rng.random((T, N)) < 0.25).astype(np.float32))
        returns, advs = compute_gae(rewards, dones, value, value[-1], 0.98, 0.98)
    batch = {"obs": obs, "states": states, "actions": actions, "logprobs": logprobs,
             "values": value, "returns": returns, "advantages": advs, "mu": mu,
             "sigma": sigma}
    return pair, batch


def test_ppo_update_on_card_matches_cpu(cuda):
    """One 8x4 update from the committed checkpoint on the same batch: the
    learning rate after every minibatch equal, the parameters within 2e-5
    (actor) and 2e-4 (critic, whose values near 60 carry f32 rounding into
    its gradients) after 32 steps of up to 3e-4."""
    pair, batch = ppo_pair(cuda)
    metrics = {d: pair[d]._update({k: v.to(pair[d].device) for k, v in batch.items()})
               for d in pair}
    assert pair["cuda"].update_lrs == pair["cpu"].update_lrs
    steps = np.diff([2e-4] + pair["cpu"].update_lrs)
    assert (steps > 0).any() and (steps < 0).any()
    g, c = pair["cuda"].model.state_dict(), pair["cpu"].model.state_dict()
    for k in c:
        tol = 2e-4 if k.startswith("critic.") else 2e-5
        assert (g[k].cpu() - c[k]).abs().max().item() <= tol, k
    np.testing.assert_allclose(metrics["cuda"].cpu().numpy(), metrics["cpu"].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert pair["cuda"]._moments()[0] == pair["cpu"]._moments()[0] == 5280 + 32


def estimator_batch(device, n_envs=2, seed=7):
    """One batch of the estimator trainer's sampler at the production recipe
    (192 px, 1024 points, 16 bins of 0.15 m), ``n_envs`` envs."""
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.models.pose_estimator.data import SimViewSampler
    from rgbmanip_tpu_torch.train import prepare_env

    cfg = load_config(["dataset=cabinet_train", "task=open_cabinet",
                       f"task.num_envs={n_envs}", f"seed={seed}"])
    env = prepare_env(cfg["task"], cfg["dataset"], seed=seed)
    try:
        sampler = SimViewSampler(env, img_size=S, n_pts=1024, seed=seed, d_min=0.1,
                                 d_interval=0.15, n_depth=16, device=device)
        batch = None
        while batch is None:
            batch = sampler.sample_batch()
    finally:
        env.close()
    return batch


def test_estimator_training_step_on_card_matches_cpu(cuda):
    """One ``EstimatorTrainer`` step from the committed head on one sampled
    batch: the loss parts within 1e-4 relative, the BatchNorm running
    statistics within 1e-4, and the parameters within two learning rates
    and rounding, 2.1e-4 (Adam's first step moves each element by +-lr; an
    element with a gradient near 0 may go either way)."""
    from rgbmanip_tpu_torch.models.pose_estimator.converter import to_jax_params
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer
    from rgbmanip_tpu_torch.utils.checkpoint import flatten

    cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                     {"checkpoint_path": "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"})
    batch = estimator_batch(torch.device("cpu"))
    out = {}
    for d in (cuda, torch.device("cpu")):
        est = AdaPoseEstimator(cfg, device=d)
        total, parts = EstimatorTrainer(est.model, lr=1e-4).step(
            {k: v.to(d) for k, v in batch.items()})
        out[d.type] = (total, parts, [flatten(t) for t in to_jax_params(est.model)])
    for k in out["cpu"][1]:
        np.testing.assert_allclose(out["cuda"][1][k], out["cpu"][1][k], rtol=1e-4, err_msg=k)
    (gp, gs), (cp, cs) = out["cuda"][2], out["cpu"][2]
    for k in cs:
        np.testing.assert_allclose(gs[k], cs[k], rtol=1e-4, atol=1e-5, err_msg="/".join(k))
        assert np.abs(gs[k] - cs[k]).max() <= 1e-4 * (np.abs(cs[k]).max() + 1e-6), k
    assert max(float(np.abs(gp[k] - cp[k]).max()) for k in cp) <= 2.1e-4


def test_k1_equals_plain_on_the_samplers_windows(cuda):
    """The estimator trainer's sampler on the card: K1's clamping mode (the
    JAX trainer's border rule) launched twice per batch and the
    renormalising mode not at all, bit for bit against its plain version on
    every rendered window."""
    from rgbmanip_tpu_torch.ops import preprocess

    seen = []
    orig = preprocess.crop_resize_normalize_clamp

    def kept(rgb, rmin, cmin, ratio, out_size, out_dtype=torch.float32):
        seen.append((rgb.clone(), rmin.clone(), cmin.clone(), ratio.clone(), out_size))
        return orig(rgb, rmin, cmin, ratio, out_size, out_dtype=out_dtype)
    preprocess.crop_resize_normalize_clamp = kept
    before = (k1.crop_resize_normalize_clamp.launches, k1.crop_resize_normalize.launches)
    try:
        batch = estimator_batch(cuda, n_envs=8)
    finally:
        preprocess.crop_resize_normalize_clamp = orig
    assert k1.crop_resize_normalize_clamp.launches - before[0] == len(seen) == 2
    assert k1.crop_resize_normalize.launches == before[1]
    assert batch["img1"].device.type == "cuda" and batch["valid"].any()
    for rgb, rmin, cmin, ratio, size in seen:
        out = k1.crop_resize_normalize_clamp(rgb, rmin, cmin, ratio, size)
        assert torch.equal(out, k1.crop_resize_normalize_clamp_plain(rgb, rmin, cmin, ratio,
                                                                     size))
    assert torch.equal(batch["img1"], k1.crop_resize_normalize_clamp(*seen[0][:4], S))


def test_ppo_training_through_train_main_on_card(cuda, tmp_path, monkeypatch):
    """PPO training of the camera scheduler through ``train.main``
    (``train=controller``, 8 envs, 2 iterations of 16 transitions, resumed
    from the committed policy): on the card, K1 twice a rollout step; the
    last update again on the card and on the CPU from the same batch and
    state (the learning rate after every step equal, parameters within
    2e-5 for the actor and 2e-4 for the critic); the saved
    ``model_<it>.ckpt`` read back into a fresh trainer equal."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.algo.ppo import PPO
    from rgbmanip_tpu_torch.utils.checkpoint import flatten

    runs, updates = [], []
    run, update = PPO.run, PPO._update

    def kept_run(self, *args, **kwargs):
        runs.append(self)
        return run(self, *args, **kwargs)

    def kept_update(self, batch):
        updates.append((self.state_tree(), {k: v.detach().cpu().clone()
                                            for k, v in batch.items()}))
        return update(self, batch)
    monkeypatch.setattr(PPO, "run", kept_run)
    monkeypatch.setattr(PPO, "_update", kept_update)
    before = k1.crop_resize_normalize.launches
    T.main(["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
            "controller=rl", f"controller.load={POLICY}", "pose_estimator=adapose_cabinet_fast",
            f"pose_estimator.checkpoint_path={FAST}", "train=controller",
            "train.iterations_per_epoch=2", "task.num_envs=8", "seed=11", "device=cuda",
            f"controller.learn.save_dir={tmp_path}", f"train.save_dir={tmp_path}",
            f"train.log_dir={tmp_path}"])
    launches = k1.crop_resize_normalize.launches - before
    monkeypatch.undo()
    assert len(runs) == 1 and len(updates) == 2
    ppo = runs[0]
    assert ppo.device.type == "cuda"
    assert {p.device.type for p in ppo.model.parameters()} == {"cuda"}
    assert ppo.num_transitions == 16 and launches == 2 * 2 * ppo.num_transitions

    tree, batch = updates[-1]
    pair = {}
    for name, d in (("card", cuda), ("cpu", torch.device("cpu"))):
        pair[name] = PPO(ppo.env, ppo.cfg, seed=0, device=d)
        pair[name].load_tree(tree)
        pair[name]._update({k: v.to(d) for k, v in batch.items()})
    assert pair["card"].update_lrs == pair["cpu"].update_lrs
    g, c = pair["card"].model.state_dict(), pair["cpu"].model.state_dict()
    for k in c:
        tol = 2e-4 if k.startswith("critic.") else 2e-5
        assert (g[k].cpu() - c[k]).abs().max().item() <= tol, k

    it = ppo.current_learning_iteration
    back = PPO(ppo.env, ppo.cfg, seed=1, device=cuda)
    back.load(str(tmp_path / f"model_{it}.ckpt"))
    mine, theirs = flatten(ppo.state_tree()), flatten(back.state_tree())
    assert sorted(mine) == sorted(theirs) and back.current_learning_iteration == it
    assert all(np.array_equal(mine[k], theirs[k]) for k in mine)


def estimator_trainer_main(tmp_path, monkeypatch, dtype, steps):
    """``train_estimator.main`` at the production recipe
    (``scripts/tunnel_watch_estimator.sh:66-70``: 8 envs, reuse 8, 192 px),
    resumed from the committed head, ``steps`` steps in f32 (``bf16=0``) or
    at its default (bf16 compute, f32 parameters), saving its head. Returns
    (the trained estimator, the saved head's path, the batches its steps
    took)."""
    from rgbmanip_tpu_torch.models.pose_estimator import train_estimator as TE
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer

    taken = []
    step = EstimatorTrainer.step
    monkeypatch.setattr(EstimatorTrainer, "step",
                        lambda self, batch: taken.append(batch) or step(self, batch))
    head = str(tmp_path / "head.ckpt")
    est = TE.main(["dataset=cabinet_train", "task=open_cabinet", "task.num_envs=8", "seed=7",
                   "img_size=192", "backend=resnet18", "backbone_stride=32", "volume_scale=8",
                   "n_depth=16", "d_interval=0.15", "warp_mode=nearest", "reuse=8",
                   f"steps={steps}", f"resume={FAST}", f"save={head}",
                   f"log_dir={tmp_path / 'logs'}", "log_every=1", "device=cuda"]
                  + (["bf16=0"] if dtype == "f32" else []))
    monkeypatch.setattr(EstimatorTrainer, "step", step)
    return est, head, taken


@pytest.mark.parametrize("dtype,steps", [("f32", 5), ("bf16", 3)])
def test_estimator_trainer_main_on_card(cuda, tmp_path, monkeypatch, dtype, steps):
    """``estimator_trainer_main`` in f32 and at its default: on the card,
    every step taken, the sampler's crops K1's clamping mode twice a
    prepared batch in f32 and the renormalising mode never; the saved head
    loaded back gives the trained estimator's estimate within 1e-5 m with
    equal valid flags (both with cuDNN's deterministic algorithms)."""
    counters = (k1.crop_resize_normalize_clamp, k1.crop_resize_normalize)
    before = [(f.launches, f.launches_bf16) for f in counters]
    est, head, taken = estimator_trainer_main(tmp_path, monkeypatch, dtype, steps)
    (clamp, clamp16), (renorm, _) = [(f.launches - a, f.launches_bf16 - b)
                                     for f, (a, b) in zip(counters, before)]
    prepared = est.train_stats["counts"]["prepare"]
    assert est.train_stats["steps"] == len(taken) == steps
    assert est.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    assert est.device.type == "cuda"
    assert {(p.device.type, p.dtype) for p in est.model.parameters()} == {("cuda", torch.float32)}
    assert prepared >= steps and (clamp, clamp16, renorm) == (2 * prepared, 0, 0)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    back = AdaPoseEstimator(dict(est.cfg, load=True, checkpoint_path=head), device=cuda,
                            dtype=est.dtype)
    args = [torch.from_numpy(a).to(cuda) for a in estimate_args(8, seed=4)]
    g = torch.Generator().manual_seed(6)
    u = [torch.rand(8, S * S, generator=g).to(cuda) for _ in range(2)]
    b1, v1, _ = est._estimate(*args, *u)
    b2, v2, _ = back._estimate(*args, *u)
    assert torch.equal(v1, v2) and (b1 - b2).abs().max().item() <= 1e-5


# heuristic + AdaPose (the README's pot and mug rows, scripts/r5_chain.sh) and
# the no-fusion ablation (seeded weights), one round of 2 envs each
HEURISTIC = {
    "pot": ["dataset=pot_test", "task=open_pot", "manipulation=open_pot",
            "pose_estimator=adapose_pot_fast"],
    "mug": ["dataset=mug_test", "task=pick_mug", "manipulation=pick_mug",
            "pose_estimator=adapose_mug_fast"],
    "baseline": ["dataset=cabinet_test", "task=open_cabinet", "manipulation=open_cabinet",
                 "pose_estimator=adapose_baseline"],
}
HEURISTIC_RUN = ["controller=heuristic_pose", "train=test", "task.num_envs=2",
                 "train.total_round=2", "seed=11"]


def heuristic_hook(drive=None):
    """The heuristic round's recording: each estimate's arguments and bbox.
    With ``drive`` (the first run's record) the skill acts on the first
    run's bbox."""
    def hook(est, ctrl, rec):
        rec["calls"] = []
        estimate = est.estimate

        def recorded(*args):
            bbox = estimate(*args)
            rec["calls"].append(([np.array(a) for a in args], bbox))
            return drive["calls"][len(rec["calls"]) - 1][1] if drive else bbox
        est.estimate = recorded
    return hook


@pytest.mark.parametrize("stack", list(HEURISTIC))
def test_heuristic_pot_round_on_card_matches_cpu(cuda, stack):
    """On the pot, the mug and the no-fusion ablation (``adapose_baseline``):
    the same views bit for bit (fixed viewpoints, the host simulator), K1
    twice per estimate on the card and bit for bit its plain version on the
    round's windows, the estimate within 1e-3 m of the CPU's (f32, TF32 off;
    cuDNN and the CPU sum in another order), and the same success and move
    distance with both skills on the card's bbox."""
    over, draws = HEURISTIC[stack] + HEURISTIC_RUN, []
    before = k1.crop_resize_normalize.launches
    card = play_round(over, cuda, draws, heuristic_hook())
    launched = k1.crop_resize_normalize.launches - before
    cpu = play_round(over, torch.device("cpu"), draws, heuristic_hook(drive=card))
    assert len(card["calls"]) == len(cpu["calls"]) == 1
    assert launched == 2 == k1.crop_resize_normalize.launches - before
    assert card["param_devices"] == card["devices"] == {"cuda"}
    (args, bbox), (ref_args, ref_bbox) = card["calls"][0], cpu["calls"][0]
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a, b)
    assert_k1_equals_plain_on([args], card["size"], cuda)
    assert (np.abs(ref_bbox).max(axis=(1, 2)) < 8.0).all(), "a sentinel estimate"
    np.testing.assert_allclose(bbox, ref_bbox, rtol=0, atol=1e-3)
    assert card["result"] == cpu["result"]


@contextlib.contextmanager
def k2_recorded(calls):
    """Within: the arguments of each call the network makes to
    ``stereo.fused_volume`` (K2's entry) appended to ``calls``."""
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


def assert_k2_equals_its_twin_on(calls):
    """K2 on a path's own recorded calls against its plain twin
    (``stereo.fused_volume_plain``: the eager warp and the fusing add) in
    the U-Net's channels-last-3d layout: the same strides, and the same bits
    in the (B, D, H, W, C) rows."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    with torch.inference_mode():
        for args in calls:
            got, want = stereo.fused_volume(*args), stereo.fused_volume_plain(*args)
            assert got.is_contiguous(memory_format=torch.channels_last_3d)
            assert got.stride() == want.stride() and got.dtype == want.dtype
            assert torch.equal(got.permute(0, 2, 3, 4, 1).view(ints[got.dtype]),
                               want.permute(0, 2, 3, 4, 1).view(ints[want.dtype]))


def test_inference_batch_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``inference.main`` at its defaults (the estimator's default
    architecture on weights made from its seed) over pairs that ``train=collect`` wrote, on
    the card and on the CPU with the same point-sampling draws: K1 twice per
    batch on the card, and K2 twice (the default network warps bilinearly at
    full resolution), bit for bit its twin on its own calls; every bbox
    within 1e-3 m."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.models.pose_estimator import adapose
    from rgbmanip_tpu_torch.models.pose_estimator import inference
    from rgbmanip_tpu_torch.ops import plane_sweep as k2

    data = str(tmp_path / "pairs")
    T.main(["dataset=cabinet_train", "task=open_cabinet_no_dr", "controller=collect_pose",
            "train=collect", "task.num_envs=2", "train.total_round=2", "device=cpu",
            f"controller.learn.save_dir={data}", f"train.save_dir={tmp_path}",
            f"train.log_dir={tmp_path}"])
    bboxes = []

    class Drawn(adapose.AdaPoseEstimator):
        def _call_estimate(self, K, rgb1, mask1, ext1, rgb2, mask2, ext2):
            g = torch.Generator().manual_seed(4)
            u = [torch.rand(rgb1.shape[0], self.img_size ** 2, generator=g).to(self.device)
                 for _ in range(2)]
            t = [torch.as_tensor(a, device=self.device) for a in (K, rgb1, mask1, ext1,
                                                                  rgb2, mask2, ext2)]
            out = self._estimate(*[x.float() if x.dtype != torch.bool else x for x in t], *u)
            bboxes.append((out[0].cpu().numpy(), out[1].cpu().numpy()))
            return out
    monkeypatch.setattr(adapose, "AdaPoseEstimator", Drawn)
    out, calls = {}, []
    for d in ("cuda", "cpu"):
        before = (k1.crop_resize_normalize.launches, k2.warp_fuse.launches)
        with k2_recorded(calls if d == "cuda" else []):
            out[d] = inference.main(["--data_root", data, "--device", d])
        launched = (k1.crop_resize_normalize.launches - before[0],
                    k2.warp_fuse.launches - before[1])
        assert launched == ((2, 2) if d == "cuda" else (0, 0))
    assert out["cuda"]["n"] == out["cpu"]["n"] == 2 and len(bboxes) == 2
    assert len(calls) == 2
    assert_k2_equals_its_twin_on(calls)
    assert (np.abs(bboxes[1][0]).max(axis=(1, 2)) < 8.0).all(), "a sentinel estimate"
    np.testing.assert_array_equal(bboxes[0][1], bboxes[1][1])
    np.testing.assert_allclose(bboxes[0][0], bboxes[1][0], rtol=0, atol=1e-3)


def test_evaluate_on_card_matches_cpu(cuda, monkeypatch):
    """``evaluate`` in f32 on the card: the sampler's views reach the
    estimate as the f16 colour it keeps on the card (no host round trip), K1
    twice per round, and the stats equal the CPU's within 1e-3 m and 0.1
    degree with the same point-sampling draws."""
    from rgbmanip_tpu_torch.models.pose_estimator import adapose
    from rgbmanip_tpu_torch.models.pose_estimator.evaluate import evaluate

    seen = []

    class Drawn(adapose.AdaPoseEstimator):
        def _estimate(self, K, rgb1, mask1, ext1, rgb2, mask2, ext2, rand1, rand2):
            g = torch.Generator().manual_seed(len(seen))
            u = [torch.rand(rgb1.shape[0], self.img_size ** 2, generator=g).to(self.device)
                 for _ in range(2)]
            return super()._estimate(K, rgb1, mask1, ext1, rgb2, mask2, ext2, *u)

        def estimate_full(self, K, rgb1, mask1, ext1, rgb2, mask2, ext2):
            seen.append((rgb1.device.type, rgb1.dtype, mask1.device.type))
            return super().estimate_full(K, rgb1, mask1, ext1, rgb2, mask2, ext2)
    monkeypatch.setattr(adapose, "AdaPoseEstimator", Drawn)
    over = ["dataset=cabinet_test", "task=open_cabinet", "task.num_envs=2", "seed=5"]
    kw = dict(checkpoint="checkpoints/estimator_fast_cabinet_aug_r5.ckpt", rounds=2,
              img_size=S, n_pts=1024, dtype=torch.float32, est_overrides=dict(
                  backend="resnet18", backbone_stride=32, volume_scale=8, n_depth=16,
                  d_interval=0.15, warp_mode="nearest"))
    before = k1.crop_resize_normalize.launches
    card = evaluate(over, device=cuda, **kw)
    assert k1.crop_resize_normalize.launches - before == 4
    assert seen == [("cuda", torch.float16, "cuda")] * 2
    seen.clear()
    cpu = evaluate(over, device="cpu", **kw)
    assert card["valid_frac"] == cpu["valid_frac"] > 0
    for k, v in cpu.items():
        assert abs(card[k] - v) <= (0.1 if k.endswith("_deg") else 1e-3), (k, card[k], v)


def test_evaluate_at_its_defaults_launches_k1_bf16_on_card(cuda):
    """``evaluate.main`` at its defaults (bf16 and the card) with the mug
    arguments of ``scripts/r5_chain.sh:22-26``, 2 rounds of 8: K1 four
    times, every launch its bf16 entry point, and K5 never."""
    from rgbmanip_tpu_torch.models.pose_estimator import evaluate as EV

    def counts():
        return (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16,
                k5.row_gather.launches)
    before = counts()
    EV.main(["task=pick_mug", "dataset=mug_test", "task.num_envs=8",
             "checkpoint=checkpoints/estimator_fast_mug_fine_r5.ckpt", "rounds=2",
             "img_size=192", "backend=resnet18", "backbone_stride=32", "volume_scale=8",
             "n_depth=16", "d_min=0.35", "d_interval=0.08", "warp_mode=nearest"])
    assert tuple(a - b for a, b in zip(counts(), before)) == (4, 4, 0)


# ------------------------------------------------------------ bf16 and the generations --
def estimate_args(B, seed):
    """``_estimate``'s (K, rgb1, mask1, ext1, rgb2, mask2, ext2) of ``scene``."""
    K, rgb, mask, ext = scene(B, seed)
    return K, rgb[0], mask[0], ext[0], rgb[1], mask[1], ext[1]


@pytest.mark.parametrize("name,over,B", [
    ("adapose_cabinet_fast", {"checkpoint_path": FAST}, 4),
    ("adapose_cabinet", {"load": False}, 2)], ids=["flagship", "paper"])
def test_bf16_estimate_on_card_matches_cpu(cuda, name, over, B):
    """The estimate in bf16 (``evaluate``'s default), the flagship's with
    its checkpoint and the paper size's on seeded weights: K1 twice, both
    its bf16 entry point, and K5 never; equal valid flags and the world bbox within twice
    the CPU's own bf16-to-f32 gap of the CPU's bf16 estimate (both bf16
    convolution libraries part in the last bits: see
    tests/test_torch_precision.py); and on the card at least half that gap
    (mean) from the card's own f32 estimate, as a card that ran f32 would
    not be."""
    cfg = load_group("pose_estimator", name, over)
    size = int(cfg["img_size"])
    args = estimate_args(B, seed=3)
    g = torch.Generator().manual_seed(1)
    u = [torch.rand(B, size * size, generator=g) for _ in range(2)]
    out = {}
    for run, d, dt in (("card", cuda, torch.bfloat16), ("card f32", cuda, torch.float32),
                       ("cpu", torch.device("cpu"), torch.bfloat16),
                       ("cpu f32", torch.device("cpu"), torch.float32)):
        est = AdaPoseEstimator(cfg, device=d, dtype=dt)
        before = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16,
                  k5.row_gather.launches)
        b, v, _ = est._estimate(*(torch.from_numpy(a).to(d) for a in args), *(x.to(d) for x in u))
        after = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16,
                 k5.row_gather.launches)
        if run == "card":
            assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 0)
        out[run] = (b.cpu().numpy(), v.cpu().numpy())
    ok = out["cpu"][1]
    assert ok.any()
    np.testing.assert_array_equal(out["card"][1], ok)
    gap = np.abs(out["cpu"][0] - out["cpu f32"][0])[ok]
    assert np.abs(out["card"][0] - out["cpu"][0])[ok].max() <= 2 * gap.max()
    assert np.abs(out["card"][0] - out["card f32"][0])[ok].mean() >= 0.5 * gap.mean()


def one_step(cfg, device, dtype, batch):
    """One ``EstimatorTrainer`` step of a fresh estimator from ``cfg``'s
    head: (loss parts, its (params, batch_stats) trees flattened, the step's
    gradient flattened in parameter order on the host)."""
    from rgbmanip_tpu_torch.models.pose_estimator.converter import to_jax_params
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer
    from rgbmanip_tpu_torch.utils.checkpoint import flatten

    est = AdaPoseEstimator(cfg, device=device, dtype=dtype)
    _, parts = EstimatorTrainer(est.model, lr=1e-4).step(
        {k: v.to(device) for k, v in batch.items()})
    grad = torch.cat([p.grad.reshape(-1).cpu() for p in est.model.parameters()
                      if p.grad is not None])
    return parts, [flatten(t) for t in to_jax_params(est.model)], grad


def bf16_step_against_cpu(cfg, batch, k, cuda):
    """One bf16 step from ``cfg``'s head on ``batch``, on the card and on the
    CPU, each beside its f32 step, and a card step on crops one pixel off.
    Returns, of the loss parts, the card's and the shifted step's largest
    difference from the CPU's bf16 over its limit (``k`` times the CPU's own
    bf16-to-f32 difference, at least 1e-2 relative: both bf16 runs are
    rounded copies of the f32 one); the card's and the CPU's bf16-to-f32
    differences summed over the parts; the gradients' cosine; the BatchNorm
    running statistics' largest difference over their largest; and the
    parameters' largest difference. ``np.max`` keeps a NaN, which fails any
    bound."""
    cpu = torch.device("cpu")
    shifted = dict(batch, **{n: torch.roll(batch[n], 1, dims=2) for n in ("img1", "img2")})
    g16, g32, off = (one_step(cfg, cuda, dt, b) for dt, b in (
        (torch.bfloat16, batch), (torch.float32, batch), (torch.bfloat16, shifted)))
    c16, c32 = (one_step(cfg, cpu, dt, batch) for dt in (torch.bfloat16, torch.float32))
    gap = {n: abs(c16[0][n] - c32[0][n]) / abs(c32[0][n]) for n in c16[0]}
    limit = {n: max(k * gap[n], 1e-2) for n in gap}

    def over(run):
        return float(np.max([abs(run[0][n] - c16[0][n]) / abs(c16[0][n]) / limit[n]
                             for n in gap]))
    (gp, gs), (cp, cs) = g16[1], c16[1]
    ga, gb = g16[2], c16[2]
    assert ga.shape == gb.shape
    return {"card": over(g16), "shifted": over(off),
            "own": sum(abs(g16[0][n] - g32[0][n]) / abs(g32[0][n]) for n in gap),
            "gap": sum(gap.values()), "cos": float(ga @ gb / ga.norm() / gb.norm()),
            "stats": float(np.max([np.abs(gs[n] - cs[n]).max() / (np.abs(cs[n]).max() + 1e-6)
                                   for n in cs])),
            "params": float(np.max([np.abs(gp[n] - cp[n]).max() for n in cp]))}


@pytest.mark.parametrize("n_envs", [2, 8])
def test_bf16_estimator_training_step_on_card_matches_cpu(cuda, tmp_path, monkeypatch, n_envs):
    """One bf16 ``EstimatorTrainer`` step (``train_estimator.main``'s
    default), card against CPU (``bf16_step_against_cpu``): each loss part
    within its limit, and a step on crops one pixel off outside it, which
    the limit would not see otherwise; the card's summed bf16-to-f32
    difference at least half the CPU's (a card that ran f32 would show
    none); the gradient's cosine with the CPU's 0.9 or more; BatchNorm
    running statistics within 1e-2 of their largest, parameters within two
    learning rates and rounding, 2.1e-4. With 2 envs: one sampled batch from
    the committed head, limit twice the CPU's gap. With 8 envs (the
    production batch, BatchNorm over 8 envs): the head that three bf16 steps
    of ``train_estimator.main`` trained, on its last batch: the whole batch
    at twice the CPU's gap (loss parts and the control), and each 2-env
    slice at 20 times it, where BatchNorm over two envs spreads the parts
    further (both multiples from ``scripts/bf16_step_spread.py``'s readings
    over six seeds, PERF.md), with every bound of the 2-env case over the
    slices (the control: on at least one slice)."""
    if n_envs == 2:
        cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": FAST})
        slices = [bf16_step_against_cpu(cfg, estimator_batch(torch.device("cpu")), 2, cuda)]
    else:
        est, head, taken = estimator_trainer_main(tmp_path, monkeypatch, "bf16", 3)
        cfg = dict(est.cfg, load=True, checkpoint_path=head)
        batch = {k: v.cpu() for k, v in taken[-1].items()}
        whole = bf16_step_against_cpu(cfg, batch, 2, cuda)
        assert whole["card"] <= 1 < whole["shifted"], whole
        slices = [bf16_step_against_cpu(cfg, {k: v[lo:lo + 2] for k, v in batch.items()}, 20,
                                        cuda) for lo in range(0, n_envs, 2)]
    worst = {k: float(np.max([r[k] for r in slices])) for k in slices[0]}
    assert worst["card"] <= 1 < worst["shifted"], slices
    assert sum(r["own"] for r in slices) >= 0.5 * sum(r["gap"] for r in slices), slices
    assert float(np.min([r["cos"] for r in slices])) >= 0.9, slices
    assert worst["stats"] <= 1e-2 and worst["params"] <= 2.1e-4, slices


@pytest.mark.parametrize("version,over", [("v3", {}), ("baseline", {}),
                                          ("v5", {"volume_channels": 8}), ("v1", {}), ("v5", {})])
def test_generation_on_card_matches_cpu(cuda, version, over):
    """A generation of ``make_estimator`` at B=4 on seeded weights (the
    flagship's knobs, 192 px): K1 twice on the card, its f32 entry point,
    and K5 never; the same RANSAC hypotheses and draws on both, equal valid
    flags and the world bbox within 1e-3 m."""
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu_torch.ops.geometry import ransac_hypotheses

    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"load": False, **over})
    args = estimate_args(4, seed=5)
    g = torch.Generator().manual_seed(2)
    u = [torch.rand(4, S * S, generator=g) for _ in range(2)]
    idx = ransac_hypotheses(g, 4, 1024)
    out = {}
    for d in (cuda, torch.device("cpu")):
        est = make_estimator(version, cfg, device=d)
        before = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16,
                  k5.row_gather.launches)
        b, v, _ = est._estimate(*(torch.from_numpy(a).to(d) for a in args),
                                *(x.to(d) for x in u), idx.to(d))
        launched = (k1.crop_resize_normalize.launches - before[0],
                    k1.crop_resize_normalize.launches_bf16 - before[1],
                    k5.row_gather.launches - before[2])
        assert launched == ((2, 0, 0) if d.type == "cuda" else (0, 0, 0))
        out[d.type] = (b.cpu().numpy(), v.cpu().numpy())
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-3)


RL_MANIP = ["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
            "task.num_envs=2", "seed=11"]


def rl_manipulation_iteration(device, save_dir, init=None, actions=None):
    """One ``RLManipulation`` iteration (2 envs x 4 transitions) on
    ``device`` with the learn and policy blocks of ``controller/rl.yaml``;
    from ``init`` (a state dict) and by ``actions`` where given. Returns
    (initial state dict, storage, final parameters, lr, the update's
    metrics)."""
    import json

    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.utils.logger import get_logger

    rl = load_group("controller", "rl")
    learn = dict(rl["learn"], num_transitions_per_env=4, save_dir=str(save_dir))
    cfg = load_config(RL_MANIP + ["manipulation.name=rl",
                                  f"manipulation.learn={json.dumps(learn)}",
                                  f"manipulation.policy={json.dumps(rl['policy'])}",
                                  f"device={device.type}"])
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=get_logger(), seed=cfg["seed"])
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], get_logger(), device=device)
        ppo = manip.algo
        assert {p.device.type for p in ppo.model.parameters()} == {device.type}
        if init is not None:
            ppo.model.load_state_dict(init)
        start = {k: v.detach().cpu().clone() for k, v in ppo.model.state_dict().items()}
        if actions is not None:
            it = iter(actions)
            ppo.action_source = lambda: next(it)
        manip.learn(1)
        storage = {k: getattr(ppo.storage, k).copy() for k in (
            "obs", "states", "actions", "rewards", "dones", "values", "logprobs", "mu")}
        params = {n: p.detach().cpu() for n, p in ppo.model.named_parameters()}
        return start, storage, params, ppo.lr, np.asarray(ppo.history[-1]["metrics"])
    finally:
        env.close()


def test_rl_manipulation_iteration_on_card_matches_cpu(cuda, tmp_path):
    """``RLManipulation`` on the card, then on the CPU from the card's
    initial weights and by its actions: the rollout equal (the simulator is
    bit-equal), means within 1e-5, values and log-probabilities within
    1e-4, the update's losses within 1e-3 relative, the learning rate equal
    and the parameters after the update within 2e-5 (actor) and 2e-4
    (critic), as ``test_ppo_training_through_train_main_on_card`` holds the
    camera scheduler's update."""
    start, card, cp, clr, cm = rl_manipulation_iteration(cuda, tmp_path / "card")
    _, cpu, hp, hlr, hm = rl_manipulation_iteration(torch.device("cpu"), tmp_path / "cpu",
                                                    init=start, actions=card["actions"])
    assert (np.abs(cm - hm) / np.maximum(np.abs(hm), 1e-6)).max() <= 1e-3
    for k in ("obs", "states", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(cpu[k], card[k], err_msg=k)
    np.testing.assert_allclose(cpu["mu"], card["mu"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(cpu["values"], card["values"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(cpu["logprobs"], card["logprobs"], rtol=0, atol=1e-4)
    assert clr == hlr
    for n in cp:
        bound = 2e-4 if n.startswith("critic") else 2e-5
        assert (cp[n] - hp[n]).abs().max().item() <= bound, n
    assert any((cp[n] - start[n]).abs().max().item() > 0 for n in cp)


def test_rl_manipulation_trains_and_plays_through_train_main_on_card(cuda, tmp_path,
                                                                      monkeypatch):
    """``manipulation.name=rl`` through ``train.main``: one
    ``train.train_manipulation`` iteration (2 envs x 4 transitions) trains
    the skill's policy on the card (obs 41, action 8 on ``open_cabinet``)
    and writes ``model_1.ckpt``; then ``train=test`` plays it on the card.
    No kernel of the port is on this path (a 41-input MLP): K1 never
    launches."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.algo.ppo import PPO

    runs, plays = [], []
    run, play = PPO.run, PPO.play

    def kept_run(self, *args, **kwargs):
        runs.append(self)
        return run(self, *args, **kwargs)

    def kept_play(self, *args, **kwargs):
        plays.append(self)
        return play(self, *args, **kwargs)
    monkeypatch.setattr(PPO, "run", kept_run)
    monkeypatch.setattr(PPO, "play", kept_play)
    rl = load_group("controller", "rl")
    learn = dict(rl["learn"], num_transitions_per_env=4, save_dir=str(tmp_path / "ckpt"))
    over = RL_MANIP + ["manipulation.name=rl", f"manipulation.learn={json.dumps(learn)}",
                       f"manipulation.policy={json.dumps(rl['policy'])}", "device=cuda",
                       f"train.save_dir={tmp_path}", f"train.log_dir={tmp_path}"]
    counters = (k1.crop_resize_normalize, k1.crop_resize_normalize_clamp)
    before = [f.launches for f in counters]
    assert T.main(over + ["train=controller", "train.train_controller=false",
                          "train.train_manipulation=true",
                          "train.iterations_per_epoch=1"]) is None
    played = T.main(over + ["train=test", "controller=gt_pose", "train.total_round=2"])
    assert [f.launches for f in counters] == before
    assert len(runs) == 1 and runs[0].device.type == "cuda"
    assert {p.device.type for p in runs[0].model.parameters()} == {"cuda"}
    assert (runs[0].obs_dim, runs[0].act_dim) == (41, 8)
    assert (tmp_path / "ckpt" / "model_1.ckpt").exists()
    assert plays and all(p.device.type == "cuda" for p in plays) and played["rounds"] == 2


@pytest.mark.parametrize("kind,task", [("cabinet", "open_cabinet"), ("drawer", "open_drawer"),
                                       ("pot", "open_pot"), ("mug", "pick_mug")])
def test_a_urdf_fixture_gt_round_on_card_equals_cpu(cuda, tmp_path, kind, task):
    """The gt stack, one round of 8 on a URDF fixture dataset
    (``tests/fixtures/mobility_*``) through ``train.main``: the same result
    (success and move distance) with ``device=cuda`` as with ``device=cpu``."""
    from rgbmanip_tpu_torch import train as T

    over = [f"dataset={kind}_urdf_fixture", f"task={task}", f"manipulation={task}",
            "controller=gt_pose", "pose_estimator=ground_truth", "train=test",
            "train.total_round=8", "task.num_envs=8", "seed=0",
            f"train.save_dir={tmp_path}", f"train.log_dir={tmp_path}"]
    res = {d: T.main(over + [f"device={d}"]) for d in ("cuda", "cpu")}
    assert res["cuda"] == res["cpu"] and res["cuda"]["rounds"] == 8


class FakeRobot:
    def __init__(self):
        self.pose = np.array([0.4, 0.0, 0.5, 0.0, 1.0, 0.0, 0.0])
        self.gripper = 0.04

    def hand_pose(self):
        return self.pose

    def move_to(self, pose7, duration=0.0):
        self.pose = np.asarray(pose7, np.float64)

    def set_gripper(self, width):
        self.gripper = width


class FakeCamera:
    """A fixed 480x640 frame with a bright square object."""

    def capture(self):
        rgb = np.full((H, W, 3), 0.2, np.float32)
        rgb[200:280, 280:360] = (0.9, 0.3, 0.1)
        return (rgb, np.full((H, W), 1.5, np.float32),
                np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]]))


class FakeSAM:
    def predict(self, rgb):
        return rgb[..., 0] > 0.5


def test_realworld_estimate_on_card_matches_cpu(cuda):
    """``make_estimator("realworld")`` at the flagship's widths on seeded
    weights, on the real-world env's 480x640 images (fake drivers): K1
    twice on the card, the world bbox within 1e-3 m of the CPU's with
    equal valid flags; an empty mask gives the sentinel on both."""
    from rgbmanip_tpu_torch.envs.realworld.base_realworld import BaseRealworldEnv
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu_torch.utils.transform import Pose

    env = BaseRealworldEnv(robot_driver=FakeRobot(), camera_driver=FakeCamera(),
                           segmenter=FakeSAM())
    i1 = env.get_image()["camera0"]
    env.cam_move_to(Pose([0.45, 0.15, 0.55], [0.0, 1.0, 0.0, 0.0]).to_7d()[None])
    i2 = env.get_image()["camera0"]
    assert i1["Color"].shape == (1, H, W, 3) and i1["Mask"].any() and i2["Mask"].any()
    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"load": False})
    g = torch.Generator().manual_seed(4)
    u = [torch.rand(1, S * S, generator=g) for _ in range(2)]
    for m1, sentinel in ((i1["Mask"], False), (np.zeros_like(i1["Mask"]), True)):
        args = (i1["Intrinsic"], i1["Color"], m1, i1["Extrinsic"], i2["Color"], i2["Mask"],
                i2["Extrinsic"])
        out = {}
        for d in (cuda, torch.device("cpu")):
            est = make_estimator("realworld", cfg, device=d)
            assert est.model.realworld_pts
            before = (k1.crop_resize_normalize.launches,
                      k1.crop_resize_normalize_clamp.launches)
            b, v, _ = est._estimate(*(torch.from_numpy(np.asarray(a)).to(d) for a in args),
                                    *(x.to(d) for x in u))
            launched = (k1.crop_resize_normalize.launches - before[0],
                        k1.crop_resize_normalize_clamp.launches - before[1])
            assert launched == ((2, 0) if d.type == "cuda" else (0, 0))
            out[d.type] = (b.cpu().numpy(), v.cpu().numpy())
        np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-3)
        assert (out["cuda"][0] >= 9.0).all() == sentinel
        assert out["cuda"][1].all() != sentinel


def sharded_estimator_step(rank, world):
    """One estimator step on the card over a 1x1 mesh (``graft_entry``'s
    tiny dryrun network and batch): the BatchNorms' group path."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import FlaxBatchNorm3d
    from rgbmanip_tpu_torch.parallel.mesh import make_mesh

    out = graft_entry_step(torch.device("cuda"), make_mesh(world))
    bns = [m for m in out.pop("model").modules() if isinstance(m, FlaxBatchNorm3d)]
    out["grouped"] = bool(bns) and all(m.process_group is not None for m in bns)
    return out


def graft_entry_step(dev, mesh=None):
    """(loss, parts, BatchNorm running statistics, parameters) of one step
    of the resnet18 estimator at the JAX module's defaults, B=2, 32 px."""
    from rgbmanip_tpu_torch import graft_entry
    from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import (
        FlaxBatchNorm3d, StereoPoseNetWithDepth, flax_init_)
    from rgbmanip_tpu_torch.models.pose_estimator.training import (EstimatorTrainer,
                                                                   synthetic_batch)
    from rgbmanip_tpu_torch.parallel.mesh import (apply_shardings, full_parameters,
                                                  param_shardings)

    model = StereoPoseNetWithDepth(backend="resnet18", regress_pose=True,
                                   **graft_entry.JAX_NET_DEFAULTS)
    flax_init_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    batch = {k: v.to(dev) for k, v in
             synthetic_batch(torch.Generator().manual_seed(0), 2, 32, 64, n_depth=8).items()}
    if mesh is not None:
        apply_shardings(model, param_shardings(model, mesh))
    total, parts = EstimatorTrainer(model, mesh=mesh).step(batch)
    stats = {f"{n}.{b}": getattr(m, b).cpu() for n, m in model.named_modules()
             if isinstance(m, FlaxBatchNorm3d) for b in ("running_mean", "running_var")}
    params = {n: p.detach().cpu() for n, p in full_parameters(model).items()}
    return {"total": total, "parts": parts, "stats": stats, "params": params, "model": model}


def test_batchnorm_group_path_at_world_1_matches_the_plain_step(cuda):
    """An estimator step through a one-rank NCCL mesh (the BatchNorms' sums
    all-reduced over the dp group, the gradients and loss reduced, the
    parameters DTensors) against the same step without a mesh, both on the
    card: loss and parts 1e-5 relative, running statistics 1e-4 plus 1e-5,
    parameters within two learning rates (Adam's first step)."""
    from rgbmanip_tpu_torch.parallel.launch import run_ranks

    sharded = run_ranks(sharded_estimator_step, 1, "cuda")[0]
    plain = graft_entry_step(cuda)
    assert sharded["grouped"]
    np.testing.assert_allclose(sharded["total"], plain["total"], rtol=1e-5)
    for k, v in plain["parts"].items():
        np.testing.assert_allclose(sharded["parts"][k], v, rtol=1e-5, err_msg=k)
    for k, v in plain["stats"].items():
        np.testing.assert_allclose(sharded["stats"][k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k, v in plain["params"].items():
        assert float((sharded["params"][k] - v).abs().max()) <= 2.1e-4, k


def test_entry_forward_on_card_matches_cpu(cuda):
    """``graft_entry.entry()``'s bf16 forward (resnet34 at the JAX module's
    defaults, B=2, 224 px, bilinear warp) on the card against the CPU, per
    output: the shapes, the mean |card - CPU| of the bf16 forwards within
    twice the CPU's own mean bf16-to-f32 difference, and the card's own
    bf16-to-f32 difference at least half the CPU's (the rule of
    ``test_bf16_estimate_on_card_matches_cpu``, on each output's mean). On
    the card the forward launches K2 twice, bit for bit its twin on its own
    calls, and neither K1 nor K5 (the network takes cropped views)."""
    from rgbmanip_tpu_torch import graft_entry
    from rgbmanip_tpu_torch.ops import plane_sweep as k2

    def counts():
        return (k1.crop_resize_normalize.launches, k1.crop_resize_normalize_clamp.launches,
                k5.row_gather.launches, k2.warp_fuse.launches)

    def run(device, calls):
        forward, args = graft_entry.entry(device=device)
        net = graft_entry.flagship_net(torch.float32, device)
        with torch.no_grad():
            out32 = net(*args)
        before = counts()
        with k2_recorded(calls):
            out16 = forward(*args)
        return ([o.float().cpu() for o in out16],
                [out32[n].float().cpu() for n in ("view1_nocs", "view1_depth", "view1_r")],
                out16, tuple(a - b for a, b in zip(counts(), before)))

    calls = []
    card16, card32, raw, launched = run(cuda, calls)
    assert launched == (0, 0, 0, 2)
    assert_k2_equals_its_twin_on(calls)
    assert [o.dtype for o in raw] == [torch.bfloat16, torch.float32, torch.bfloat16]
    assert all(o.is_cuda and torch.isfinite(o.float()).all() for o in raw)
    B, _, N, _ = graft_entry.ENTRY_SHAPE
    assert [tuple(o.shape) for o in raw] == [(B, N, 3), (B, N), (B, 3, 3)]
    cpu16, cpu32, _, _ = run(torch.device("cpu"), [])
    for c16, c32, p16, p32 in zip(card16, card32, cpu16, cpu32):
        gap = float((p16 - p32).abs().mean())
        assert float((c16 - p16).abs().mean()) <= 2 * gap
        assert float((c16 - c32).abs().mean()) >= 0.5 * gap


def test_dryrun_multichip_on_every_card_matches_the_unsharded_cpu_steps(cuda):
    """``dryrun_multichip(torch.cuda.device_count())``: one rank per card
    through NCCL, a (dp, tp) mesh over every card; its estimator loss and
    parts, the production-shape loss where tp > 1, and the PPO update's
    metrics within 1e-4 relative of the same steps run unsharded on the CPU
    (f32, TF32 off). This process launches neither K1 nor K5."""
    from rgbmanip_tpu_torch import graft_entry

    def counts():
        return (k1.crop_resize_normalize.launches, k1.crop_resize_normalize_clamp.launches,
                k5.row_gather.launches)
    n = torch.cuda.device_count()
    before = counts()
    out = graft_entry.dryrun_multichip(n)
    assert counts() == before
    assert out["dp"] * out["tp"] == n
    cpu = graft_entry.dryrun_steps(out["dp"], out["tp"], device="cpu")
    keys = sorted(cpu["estimator_parts"])
    got = ([out["estimator_loss"]] + [out["estimator_parts"][k] for k in keys]
           + list(out["ppo_metrics"]) + [out.get("production_loss", 1.0)])
    ref = ([cpu["estimator_loss"]] + [cpu["estimator_parts"][k] for k in keys]
           + list(cpu["ppo_metrics"]) + [cpu.get("production_loss", 1.0)])
    assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, ref)), (got, ref)


def test_bf16_conv3d_weight_gradient_on_the_cpu_stays_finite():
    """The port's bf16 ``Conv3d`` on the CPU at the CostRegNet's conv6 shape
    (64 -> 64 channels over a 2x3x3 volume): 300 calls, each after NaN-filled
    memory was freed, give a finite weight gradient
    (``nets/layers.py::_Bf16Conv3dOnCpu``). PyTorch 2.11's own CPU bf16
    weight-gradient kernel gives a non-finite one in a quarter to over half
    of such calls (``scripts/cpu_bf16_conv_probe.py``). Runs on the CPU, so
    also without a card."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets.layers import Conv3d

    torch.manual_seed(0)
    m = Conv3d(64, 64, 3, 1, padding=1, bias=False, dtype=torch.bfloat16)
    bad = 0
    for _ in range(300):
        junk = [torch.full((1 << k,), float("nan")) for k in range(10, 22)]
        del junk
        m.weight.grad = None
        (m(torch.randn(2, 64, 2, 3, 3)).float() ** 2).sum().backward()
        bad += int(not torch.isfinite(m.weight.grad).all())
    assert bad == 0


def test_a_gt_sweep_row_on_card_equals_cpu(cuda, monkeypatch, tmp_path):
    """``eval_sweep``'s gt stack (no network) over all 16 rows at one round
    of 8 gives the same rows with ``device=cuda`` as with ``device=cpu``,
    and launches no K1; the committed JSON is not read or written (the
    sweep writes ``docs/sweep_torch_*`` under the working directory)."""
    from rgbmanip_tpu_torch.scripts import eval_sweep

    out = {}
    before = k1.crop_resize_normalize.launches
    for name in ("cuda", "cpu"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out[name] = eval_sweep.main(["8", "gt_pose", "ground_truth", f"device={name}"])
        assert os.path.exists("docs/sweep_torch_gt_pose_ground_truth.json")
    assert k1.crop_resize_normalize.launches == before
    assert out["cuda"]["results"] == out["cpu"]["results"]
    assert len(out["cuda"]["results"]) == 16
    assert out["cuda"]["results"]["open_drawer/test"]["episodes"] == 8


# one heuristic + AdaPose row of the sweep per estimator family, with its
# committed estimator (scripts/eval_sweep.py's rows)
SWEEP_FAMILIES = {
    "cabinet": ("open_cabinet", "open_cabinet", "cabinet_test",
                [f"pose_estimator.checkpoint_path={FAST}"]),
    "drawer": ("open_drawer", "open_drawer", "drawer_test", []),
    "pot": ("open_pot", "open_pot", "pot_test", []),
    "mug": ("pick_mug", "pick_mug", "mug_test", []),
}


@pytest.mark.parametrize("family", list(SWEEP_FAMILIES))
def test_a_learned_sweep_row_launches_k1(cuda, monkeypatch, tmp_path, family):
    """A heuristic + AdaPose row of the sweep for each estimator family runs
    its estimate on the card through K1: one estimate of the batch, K1
    twice, no error row."""
    from rgbmanip_tpu_torch.scripts import eval_sweep
    from rgbmanip_tpu_torch.utils.logger import get_logger

    task, manip, dataset, passthru = SWEEP_FAMILIES[family]
    monkeypatch.chdir(tmp_path)
    before = k1.crop_resize_normalize.launches
    res = eval_sweep.sweep([(task, manip, [("test", dataset)])], 8, "heuristic_pose",
                           f"adapose_{family}_fast", passthru + ["device=cuda"], get_logger())
    row = res[f"{task}/test"]
    assert "error" not in row, row
    assert row["episodes"] == 8
    assert k1.crop_resize_normalize.launches - before == 2


def test_diag_flagship_launches_k1_twice_an_estimate_on_card(cuda, monkeypatch):
    """``diag_flagship`` at one round of 8 with the flagship's estimator
    (``EST_CKPT``, as ``scripts/r5_stageD.sh:18``): K1 twice per estimate
    it records of the RL and the heuristic run, every recorded row finite."""
    from rgbmanip_tpu_torch.scripts import diag_flagship

    monkeypatch.setenv("EST_CKPT", FAST)
    before = k1.crop_resize_normalize.launches
    out = diag_flagship.main([POLICY, "1", "8", "device=cuda"])
    rows = out["rl"].rows + out["heuristic"].rows
    n_est = len(rows) // 8
    assert n_est > 0 and k1.crop_resize_normalize.launches - before == 2 * n_est
    assert np.isfinite(np.array(rows)).all()


def test_trace_mug_learned_launches_k1_twice_a_round_on_card(cuda):
    """``trace_mug_learned`` at one round of 8 on ``mug_test``: 8 finite
    rows, K1 twice (the round's one estimate)."""
    from rgbmanip_tpu_torch.scripts import trace_mug_learned

    before = k1.crop_resize_normalize.launches
    rows = trace_mug_learned.main(["mug_test", "1", "device=cuda"])
    assert len(rows) == 8 and np.isfinite(np.array(rows, np.float64)).all()
    assert k1.crop_resize_normalize.launches - before == 2


# the bench's knobs on the flagship head (the same architecture as the
# bench's own ``estimator_fast_cabinet_r2.ckpt``, which these tests need not read)
BENCH_HEAD = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"


@pytest.mark.parametrize("raised", [False, True], ids=["own-views", "view2-raised"])
def test_bench_estimate_on_card_matches_cpu(cuda, raised):
    """``rgbmanip_tpu_torch.bench``'s estimate at B=8 in f32: its inputs, made
    on the card, and the same point draws on the card and on the CPU, bbox
    within 1e-3 m and equal valid flags, on the bench's own views and with
    the second camera raised 1 mm (``torch_card_cpu.bench_card_against_cpu``).
    On the own views the cost volume's first and last rows sit on a rounding
    tie at the source's border, which the CPU's run takes from the card's
    after checking that no other ray's decision differs; raised, no ray is
    on a tie."""
    from torch_card_cpu import bench_card_against_cpu

    from rgbmanip_tpu_torch import bench

    ests = {k: bench.estimator(BENCH_HEAD, torch.float32, d)
            for k, d in (("card", cuda), ("cpu", torch.device("cpu")))}
    bdiff, n_valid, taken = bench_card_against_cpu(ests, 8, raised)
    assert bdiff <= 1e-3 and 0 <= n_valid <= 8
    if raised:
        assert taken == 0


def test_bench_launches_k1_bf16_twice_per_estimate(cuda):
    from rgbmanip_tpu_torch import bench

    row = bench.estimate_ms(bench.estimator(BENCH_HEAD, torch.bfloat16, cuda), 8, 2, 1)
    assert row["estimates"] == 3 and row["ms"] > 0
    assert row["launches"] == row["launches_bf16"] == 2 * row["estimates"]


def test_bench_ppo_update_is_finite_on_the_card(cuda):
    from rgbmanip_tpu_torch.algo.ppo import PPO
    from rgbmanip_tpu_torch.scripts import bench_ppo_update as bpu

    ppo = PPO(bpu.FakeEnv(), bpu.CFG, seed=0, device=cuda)
    metrics = ppo._update(bpu.make_batch(0, cuda))
    assert metrics.shape == (5,) and torch.isfinite(metrics).all()
    assert all(torch.isfinite(p).all() for p in ppo.model.parameters())
    assert len(ppo.update_lrs) == 32


# the timing scripts at a short size, each in its own process; the bench on
# the flagship head (``BENCH_HEAD``)
TIMING_SCRIPTS = {
    "bench": ["rgbmanip_tpu_torch.bench", "--batch", "8", "64", "--iters", "2", "--reps",
              "1", "--checkpoint", BENCH_HEAD],
    "bench_estimate": ["rgbmanip_tpu_torch.scripts.bench_estimate", "fast", "--batch", "16"],
    "bench_ppo_update": ["rgbmanip_tpu_torch.scripts.bench_ppo_update", "--iters", "2",
                         "--reps", "1"],
    "bench_ppo_iter": ["rgbmanip_tpu_torch.scripts.bench_ppo_iter", "8", "1"],
    "bench_sim_scaling": ["rgbmanip_tpu_torch.scripts.bench_sim_scaling", "--envs", "1",
                          "8", "--threads", "--cycles", "1"],
}


def numbers(v, at=""):
    """Every number of a parsed JSON object outside its lists, by its place
    ("<line> <key> ...")."""
    if isinstance(v, dict):
        for k, x in v.items():
            yield from numbers(x, f"{at} {k}")
    elif isinstance(v, (int, float)) and not isinstance(v, bool):
        yield at.strip(), v


@pytest.mark.parametrize("name", list(TIMING_SCRIPTS))
def test_a_timing_script_runs_on_card(cuda, name):
    """A timing script of the port at a short size in its own process (its
    times then check the script, not the card): it exits 0 and every number
    of the JSON lines it prints is finite and positive (a launch count may
    be 0). The bench's last line is its headline, named after the card,
    and each of its rows launched K1 twice an estimate, its bf16 entry
    point in the bf16 rows; ``bench_sim_scaling`` prints a row for each
    number of envs."""
    import math

    res = subprocess.run([sys.executable, "-m", *TIMING_SCRIPTS[name]], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rows = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    assert rows, res.stdout[-2000:]
    bad = {k: v for i, r in enumerate(rows) for k, v in numbers(r, str(i))
           if not (math.isfinite(v) and (v > 0 or k.split()[-1].startswith("launches")
                                         and v == 0))}
    assert not bad, bad
    if name == "bench":
        last = rows[-1]
        assert last["metric"] == "pose_estimation_fps" and last["vs_baseline"] is None
        best = max(rows[:2], key=lambda r: r["frames_per_s"])   # the bf16 headline batches
        assert f"(B={best['B']}, {torch.cuda.get_device_name(0)}, bf16," in last["unit"]
        for r in rows[:-1]:
            assert r["launches"] == 2 * r["estimates"], r
            assert r["launches_bf16"] == (r["launches"] if r["dtype"] == "bfloat16" else 0), r
    if name == "bench_sim_scaling":
        assert [(r["n_envs"], r["n_threads"]) for r in rows] == [(1, 1), (8, 1)]


def test_spans_split_the_bf16_estimate_on_card(cuda, monkeypatch):
    """The estimate's spans at the fast configuration, B=8, bf16, inputs on
    the card as the benchmark hands them: under the profiler every stage has
    device time, the seven stages cover 95-100.5% of the estimate's, the
    sync counter equals what torch's sync debug mode reports for the same
    call counted on its own (the readback's five copies among them), and
    the outputs equal the untraced call's bitwise."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.utils.logger import SPANS, SYNC_WARNING

    # deterministic convolution algorithms, so that two calls may be compared bitwise
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"load": False})
    est = AdaPoseEstimator(cfg, device=cuda, seed=0, dtype=torch.bfloat16)
    args = [torch.from_numpy(a).to(cuda) for a in estimate_args(8, seed=3)]

    def call():
        est.generator.manual_seed(3)
        return est.estimate_full(*args)
    off = [call() for _ in range(2)][-1]
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    syncs = sum(SYNC_WARNING in str(w.message) for w in log)

    SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            on = [call() for _ in range(3)]
            torch.cuda.synchronize()
        s = SPANS.summary()
    finally:
        SPANS.reset()
    for out in on:
        assert set(out) == set(off)
        assert all(np.array_equal(out[k], off[k], equal_nan=True) for k in off)
    stages = ("adapose/preprocess", "stereo/backbone", "stereo/warp", "stereo/cost_reg",
              "stereo/heads", "adapose/solve", "adapose/readback")
    root = s["adapose/estimate"]
    assert root["calls"] == 3 and all(s[k]["calls"] == 3 for k in stages)
    assert all(s[k]["device_ms"] > 0 for k in stages), {k: s[k]["device_ms"] for k in stages}
    cover = sum(s[k]["device_ms"] for k in stages) / root["device_ms"]
    assert 0.95 <= cover <= 1.005, cover
    assert sum(v["host_syncs"] * v["calls"] for v in s.values()) / 3 == syncs
    assert s["adapose/readback"]["host_syncs"] >= 5
    assert root["pairs"] == 8 and root["h2d_bytes"] == 0
    assert s["adapose/preprocess"]["k1_launches"] == 2
    # the pyramid pooling reads its windows from device tables: one gather a view
    assert s["stereo/backbone"]["host_syncs"] == 0
    assert s["stereo/backbone"]["psp_pool_gathers"] == 2
    assert syncs == 9
    # and gives what the per-bin integral images gave
    per_bin_pooling(monkeypatch)
    assert all(np.array_equal(off[k], v, equal_nan=True) for k, v in call().items())


def per_bin_pooling(monkeypatch):
    """``PSPModule`` in a reduced dtype as it was before ``pyramid_pool``:
    each bin's own integral image (``tests/test_psp_pool.py``'s reference)."""
    from test_psp_pool import reference_psp

    from rgbmanip_tpu_torch.models.pose_estimator.nets import pspnet

    forward = pspnet.PSPModule.forward
    monkeypatch.setattr(pspnet.PSPModule, "forward",
                        lambda self, x: (forward(self, x) if x.dtype == torch.float32
                                         else reference_psp(self, x)))


def test_bf16_paper_estimate_equals_the_per_bin_pooling_on_card(cuda, monkeypatch):
    """adapose_cabinet (resnet34 at stride 8, 224 px: a 28x28 map into the
    pyramid) in bf16 at B=4 on seeded weights: the PSPNet's features and the
    estimate's outputs equal bit for bit those of the per-bin pooling, with
    cuDNN's deterministic algorithms."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_group("pose_estimator", "adapose_cabinet", {"load": False})
    est = AdaPoseEstimator(cfg, device=cuda, seed=0, dtype=torch.bfloat16)
    args = [torch.from_numpy(a).to(cuda) for a in estimate_args(4, seed=3)]
    feats = []
    est.model.img_extractor.register_forward_hook(lambda m, i, o: feats.append(o.clone()))

    def call():
        feats.clear()
        est.generator.manual_seed(3)
        return est.estimate_full(*args), list(feats)
    new, new_feats = call()
    per_bin_pooling(monkeypatch)
    old, old_feats = call()
    assert len(new_feats) == 2 and new_feats[0].shape == (4, 224, 224, 32)
    assert new_feats[0].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(new_feats, old_feats))
    assert set(new) == set(old)
    assert all(np.array_equal(new[k], old[k], equal_nan=True) for k in old)


# ------------------------------------------------------------ K2 --
@pytest.mark.parametrize("shape,dtype", [((16, 24, 224, 224, 32), torch.bfloat16),
                                         ((4, 8, 56, 56, 32), torch.float32)],
                         ids=["published-bf16", "small-f32"])
def test_k2_kernel_equals_the_eager_warp(cuda, shape, dtype):
    """K2 against the eager bilinear warp plus the fusing add (and the
    U-Net's permuted copy), bit for bit, both directions: at the published
    network's shape (B, D, H, W, C) in bf16 and at a smaller one in f32, on
    ``tests/test_torch_plane_sweep.py``'s geometry (points on and off the
    image, behind the camera, on tap ties)."""
    from test_torch_plane_sweep import bits, eager, features, geometry

    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    from rgbmanip_tpu_torch.ops import plane_sweep

    B, D, Hv, Wv, C = shape
    p1, p2, depth = geometry(B, Hv, Wv, D, seed=7, device=cuda)
    f1, f2 = features(B, Hv, Wv, C, dtype, seed=8, device=cuda)
    before = plane_sweep.warp_fuse.launches
    for src, ref, sp, rp in ((f2, f1, p2, p1), (f1, f2, p1, p2)):
        got = stereo.fused_volume(src, ref, sp, rp, depth)
        want = eager(src, ref, sp, rp, depth)
        assert got.shape == (B, C, D, Hv, Wv) and got.dtype == dtype
        assert torch.equal(bits(got), bits(want))
        del got, want
    assert plane_sweep.warp_fuse.launches - before == 2
    # a permuted view of the features, as the PSPNet hands them
    perm = f1.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert torch.equal(bits(stereo.fused_volume(f2, perm, p2, p1, depth)),
                       bits(eager(f2, f1, p2, p1, depth)))


@pytest.mark.parametrize("C,dtype,offset", [
    (8, torch.bfloat16, 0), (16, torch.float32, 0),      # 1 and 4 vectors a row
    (12, torch.float32, 0), (80, torch.bfloat16, 0),     # 3 and 10: any count
    (4, torch.bfloat16, 0), (3, torch.float32, 0),       # no whole vector
    (8, torch.float32, 1)],                              # maps off 16-byte alignment
    ids=["bf16-c8", "f32-c16", "f32-c12", "bf16-c80", "bf16-c4", "f32-c3", "f32-c8-offset"])
def test_k2_kernel_takes_any_row_width(cuda, C, dtype, offset):
    """K2 against the eager warp, bit for bit, at feature widths and
    addresses other than the published network's: rows of whole 16-byte
    vectors by the vector kernel, any other row channel by channel; with a
    singular view (zero extrinsics) in the batch."""
    from test_torch_plane_sweep import bits, eager, features, geometry

    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    from rgbmanip_tpu_torch.ops import plane_sweep

    B, D, Hv, Wv = 3, 5, 20, 24
    p1, p2, depth = geometry(B, Hv, Wv, D, seed=11, device=cuda)
    p2[2] = 0.0
    f1, f2 = features(B, Hv, Wv, C, dtype, seed=12, device=cuda)
    if offset:
        buf = torch.empty(f1.numel() + offset, dtype=dtype, device=cuda)
        f1 = buf[offset:].view(f1.shape).copy_(f1)
        assert f1.data_ptr() % 16
    before = plane_sweep.warp_fuse.launches
    for src, ref, sp, rp in ((f2, f1, p2, p1), (f1, f2, p1, p2)):
        got = stereo.fused_volume(src, ref, sp, rp, depth)
        want = eager(src, ref, sp, rp, depth)
        assert got.shape == (B, C, D, Hv, Wv) and got.dtype == dtype
        assert torch.equal(bits(got), bits(want))
    assert plane_sweep.warp_fuse.launches - before == 2


def test_k2_parity_estimate_equals_the_eager_warp_on_card(cuda, monkeypatch):
    """adapose_cabinet at the published resolution (volume_scale 1, bilinear
    warp) in bf16 at B=4 on seeded weights: under the profiler K2 runs twice
    a call (``k2_launches`` 2 in ``stereo/warp``), and the outputs equal bit
    for bit those of the eager warp, with cuDNN's deterministic algorithms."""
    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu_torch.ops import plane_sweep
    from rgbmanip_tpu_torch.utils.logger import SPANS

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = load_group("pose_estimator", "adapose_cabinet",
                     {"load": False, "volume_scale": 1, "warp_mode": "bilinear"})
    est = AdaPoseEstimator(cfg, device=cuda, seed=0, dtype=torch.bfloat16)
    args = [torch.from_numpy(a).to(cuda) for a in estimate_args(4, seed=3)]

    def call():
        est.generator.manual_seed(3)
        return est.estimate_full(*args)
    before = plane_sweep.warp_fuse.launches
    on = call()
    assert plane_sweep.warp_fuse.launches - before == 2
    SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            traced = call()
            torch.cuda.synchronize()
        s = SPANS.summary()
    finally:
        SPANS.reset()
    assert s["stereo/warp"]["k2_launches"] == 2
    monkeypatch.setattr(StereoPoseNetWithDepth, "k2_applies", lambda self, feat: False)
    before = plane_sweep.warp_fuse.launches
    off = call()
    assert plane_sweep.warp_fuse.launches == before
    assert on["valid"].any()
    for out in (on, traced):
        assert set(out) == set(off)
        assert all(np.array_equal(out[k], off[k], equal_nan=True) for k in off)


@pytest.mark.parametrize("B,S,backend,dtype", [
    (2, 64, "resnet18", torch.float32), (2, 64, "resnet18", torch.bfloat16),
    (16, 224, "resnet34", torch.float32), (16, 224, "resnet34", torch.bfloat16)],
    ids=["small-f32", "small-bf16", "cell-f32", "cell-bf16"])
def test_k2_v1_forward_equals_its_eager_route_on_card(cuda, monkeypatch, B, S, backend, dtype):
    """``StereoPoseNetV1`` on the card builds both fused volumes through K2
    (2 launches a forward) and gives, bit for bit, what the same network
    gives through its eager route (``fused_volume_plain``, ``k2_applies``
    False), with cuDNN's deterministic algorithms: at a small size and at the
    v1 cell's (B, S, S) = (16, 224, 224) with resnet34, 24 depths and 1,024
    points."""
    from test_torch_plane_sweep import bits, geometry

    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    from rgbmanip_tpu_torch.ops import plane_sweep

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    D, N = (24, 1024) if S == 224 else (8, 128)
    net = stereo.StereoPoseNetV1(backend, n_depth=D, dtype=dtype)
    net = stereo.flax_init_(net, torch.Generator().manual_seed(0)).to(cuda).eval()
    p1, p2, depth = geometry(B, S, S, D, seed=5, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    img = [torch.randn(B, S, S, 3, generator=g, device=cuda).to(dtype) for _ in range(2)]
    choose = [torch.randint(0, S * S, (B, N), generator=g, device=cuda) for _ in range(2)]
    x = (img[0], choose[0], img[1], choose[1], p1, p2, depth.abs())
    with torch.inference_mode():
        before = plane_sweep.warp_fuse.launches
        on = net(*x)
        assert plane_sweep.warp_fuse.launches - before == 2
        monkeypatch.setattr(stereo.StereoPoseNetV1, "k2_applies", lambda self, feat: False)
        off = net(*x)
        assert plane_sweep.warp_fuse.launches - before == 2
    assert set(on) == set(off)
    for k in off:
        assert on[k].dtype == off[k].dtype and torch.equal(bits(on[k]), bits(off[k])), k


def test_k2_v1_estimate_launches_k2_twice_on_card_and_never_on_the_cpu(cuda):
    """``make_estimator("v1")`` at the flagship's knobs (192 px, 16 depths)
    on seeded weights, three calls under the profiler: on the card each call
    launches K2 twice (``k2_launches`` 2 in ``stereo/warp``), opens every
    stage once with a device time, ``volume_bytes`` and ``triangulations``
    as their shapes give them, and the stages cover at least 95% of the
    root's device time; on the CPU K2 never runs and ``stereo/warp`` counts
    no launch (``test_generation_on_card_matches_cpu`` holds the two sides'
    boxes together)."""
    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu_torch.ops import plane_sweep
    from rgbmanip_tpu_torch.utils.logger import SPANS

    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"load": False})
    S, N, D, B = int(cfg["img_size"]), int(cfg["n_pts"]), int(cfg["n_depth"]), 4
    args = estimate_args(B, seed=5)
    stages = ("adapose/preprocess", "stereo/backbone", "stereo/warp", "stereo/volume_conv",
              "stereo/heads", "adapose/solve", "adapose/readback")
    for d in (cuda, torch.device("cpu")):
        est = make_estimator("v1", cfg, device=d)
        x = [torch.from_numpy(a).to(d) for a in args]
        before = plane_sweep.warp_fuse.launches
        SPANS.reset()
        try:
            with profile(activities=[ProfilerActivity.CPU]
                         + ([ProfilerActivity.CUDA] if d.type == "cuda" else [])):
                for _ in range(3):
                    est.estimate_full(*x)
                if d.type == "cuda":
                    torch.cuda.synchronize()
            s = SPANS.summary()
        finally:
            SPANS.reset()
        launched = plane_sweep.warp_fuse.launches - before
        assert all(s[k]["calls"] == 3 for k in (*stages, "solve/match", "solve/pnp")), s
        assert s["stereo/volume_conv"]["volume_bytes"] == 2 * B * 32 * D * S * S * 4
        assert s["solve/match"]["triangulations"] == B * N
        if d.type == "cuda":
            assert launched == 6 and s["stereo/warp"]["k2_launches"] == 2
            assert all(s[k]["device_ms"] > 0 for k in stages)
            cover = sum(s[k]["device_ms"] for k in stages) / s["adapose/estimate"]["device_ms"]
            assert 0.95 <= cover <= 1.005, cover
        else:
            assert launched == 0 and "k2_launches" not in s["stereo/warp"]


# ------------------------------------------------- the U-Net's channels-last volume --
@pytest.mark.parametrize("shape,dtype", [((16, 24, 224, 224, 32), torch.bfloat16),
                                         ((4, 8, 56, 56, 32), torch.float32)],
                         ids=["published-bf16", "small-f32"])
def test_k2_writes_the_plain_twins_channels_last_layout(cuda, shape, dtype):
    """K2 and its plain twin (``fused_volume_plain``) return the same
    channels-last-3d volume, both directions: the same strides, each point's
    C channels one contiguous row of memory (B, D, H, W, C), and the same
    bits in it."""
    from test_torch_plane_sweep import features, geometry

    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    B, D, Hv, Wv, C = shape
    p1, p2, depth = geometry(B, Hv, Wv, D, seed=7, device=cuda)
    f1, f2 = features(B, Hv, Wv, C, dtype, seed=8, device=cuda)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    for src, ref, sp, rp in ((f2, f1, p2, p1), (f1, f2, p1, p2)):
        got = stereo.fused_volume(src, ref, sp, rp, depth)
        want = stereo.fused_volume_plain(src, ref, sp, rp, depth)
        assert got.shape == want.shape == (B, C, D, Hv, Wv) and got.dtype == dtype
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
        assert got.stride() == want.stride() and not got.is_contiguous()
        rows, plain = got.permute(0, 2, 3, 4, 1), want.permute(0, 2, 3, 4, 1)
        assert rows.is_contiguous() and plain.is_contiguous()
        assert torch.equal(rows.view(ints), plain.view(ints))
        del got, want, rows, plain


def parity_unet(dtype, dev):
    """The published network's U-Net (32 channels in, base 8) on seeded
    weights, in eval mode, and a fused volume of the parity cell's shape
    (B, C, D, H, W) = (16, 32, 24, 224, 224) as K2 writes it, channels-last."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    net = stereo.CostRegNet(32, base=8, dtype=dtype)
    net = stereo.flax_init_(net, torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randn(16, 24, 224, 224, 32, generator=g, device=dev).to(dtype)
    return net, rows.permute(0, 4, 1, 2, 3)


def test_parity_unet_channels_last_agrees_with_ncdhw_on_card(cuda, monkeypatch):
    """The bf16 U-Net at the parity cell's shape on the channels-last volume
    (``prob`` as K7) against the same U-Net on the contiguous NCDHW volume (the
    layout before, ``prob`` as cuDNN's), with cuDNN's deterministic
    algorithms. Every module's output stays channels-last. Tolerance: the two
    runs are the same bf16 math (f32 accumulation, one rounding a layer)
    summed in another order, which flips
    a bf16 rounding only where an f32 sum lies on a rounding boundary; so they
    must agree far better than bf16 agrees with f32: the gap between the
    layouts is at most a quarter of the bf16 U-Net's mean gap from its f32
    twin (TF32 off) and at most its largest gap."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    net, vol = parity_unet(torch.bfloat16, cuda)
    assert stereo.unet_input(vol).data_ptr() == vol.data_ptr()     # no copy of K2's volume
    seen = {}
    with torch.inference_mode():
        ncdhw = net(vol.contiguous()).float()
        for name, mod in net.named_modules():
            if name:
                mod.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(
                    name, o.is_contiguous(memory_format=torch.channels_last_3d)))
        ndhwc = net(stereo.unet_input(vol))
        assert ndhwc.is_contiguous(memory_format=torch.channels_last_3d)
        ndhwc = ndhwc.float()
        twin = stereo.CostRegNet(32, base=8).to(cuda).eval()
        twin.load_state_dict(net.state_dict())
        f32 = twin(vol.float().contiguous())
    assert len(seen) == 31 and all(seen.values()), seen
    layout, bf16 = (ndhwc - ncdhw).abs(), (ncdhw - f32).abs()
    msg = (f"layouts part by mean {layout.mean().item():.3e} max {layout.max().item():.3e}; "
           f"bf16 from f32 mean {bf16.mean().item():.3e} max {bf16.max().item():.3e}")
    print(msg)
    assert layout.mean() <= 0.25 * bf16.mean(), msg
    assert layout.max() <= bf16.max(), msg


def test_parity_unet_launches_no_layout_conversion_or_direct_dgrad(cuda):
    """Each module of the bf16 U-Net at the parity cell's shape, profiled on
    its own input as the channels-last forward hands it (the volume from
    ``unet_input``): no cuDNN layout conversion (``nchwToNhwc``,
    ``nhwcToNchw``) and no direct-dgrad fallback (``dgrad2d_grouped_direct``)
    for the transposed convolutions. ``prob``, the one-output-channel
    convolution, runs as K7 alone: none of cuDNN's kernels, so neither its
    FFMA ``implicit_convolveNd_sgemm`` nor the conversion of the filter it
    took in NCDHW."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    net, vol = parity_unet(torch.bfloat16, cuda)
    inputs = {}
    for name, mod in net.named_children():
        mod.register_forward_pre_hook(lambda m, a, name=name: inputs.__setitem__(name, a[0]))
    conversions = ("dgrad2d_grouped_direct", "nchwToNhwc", "nhwcToNchw")
    with torch.inference_mode():
        net(stereo.unet_input(vol))
        assert len(inputs) == 11
        for name, mod in net.named_children():
            x = inputs[name]
            assert x.is_contiguous(memory_format=torch.channels_last_3d), name
            mod(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mod(x)
                torch.cuda.synchronize()
            kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA}
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
            print(name, [(k[:90], round(ms, 3)) for k, ms in top])
            bad = {k: ms for k, ms in kernels.items() if any(c in k for c in conversions)}
            assert kernels and not bad, (name, bad, top)
            if name == "prob":
                assert list(kernels) == [k for k in kernels if "prob_conv3d_kernel" in k], top


@pytest.mark.parametrize("over,dtype,volumes", [
    ({"volume_scale": 1, "warp_mode": "bilinear"}, torch.bfloat16, 2),
    ({}, torch.bfloat16, 2),
    ({"volume_scale": 1, "warp_mode": "bilinear"}, torch.float32, 0)],
    ids=["parity-k2-bf16", "paper-eager-bf16", "parity-k2-f32"])
def test_each_traced_estimate_counts_two_ndhwc_volumes_on_card(cuda, over, dtype, volumes):
    """``ndhwc_volumes`` in ``stereo/cost_reg`` reads 2 for each traced bf16
    estimate on the card, through K2 (the parity configuration) and through
    the eager warp (the paper configuration); in f32 the U-Net runs NCDHW on
    the card (``stereo.unet_input``) and it reads 0. ``k7_launches`` reads the
    same: each bf16 U-Net's ``prob`` runs as K7, the f32 one's as cuDNN's."""
    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.utils.logger import SPANS

    cfg = load_group("pose_estimator", "adapose_cabinet", {"load": False, **over})
    est = AdaPoseEstimator(cfg, device=cuda, seed=0, dtype=dtype)
    args = [torch.from_numpy(a).to(cuda) for a in estimate_args(2, seed=3)]
    est.estimate_full(*args)
    SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(3):
                est.estimate_full(*args)
            torch.cuda.synchronize()
        s = SPANS.summary()
    finally:
        SPANS.reset()
    assert s["stereo/cost_reg"]["calls"] == 3
    assert s["stereo/cost_reg"].get("ndhwc_volumes", 0) == volumes
    assert s["stereo/cost_reg"].get("k7_launches", 0) == volumes


# ---------------------------------------------------- K7, the prob convolution --
def k7_input(shape, kind, dev, seed):
    """A (B, 8, D, H, W) bf16 volume in the channels-last-3d layout, and a
    (1, 8, 3, 3, 3) f32 filter of the flax init's scale. ``kind``: "relu"
    (the U-Net's own activations are sums of ReLUs: no sign), "randn" (either
    sign, so more outputs cancel), or "faces": randn on each sample's six
    faces and zero inside, so that every nonzero output reads the halo."""
    B, C, D, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(B, D, H, W, C, generator=g, device=dev)
    if kind == "relu":
        rows = rows.relu()
    elif kind == "faces":
        inner = torch.zeros(D, H, W, dtype=torch.bool, device=dev)
        inner[1:-1, 1:-1, 1:-1] = True
        rows[:, inner] = 0
    w = torch.randn(1, C, 3, 3, 3, generator=g, device=dev) / 216 ** 0.5
    return rows.to(torch.bfloat16).permute(0, 4, 1, 2, 3), w


@pytest.mark.parametrize("shape,kind", [
    ((16, 8, 24, 224, 224), "relu"), ((16, 8, 24, 112, 112), "relu"),
    ((128, 8, 16, 24, 24), "relu"), ((3, 8, 5, 17, 29), "randn"), ((1, 8, 1, 1, 1), "randn"),
    ((2, 8, 7, 33, 15), "randn"), ((2, 8, 6, 40, 36), "faces"), ((4, 8, 3, 2, 70), "faces")],
    ids=["parity", "paper", "fast", "ragged", "one-voxel", "ragged-33-rows", "faces",
         "faces-thin"])
def test_k7_kernel_matches_the_f64_reference(cuda, shape, kind):
    """K7 and cuDNN's bf16 convolution of the same channels-last volume and
    bf16-rounded filter, each against the convolution accumulated in f64 and
    rounded once to bf16 (``prob_conv.reference_gaps``): every K7 output
    within the larger of 1 bf16 ulp of the reference and cuDNN's own largest
    error, and at least 99% of them equal to it. Both sum the same exact
    products in f32 in their own orders, so an output rounds apart only near a
    bf16 rounding boundary or where its terms cancel. The cells' shapes,
    ragged shapes that end inside the kernel's 32-row by 16-column tile in
    both directions, one voxel, and volumes whose data sit on the six faces of
    each sample of the batch. Inside a traced span the call counts one
    ``k7_launches``."""
    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.ops import prob_conv
    from rgbmanip_tpu_torch.utils.logger import SPANS, span

    x, w = k7_input(shape, kind, cuda, seed=sum(shape))
    SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), span("k7"):
            with torch.inference_mode():
                out = prob_conv.prob_conv3d(x, w)
        torch.cuda.synchronize()
        s = SPANS.summary()
    finally:
        SPANS.reset()
    assert s["k7"].get("k7_launches", 0) == 1
    with torch.inference_mode():
        assert out.shape == (shape[0], 1, *shape[2:]) and out.dtype == torch.bfloat16
        assert out.is_contiguous() and torch.isfinite(out.float()).all()
        gaps = prob_conv.reference_gaps(out, x, w)
    print(shape, kind, gaps)
    assert gaps["held"], gaps


@pytest.mark.parametrize("dtype,grad,launches", [
    (torch.bfloat16, False, 1), (torch.bfloat16, True, 0), (torch.float32, False, 0)],
    ids=["bf16-no-grad", "bf16-grad", "f32"])
def test_k7_launches_once_a_bf16_unet_forward_without_gradient(cuda, dtype, grad, launches):
    """One U-Net forward on the card inside a traced span: ``k7_launches``
    reads 1 for a bf16 forward under ``no_grad`` on the channels-last volume
    (``unet_input``), 0 for one that records a gradient (the trainer's bf16
    step), and 0 in f32 (NCDHW)."""
    from torch.profiler import ProfilerActivity, profile

    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
    from rgbmanip_tpu_torch.utils.logger import SPANS, span

    net = stereo.CostRegNet(32, base=8, dtype=dtype)
    net = stereo.flax_init_(net, torch.Generator().manual_seed(0)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    vol = torch.randn(2, 8, 32, 32, 32, generator=g, device=cuda).to(dtype)
    vol = stereo.unet_input(vol.permute(0, 4, 1, 2, 3))
    SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            with torch.set_grad_enabled(grad), span("unet"):
                out = net(vol)
            if grad:
                out.float().sum().backward()
            torch.cuda.synchronize()
        s = SPANS.summary()
    finally:
        SPANS.reset()
    assert s["unet"]["calls"] == 1
    assert s["unet"].get("k7_launches", 0) == launches
