"""The port on the card: the CUDA kernels against their plain PyTorch
versions, and the estimates (flagship and paper-size) and the policy on the
card against the CPU.

These tests need an NVIDIA card and skip without one (a CUDA kernel has no
CPU mode), but for one that holds the port's CPU bf16 path on that
machine's PyTorch and runs anywhere. The file imports neither JAX nor the JAX package, so it runs on
the machine with the card:  python -m pytest tests/test_torch_cuda.py -q
"""

import os

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


@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("S_out", [64, 192, 224, 65])
def test_k1_kernel_equals_plain_over_the_window_sweep(cuda, S_out, B):
    """f32 bit for bit (the same operations, rounded at the same places);
    bf16 within one bf16 ulp of the f32 plain version. S = 65 makes a row of
    S * 3 values that is not a whole number of 4-value vectors."""
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
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
        assert ((out16.float() - ref).abs() <= ulp).all()


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
    from rgbmanip_tpu_torch.ops.preprocess import mask_bbox_batched, square_window_batched
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
    mask = torch.from_numpy(cam["Mask"]).to(cuda)
    y1, x1, y2, x2, _ = mask_bbox_batched(mask.float())
    rmin, rmax, cmin, _ = square_window_batched(y1, x1, y2, x2, H, W)
    inv = (rmax - rmin).float() * torch.tensor(1.0 / S, device=cuda)
    out = k1.crop_resize_normalize(rgb, rmin.float(), cmin.float(), inv, S)
    ref = k1.crop_resize_normalize_plain(rgb, rmin.float(), cmin.float(), inv, S)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


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


HEURISTIC_POT = ["dataset=pot_test", "task=open_pot", "manipulation=open_pot",
                 "pose_estimator=adapose_pot_fast", "controller=heuristic_pose",
                 "train=test", "task.num_envs=2", "train.total_round=2", "seed=11"]


def heuristic_round(device, draws, drive=None):
    """One round of heuristic + AdaPose on the pot through ``train``'s
    functions on ``device``. Each estimate takes its point-sampling draws
    from ``draws`` (made on the CPU on the first run, replayed on the
    second); with ``drive`` (the first run's record) the skill acts on the
    first run's bbox."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.utils.logger import get_logger

    cfg = load_config(HEURISTIC_POT + [f"device={device.type}"])
    log = get_logger()
    gen = torch.Generator().manual_seed(3)
    rec = {"calls": []}
    env = T.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = T.prepare_manipulation(env, cfg["manipulation"], log)
        est = T.prepare_pose_estimator(env, cfg["pose_estimator"], log, device)
        ctrl = T.prepare_controller(env, est, manip, cfg["controller"], cfg, log,
                                    device=device)
        estimate, inner = est.estimate, est._estimate

        def drawn(*args):
            i = len(rec["calls"])
            if i == len(draws):
                n = est.img_size ** 2
                draws.append([torch.rand(args[1].shape[0], n, generator=gen)
                              for _ in range(2)])
            return inner(*args[:7], *(u.to(args[1].device) for u in draws[i]))

        def recorded(*args):
            bbox = estimate(*args)
            rec["calls"].append(([np.array(a) for a in args], bbox))
            return drive["calls"][len(rec["calls"]) - 1][1] if drive else bbox
        est._estimate, est.estimate = drawn, recorded
        before = k1.crop_resize_normalize.launches
        rec["result"] = T.test(env, ctrl, cfg, log)
        rec["launches"] = k1.crop_resize_normalize.launches - before
    finally:
        env.close()
    return rec


def test_heuristic_pot_round_on_card_matches_cpu(cuda):
    """The same views bit for bit (fixed viewpoints, the host simulator),
    K1 twice per estimate on the card, the estimate within 1e-3 m of the
    CPU's (f32, TF32 off; cuDNN and the CPU sum in another order), and the
    same success and move distance with both skills on the card's bbox."""
    draws = []
    card = heuristic_round(cuda, draws)
    cpu = heuristic_round(torch.device("cpu"), draws, drive=card)
    assert len(card["calls"]) == len(cpu["calls"]) == 1
    assert card["launches"] == 2 and cpu["launches"] == 0
    (args, bbox), (ref_args, ref_bbox) = card["calls"][0], cpu["calls"][0]
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a, b)
    assert (np.abs(ref_bbox).max(axis=(1, 2)) < 8.0).all(), "a sentinel estimate"
    np.testing.assert_allclose(bbox, ref_bbox, rtol=0, atol=1e-3)
    assert card["result"] == cpu["result"]


def test_inference_batch_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``inference.main`` at its defaults (the estimator's default
    architecture on weights made from its seed) over pairs that ``train=collect`` wrote, on
    the card and on the CPU with the same point-sampling draws: K1 twice per
    batch on the card, every bbox within 1e-3 m."""
    from rgbmanip_tpu_torch import train as T
    from rgbmanip_tpu_torch.models.pose_estimator import adapose
    from rgbmanip_tpu_torch.models.pose_estimator import inference

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
            bboxes.append(out[0].cpu().numpy())
            return out
    monkeypatch.setattr(adapose, "AdaPoseEstimator", Drawn)
    out = {}
    for d in ("cuda", "cpu"):
        before = k1.crop_resize_normalize.launches
        out[d] = inference.main(["--data_root", data, "--device", d])
        assert k1.crop_resize_normalize.launches - before == (2 if d == "cuda" else 0)
    assert out["cuda"]["n"] == out["cpu"]["n"] == 2 and len(bboxes) == 2
    assert (np.abs(bboxes[1]).max(axis=(1, 2)) < 8.0).all(), "a sentinel estimate"
    np.testing.assert_allclose(bboxes[0], bboxes[1], rtol=0, atol=1e-3)


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


# ------------------------------------------------------------ bf16 and the generations --
FAST = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"


def estimate_args(B, seed):
    """``_estimate``'s (K, rgb1, mask1, ext1, rgb2, mask2, ext2) of ``scene``."""
    K, rgb, mask, ext = scene(B, seed)
    return K, rgb[0], mask[0], ext[0], rgb[1], mask[1], ext[1]


def test_bf16_estimate_on_card_matches_cpu(cuda):
    """The flagship estimate in bf16 (``evaluate``'s default) at B=4: K1
    twice, both its bf16 entry point; equal valid flags and the
    world bbox within twice the CPU's own bf16-to-f32 gap of the CPU's bf16
    estimate (both bf16 convolution libraries part in the last bits: see
    tests/test_torch_precision.py); and on the card at least half that gap
    (mean) from the card's own f32 estimate, as a card that ran f32 would
    not be."""
    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": FAST})
    args = estimate_args(4, seed=3)
    g = torch.Generator().manual_seed(1)
    u = [torch.rand(4, S * S, generator=g) for _ in range(2)]
    out = {}
    for name, d, dt in (("card", cuda, torch.bfloat16), ("card f32", cuda, torch.float32),
                        ("cpu", torch.device("cpu"), torch.bfloat16),
                        ("cpu f32", torch.device("cpu"), torch.float32)):
        est = AdaPoseEstimator(cfg, device=d, dtype=dt)
        before = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16)
        b, v, _ = est._estimate(*(torch.from_numpy(a).to(d) for a in args), *(x.to(d) for x in u))
        after = (k1.crop_resize_normalize.launches, k1.crop_resize_normalize.launches_bf16)
        if name == "card":
            assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
        out[name] = (b.cpu().numpy(), v.cpu().numpy())
    ok = out["cpu"][1]
    assert ok.any()
    np.testing.assert_array_equal(out["card"][1], ok)
    gap = np.abs(out["cpu"][0] - out["cpu f32"][0])[ok]
    assert np.abs(out["card"][0] - out["cpu"][0])[ok].max() <= 2 * gap.max()
    assert np.abs(out["card"][0] - out["card f32"][0])[ok].mean() >= 0.5 * gap.mean()


def test_bf16_estimator_training_step_on_card_matches_cpu(cuda):
    """One bf16 ``EstimatorTrainer`` step (``train_estimator.main``'s
    default) from the committed head: each loss part within twice the CPU's
    own bf16-to-f32 difference of it (at least 1e-2 relative: both bf16 runs
    are rounded copies of the f32 one), and the card's summed bf16-to-f32
    difference at least half the CPU's (a card that ran f32 would show
    none); the gradient's cosine with the CPU's 0.9 or more; BatchNorm
    running statistics within 1e-2 of their largest, parameters within two
    learning rates and rounding."""
    from rgbmanip_tpu_torch.models.pose_estimator.converter import to_jax_params
    from rgbmanip_tpu_torch.models.pose_estimator.training import EstimatorTrainer
    from rgbmanip_tpu_torch.utils.checkpoint import flatten

    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"checkpoint_path": FAST})
    batch = estimator_batch(torch.device("cpu"))
    out = {}
    for name, d, dt in (("card", cuda, torch.bfloat16), ("card f32", cuda, torch.float32),
                        ("cpu", torch.device("cpu"), torch.bfloat16),
                        ("cpu f32", torch.device("cpu"), torch.float32)):
        est = AdaPoseEstimator(cfg, device=d, dtype=dt)
        trainer = EstimatorTrainer(est.model, lr=1e-4)
        _, parts = trainer.step({k: v.to(d) for k, v in batch.items()})
        grad = torch.cat([p.grad.reshape(-1).cpu() for p in est.model.parameters()
                          if p.grad is not None])
        out[name] = (parts, [flatten(t) for t in to_jax_params(est.model)], grad)
    c16, c32, g16, g32 = (out[k][0] for k in ("cpu", "cpu f32", "card", "card f32"))
    for k in c16:
        bound = max(2 * abs(c16[k] - c32[k]) / abs(c32[k]), 1e-2)
        assert abs(g16[k] - c16[k]) <= bound * abs(c16[k]), k
    own = sum(abs(g16[k] - g32[k]) / abs(g32[k]) for k in c16)
    assert own >= 0.5 * sum(abs(c16[k] - c32[k]) / abs(c32[k]) for k in c16)
    ga, gb = out["card"][2], out["cpu"][2]
    assert ga.shape == gb.shape
    assert float(ga @ gb / ga.norm() / gb.norm()) >= 0.9
    (gp, gs), (cp, cs) = out["card"][1], out["cpu"][1]
    for k in cs:
        assert np.abs(gs[k] - cs[k]).max() <= 1e-2 * (np.abs(cs[k]).max() + 1e-6), k
    assert max(float(np.abs(gp[k] - cp[k]).max()) for k in cp) <= 2.1e-4


@pytest.mark.parametrize("version,over", [("v3", {}), ("baseline", {}),
                                          ("v5", {"volume_channels": 8})])
def test_generation_on_card_matches_cpu(cuda, version, over):
    """A generation of ``make_estimator`` at B=4 on seeded weights (the
    flagship's knobs, 192 px): the same RANSAC hypotheses and draws on both,
    equal valid flags and the world bbox within 1e-3 m."""
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
        b, v, _ = est._estimate(*(torch.from_numpy(a).to(d) for a in args),
                                *(x.to(d) for x in u), idx.to(d))
        out[d.type] = (b.cpu().numpy(), v.cpu().numpy())
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-3)


RL_MANIP = ["dataset=cabinet_train", "task=open_cabinet", "manipulation=open_cabinet",
            "task.num_envs=2", "seed=11"]


def rl_manipulation_iteration(device, save_dir, init=None, actions=None):
    """One ``RLManipulation`` iteration (2 envs x 4 transitions) on
    ``device`` with the learn and policy blocks of ``controller/rl.yaml``;
    from ``init`` (a state dict) and by ``actions`` where given. Returns
    (initial state dict, storage, final parameters, lr)."""
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
        return start, storage, params, ppo.lr
    finally:
        env.close()


def test_rl_manipulation_iteration_on_card_matches_cpu(cuda, tmp_path):
    """``RLManipulation`` on the card, then on the CPU from the card's
    initial weights and by its actions: the rollout equal (the simulator is
    bit-equal), means within 1e-5, values and log-probabilities within
    1e-4, the learning rate equal and the parameters after the update
    within 2e-5 (actor) and 2e-4 (critic), as chip_smoke.py phase 12 holds
    the camera scheduler's update."""
    start, card, cp, clr = rl_manipulation_iteration(cuda, tmp_path / "card")
    _, cpu, hp, hlr = rl_manipulation_iteration(torch.device("cpu"), tmp_path / "cpu",
                                                init=start, actions=card["actions"])
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
    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"load": False})
    g = torch.Generator().manual_seed(4)
    u = [torch.rand(1, S * S, generator=g) for _ in range(2)]
    for m1, sentinel in ((i1["Mask"], False), (np.zeros_like(i1["Mask"]), True)):
        args = (i1["Intrinsic"], i1["Color"], m1, i1["Extrinsic"], i2["Color"], i2["Mask"],
                i2["Extrinsic"])
        out = {}
        for d in (cuda, torch.device("cpu")):
            est = make_estimator("realworld", cfg, device=d)
            before = k1.crop_resize_normalize.launches
            b, v, _ = est._estimate(*(torch.from_numpy(np.asarray(a)).to(d) for a in args),
                                    *(x.to(d) for x in u))
            assert k1.crop_resize_normalize.launches - before == (2 if d.type == "cuda" else 0)
            out[d.type] = (b.cpu().numpy(), v.cpu().numpy())
        np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-3)
        assert (out["cuda"][0] >= 9.0).all() == sentinel


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
    defaults, B=2, 224 px) on the card against the CPU, per output: the
    mean |card - CPU| of the bf16 forwards within twice the CPU's own mean
    bf16-to-f32 difference, and the card's own bf16-to-f32 difference at
    least half the CPU's (``chip_smoke.py`` phase 20's rule)."""
    from rgbmanip_tpu_torch import graft_entry

    def run(device):
        forward, args = graft_entry.entry(device=device)
        net = graft_entry.flagship_net(torch.float32, device)
        with torch.no_grad():
            out32 = net(*args)
        out16 = forward(*args)
        return ([o.float().cpu() for o in out16],
                [out32[n].float().cpu() for n in ("view1_nocs", "view1_depth", "view1_r")],
                out16)

    card16, card32, raw = run(cuda)
    assert [o.dtype for o in raw] == [torch.bfloat16, torch.float32, torch.bfloat16]
    assert all(o.is_cuda and torch.isfinite(o.float()).all() for o in raw)
    cpu16, cpu32, _ = run(torch.device("cpu"))
    for c16, c32, p16, p32 in zip(card16, card32, cpu16, cpu32):
        gap = float((p16 - p32).abs().mean())
        assert float((c16 - p16).abs().mean()) <= 2 * gap
        assert float((c16 - c32).abs().mean()) >= 0.5 * gap


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
    """``eval_sweep``'s gt stack (no network) gives the same row with
    ``device=cuda`` as with ``device=cpu``; the committed JSON is not read
    or written (the sweep writes ``docs/sweep_torch_*`` under the working
    directory)."""
    from rgbmanip_tpu_torch.scripts import eval_sweep

    rows = [("open_drawer", "open_drawer", [("test", "drawer_test")])]
    monkeypatch.setattr(eval_sweep, "ROWS", rows)
    out = {}
    for name in ("cuda", "cpu"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out[name] = eval_sweep.main(["8", "gt_pose", "ground_truth", f"device={name}"])
        assert os.path.exists("docs/sweep_torch_gt_pose_ground_truth.json")
    assert out["cuda"]["results"] == out["cpu"]["results"]
    assert out["cuda"]["results"]["open_drawer/test"]["episodes"] == 8


def test_a_learned_sweep_row_launches_k1(cuda, monkeypatch, tmp_path):
    """A heuristic + AdaPose row of the sweep (pot) runs its estimate on the
    card through K1: one estimate of the batch, K1 twice."""
    from rgbmanip_tpu_torch.scripts import eval_sweep
    from rgbmanip_tpu_torch.utils.logger import get_logger

    rows = [("open_pot", "open_pot", [("test", "pot_test")])]
    monkeypatch.chdir(tmp_path)
    k1.crop_resize_normalize.launches = 0
    res = eval_sweep.sweep(rows, 8, "heuristic_pose", "adapose_pot_fast", ["device=cuda"],
                           get_logger())
    assert "error" not in res["open_pot/test"], res
    assert res["open_pot/test"]["episodes"] == 8
    assert k1.crop_resize_normalize.launches == 2


# the bench's knobs on the flagship head (the same architecture as the
# bench's own ``estimator_fast_cabinet_r2.ckpt``, which these tests need not read)
BENCH_HEAD = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"


@pytest.mark.parametrize("raised", [False, True], ids=["own-views", "view2-raised"])
def test_bench_estimate_on_card_matches_cpu(cuda, raised):
    """``rgbmanip_tpu_torch.bench``'s estimate at B=8 in f32: its inputs, made
    on the card, and the same point draws on the card and on the CPU, bbox
    within 1e-3 m and equal valid flags, on the bench's own views and with
    the second camera raised 1 mm (``chip_smoke.bench_card_against_cpu``,
    which phase 22 runs). On the own views the cost volume's first and last
    rows sit on a rounding tie at the source's border, which the CPU's run
    takes from the card's after checking that no other ray's decision
    differs; raised, no ray is on a tie."""
    import sys

    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from rgbmanip_tpu_torch import bench

    ests = {k: bench.estimator(BENCH_HEAD, torch.float32, d)
            for k, d in (("card", cuda), ("cpu", torch.device("cpu")))}
    bdiff, n_valid, taken = chip_smoke.bench_card_against_cpu(np, torch, ests, 8, raised)
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
    against the same U-Net on the contiguous NCDHW volume (the layout before),
    with cuDNN's deterministic algorithms. Every module's output stays
    channels-last. Tolerance: the two runs are the same bf16 math (f32
    accumulation, one rounding a layer) summed in another order, which flips
    a bf16 rounding only where an f32 sum lies on a rounding boundary; so they
    must agree far better than bf16 agrees with f32: the gap between the
    layouts is at most a quarter of the bf16 U-Net's mean gap from its f32
    twin (TF32 off) and at most its largest gap."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    net, vol = parity_unet(torch.bfloat16, cuda)
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
    ``nhwcToNchw``) of an activation and no direct-dgrad fallback
    (``dgrad2d_grouped_direct``) for the transposed convolutions. The one
    exception is ``prob``, the one-output-channel convolution, whose cuDNN
    kernel (not a tensor-core one) takes its 216-value filter in NCDHW: that
    conversion is allowed, and told from one of an activation by its time,
    under 10 us, where converting even ``prob``'s 38 MB output would take
    over 20 us at the card's memory bandwidth."""
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
            if name == "prob":
                bad = {k: ms for k, ms in bad.items() if "nhwcToNchw" not in k or ms >= 0.01}
            assert kernels and not bad, (name, bad, top)


@pytest.mark.parametrize("over,dtype,volumes", [
    ({"volume_scale": 1, "warp_mode": "bilinear"}, torch.bfloat16, 2),
    ({}, torch.bfloat16, 2),
    ({"volume_scale": 1, "warp_mode": "bilinear"}, torch.float32, 0)],
    ids=["parity-k2-bf16", "paper-eager-bf16", "parity-k2-f32"])
def test_each_traced_estimate_counts_two_ndhwc_volumes_on_card(cuda, over, dtype, volumes):
    """``ndhwc_volumes`` in ``stereo/cost_reg`` reads 2 for each traced bf16
    estimate on the card, through K2 (the parity configuration) and through
    the eager warp (the paper configuration); in f32 the U-Net runs NCDHW on
    the card (``stereo.unet_input``) and it reads 0."""
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
