"""The port on the card: the CUDA kernels against their plain PyTorch
versions, and the estimates (flagship and paper-size) and the policy on the
card against the CPU.

These tests need an NVIDIA card and skip without one (a CUDA kernel has no
CPU mode). The file imports neither JAX nor the JAX package, so it runs on
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
