"""The benchmark's operation and byte counts against hand counts."""

import torch
from torch import nn

from portbench.counts import flops, k1
from portbench.reference import net as RN


def hand_count(est_cfg, B):
    """2 x multiply-adds of every convolution, transposed convolution and
    dense layer of the reference, from the shapes its forward sees, and the
    two warps' relative projections (4 x 4 products) and 3 x 3 ray rotations."""
    total = [0]

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, nn.ConvTranspose3d):
            total[0] += 2 * x.numel() * mod.out_channels * mod.weight[0, 0].numel()
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            total[0] += 2 * out.numel() * mod.in_channels * mod.weight[0, 0].numel()
        elif isinstance(mod, nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
    S, N, D = est_cfg["img_size"], est_cfg["n_pts"], est_cfg["n_depth"]
    with torch.device("meta"):
        net = RN.StereoPoseNet(est_cfg["backend"], est_cfg["backbone_stride"],
                               est_cfg["volume_scale"], est_cfg["warp_mode"]).eval()
        for m in net.modules():
            m.register_forward_hook(hook)
        img = torch.empty(B, S, S, 3)
        choose = torch.zeros(B, N, dtype=torch.long)
        proj = torch.eye(4).repeat(B, 1, 1)
        net(img, choose, img, choose, proj, proj, torch.empty(B, D))
    Sv = S // est_cfg["volume_scale"]
    return total[0] + 2 * (2 * B * 4 * 4 * 4 + 2 * B * 3 * 3 * Sv * Sv)


def test_estimate_flops_match_a_hand_count():
    cfg = dict(img_size=64, n_pts=32, backend="resnet18", backbone_stride=32,
               volume_scale=8, n_depth=8, warp_mode="nearest")
    assert flops.estimate_flops(cfg, 2) == hand_count(cfg, 2)


def test_mlp_flops():
    hand = 2 * 8 * (60 * 96 + 96 * 96 + 96 * 32 + 32 * 12)
    assert flops.mlp_flops([60, 96, 96, 32, 12], 8) == hand


def test_k1_bytes_by_hand():
    # a 40 px window at (100, 200) resampled to 4 x 4: source rows 104.5, 114.5, ...
    # each between two rows with weight 1/2, so 8 rows and 8 columns are read
    mask = torch.zeros(1, 480, 640, dtype=torch.bool)
    mask[0, 100:139, 200:239] = True
    nbytes, ops = k1.view_work(mask, 4, torch.float32)
    assert nbytes == 8 * 8 * 12 + 4 * 4 * 3 * 4 + 12
    assert ops == 4 * 4 * 3 * 11
    assert k1.view_work(mask, 4, torch.bfloat16)[0] == 8 * 8 * 12 + 4 * 4 * 3 * 2 + 12
