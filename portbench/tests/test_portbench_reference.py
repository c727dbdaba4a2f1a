"""The plain reference against the program at a tiny size on the CPU: the
estimate (preprocessing, network, solve) on seeded weights at both
configurations' knobs, the checkpoint reader, the policy's action and the
fusion of per-step estimates."""

import numpy as np
import pytest
import torch

from portbench import harness as H
from portbench.drivers import estimate as E
from portbench.reference import net as RN
from portbench.reference import policy as RP
from portbench.reference import weights as RW

TINY = {"fast": dict(img_size=64, n_pts=128, backend="resnet18", backbone_stride=32,
                     volume_scale=8, n_depth=16),
        "paper": dict(img_size=32, n_pts=64, backend="resnet34", backbone_stride=8,
                      volume_scale=2, n_depth=8)}


@pytest.mark.parametrize("knobs", sorted(TINY))
def test_reference_estimate_matches_the_program(knobs):
    cfg = H.load_json(H.HERE, "configs", "adapose_cabinet.json")
    cfg.update(TINY[knobs])
    wl = dict(H.load_json(H.HERE, "workloads", "paper.estimate_b16.json"), batch=3, pool=1)
    dev = torch.device("cpu")
    x = E.inputs(wl, 2 ** 33 + 7, dev)[0]
    est = E.program(cfg, torch.float32, 5, dev)
    est.generator = torch.Generator().manual_seed(99)
    prog = E.call(est, x)
    u1, u2 = E.draws(cfg, 3, 99, dev)
    ref = E.reference_outputs(E.reference_net(cfg, 5, dev), cfg, x, u1, u2)
    assert prog["valid"].all() and (prog["valid"] == ref["valid"]).all()
    for k in ("bbox", "R_cam", "t_cam", "scale"):
        np.testing.assert_allclose(prog[k], ref[k], rtol=1e-4, atol=1e-5)
    assert E.compare([(prog, ref)])["bbox_gap_max"] < 1e-4


def test_checkpoint_reader_matches_the_program_loader():
    cfg = H.load_json(H.HERE, "configs", "adapose_cabinet_fast.json")
    est = E.program(cfg, torch.float32, 0, torch.device("cpu"))
    ref = E.reference_net(cfg, 0, torch.device("cpu"))
    mine, theirs = ref.state_dict(), est.model.state_dict()
    for k, v in mine.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, theirs[k]), k


def test_seeded_weights_are_the_seeds():
    net = RN.StereoPoseNet("resnet18", 32, 8, "nearest")
    a, b = (RW.seeded_state(net, 7, "cpu") for _ in range(2))
    c = RW.seeded_state(net, 8, "cpu")
    k = "img_extractor.feats.conv1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert abs(a[k].std().item() - (3 * 49) ** -0.5) < 0.1 * (3 * 49) ** -0.5


def test_reference_policy_matches_the_program():
    from rgbmanip_tpu_torch.algo.ppo import PPOPolicy
    path = f"{H.ROOT}/checkpoints/ppo_rl_coadapt_model_165.ckpt"
    pol = PPOPolicy.from_checkpoint(path, device="cpu")
    layers = RP.actor_layers(RW.read_checkpoint(path), "cpu")
    obs = np.random.default_rng(0).normal(size=(8, layers[0][0].shape[1])).astype(np.float32)
    ref = RP.act(layers, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(pol.act_inference(obs), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_reference_fusion_matches_the_program(seed):
    from rgbmanip_tpu_torch.models.controller.rl_pose import consensus_fuse
    rng = np.random.default_rng(seed)
    M, N = 5, 8
    centre = rng.normal(size=(1, N, 1, 3)) * 0.3
    boxes = (centre + rng.normal(size=(M, N, 8, 3)) * 0.02
             + rng.normal(size=(M, N, 1, 3)) * 0.05).astype(np.float32)
    boxes[rng.random((M, N)) < 0.15] += 10.0          # sentinels
    ok = rng.random((M, N)) < 0.7
    np.testing.assert_array_equal(consensus_fuse(boxes, 4, stereo_ok=ok),
                                  RP.consensus_fuse(boxes, 4, ok))
