"""Each configuration names its estimator generation's plain reference
(``harness.reference``): the three configurations of ``BENCHMARK.json`` take
v5 with the flop counts and seeded weights they had before the key existed;
a v1 configuration (``reference/v1.py``: the original network, NOCS-match
triangulation and DLT PnP) holds the program's ``arch="v1"`` estimate on the
CPU, and runs through ``drivers/estimate.py``'s ``run`` and ``readings``; a name
that is no reference fails with that name."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from portbench import harness as H
from portbench.counts import flops
from portbench.drivers import estimate as E
from portbench.reference import weights as RW

# the v1 network at its published widths (resnet34 PSPNet at stride 8, 224 px,
# the bilinear warp at full resolution into 24 planes 0.1 m apart, 1,024
# points); ``TINY_V1`` is its size for a test on the CPU
V1 = {"name": "adapose_v1", "reference": "v1", "arch": "v1", "task_name": "one_door_cabinet",
      "img_size": 224, "n_pts": 1024, "use_depth": False, "direct_regression": False,
      "real_world": False, "backend": "resnet34", "backbone_stride": 8, "volume_scale": 1,
      "n_depth": 24, "d_min": 0.1, "d_interval": 0.1, "warp_mode": "bilinear",
      "dtype_default": "bfloat16", "weights": {"seeded": True}}
TINY_V1 = dict(V1, img_size=64, n_pts=128, backend="resnet18", n_depth=8)
# the network's operations a view pair at each configuration (8.515, 127.0 and
# 163.7 GFLOP), as counted before configurations named their reference
PAIR_FLOPS = {"adapose_cabinet_fast": 8_514_890_240, "adapose_cabinet": 127_001_754_880,
              "adapose_cabinet_parity": 163_678_955_776}
CPU = torch.device("cpu")


def config(name):
    return H.load_json(H.HERE, "configs", f"{name}.json")


def parity_traffic(**kw):
    return dict(H.load_json(H.HERE, "workloads", "parity.estimate_b16.json"), **kw)


def seeded_state_by_key(net, seed):
    """``weights.seeded_state`` as it was: a BatchNorm scale found by the
    ``.bn.`` in its key."""
    state = net.state_dict()
    weights = [(k, v) for k, v in state.items() if k.endswith(".weight") and v.dim() >= 2]
    flat = torch.randn(sum(v.numel() for _, v in weights),
                       generator=torch.Generator().manual_seed(seed))
    out, at = {}, 0
    for k, v in weights:
        transposed = re.search(r"conv(7|9|11)\.conv\.weight$", k) is not None
        taps = v[0, 0].numel() if v.dim() > 2 else 1
        out[k] = flat[at:at + v.numel()].view(v.shape) * (
            (v.shape[0] if transposed else v.shape[1]) * taps) ** -0.5
        at += v.numel()
    for k, v in state.items():
        if k in out or k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var") or (k.endswith(".weight") and ".bn." in k):
            out[k] = torch.ones(v.shape)
        elif k.endswith(".weight"):
            out[k] = torch.full(v.shape, 0.25)
        else:
            out[k] = torch.zeros(v.shape)
    return out


@pytest.mark.parametrize("name", sorted(PAIR_FLOPS))
def test_existing_configurations_take_v5_as_before(name):
    cfg = config(name)
    assert "reference" not in cfg and H.reference(cfg) is H.reference({"reference": "v5"})
    assert flops.estimate_flops(cfg, 1) == PAIR_FLOPS[name]
    assert flops.estimate_flops(cfg, 3) == 3 * PAIR_FLOPS[name]
    net = H.reference(cfg).network(cfg)
    new, old = RW.seeded_state(net, 2 ** 40 + 3, CPU), seeded_state_by_key(net, 2 ** 40 + 3)
    assert new.keys() == old.keys()
    assert all(torch.equal(new[k], old[k]) for k in new), name


@pytest.mark.parametrize("name", ["v9", "net", "../harness", ""])
def test_a_name_that_is_no_reference_fails_with_that_name(name):
    with pytest.raises(ValueError, match=re.escape(repr(name))):
        H.reference({"reference": name})


def test_v1_seeded_state_draws_batch_norms_as_the_identity():
    net = H.reference(V1).network(TINY_V1)
    state = RW.seeded_state(net, 7, CPU)
    for i in range(3):
        assert torch.equal(state[f"volume_conv.bn_{i}.weight"], torch.ones(1 if i == 2 else 16 >> i))
        assert not state[f"volume_conv.bn_{i}.bias"].any()
    assert torch.equal(state["img_extractor.up_1.conv.1.weight"], torch.tensor([0.25]))


def hand_count(net, cfg, B):
    """2 x multiply-adds of every convolution and dense layer, from the
    shapes the forward sees, and the two warps' relative projections (4 x 4
    products) and ray rotations (3 x 3 over the S x S pixels)."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            total[0] += 2 * out.numel() * mod.in_channels * mod.weight[0, 0].numel()
        elif isinstance(mod, nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
    S, N, D = cfg["img_size"], cfg["n_pts"], cfg["n_depth"]
    with torch.device("meta"):
        net = net.eval()
        for m in net.modules():
            m.register_forward_hook(hook)
        img, choose = torch.empty(B, S, S, 3), torch.zeros(B, N, dtype=torch.long)
        proj = torch.eye(4).repeat(B, 1, 1)
        net(img, choose, img, choose, proj, proj, torch.empty(B, D))
    return total[0] + 2 * (2 * B * 4 * 4 * 4 + 2 * B * 3 * 3 * S * S)


def test_v1_flops_count_the_v1_network():
    with torch.device("meta"):
        net = H.reference(V1).network(TINY_V1)
    assert flops.estimate_flops(TINY_V1, 2) == hand_count(net, TINY_V1, 2)
    assert not any(isinstance(m, nn.ConvTranspose3d) for m in net.modules())   # no U-Net


@pytest.mark.parametrize("seed", [5, 7])
def test_v1_reference_matches_the_program(seed):
    """The program's ``AdaPoseEstimator(arch="v1")`` on the reference's seeded
    weights against the reference, both in float32 on the CPU.

    Tolerances: the two sides sum in other orders and solve other SVDs of
    the same systems, so they part by f32 round-off, which the solve's SVDs
    amplify: bbox and translation within 0.1 mm against boxes of decimetres
    (read: up to 0.06 mm), the scale within 1e-4 of itself (read: 2e-6), the
    rotation within 1e-3 (read: 4e-5) where the two views are apart. On a
    pair of one view seen twice (the evaluation's first step hands the
    estimator that) the cameras coincide: every ray meets the others at the
    camera centre, so the triangulated points are that centre to round-off,
    the scale is round-off (about 1e-4) and the rotation of so small an
    object is set by round-off alone; its box still agrees within 0.1 mm.
    ``valid`` is compared exactly."""
    wl = parity_traffic(batch=2, pool=1)
    x = E.inputs(wl, 2 ** 33 + 7, CPU)[0]
    apart = torch.linalg.norm((x["ext2"] @ torch.linalg.inv(x["ext1"]))[:, :3, 3], dim=-1) > 1e-3
    est = E.program(TINY_V1, torch.float32, seed, CPU)
    assert est.arch == "v1"
    est.generator = torch.Generator().manual_seed(99)
    prog = E.call(est, x)
    u1, u2 = E.draws(TINY_V1, 2, 99, CPU)
    ref = E.reference_outputs(E.reference_net(TINY_V1, seed, CPU), TINY_V1, x, u1, u2)
    assert (prog["valid"] == ref["valid"]).all()
    assert (ref["valid"] & apart.numpy()).any() and (~apart).any()
    np.testing.assert_allclose(prog["bbox"], ref["bbox"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(prog["t_cam"], ref["t_cam"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(prog["scale"], ref["scale"], rtol=1e-4, atol=0)
    np.testing.assert_allclose(prog["R_cam"][apart], ref["R_cam"][apart], rtol=0, atol=1e-3)


def test_v1_control_stands_above_the_program_on_the_cpu():
    """As ``test_portbench_control`` holds each cell: the v1 network in bf16
    under the parity cell's limits, against the fp8 control."""
    wl = parity_traffic(batch=4, pool=1, check_calls=1)
    r = E.readings(TINY_V1, wl, 5, CPU, 1)
    assert any(r["control"][k] >= 3 * r["program"][k] and r["control"][k] > 0
               for k in wl["limits"]), r


RUN = r"""
import json, sys, torch
from portbench import harness as H, run
spec = json.loads(sys.argv[1])
bench = H.load_json(H.ROOT, "BENCHMARK.json")
bench["workloads"].append(spec["entry"])
for m in bench["end_to_end"]:
    m.get("workloads", []).append(spec["entry"]["name"])
sys.exit(run.main(["--workload", spec["entry"]["name"], "--seed", str(2 ** 33 + 5),
                   "--seconds", "1", "--trace", "0"],
                  device=torch.device("cpu"), bench=bench, cfg=spec["cfg"], wl=spec["wl"]))
"""


def test_v1_cell_runs_end_to_end_on_the_cpu():
    """A cell of a v1 configuration, driven end to end on the CPU through
    ``run.main`` with no file of its own: the program builds the v1 network,
    the check recomputes with ``reference/v1.py``, and the result line
    carries the cell's end-to-end metrics and its checks."""
    entry = {"name": "v1.estimate_b16", "config": "adapose_v1", "traffic": "estimate_b16",
             "chips": 1, "why": "a v1 cell on the CPU"}
    wl = parity_traffic(batch=4, pool=2, warmup_calls=1, check_calls=2, dtype="float32")
    spec = {"entry": entry, "cfg": TINY_V1, "wl": wl}
    env = dict(os.environ, PYTHONPATH=H.ROOT, RGBMANIP_LOGLEVEL="ERROR")
    p = subprocess.run([sys.executable, "-c", RUN, json.dumps(spec)], cwd=H.ROOT,
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(out["metrics"]) == {"estimates_per_s", "estimate_p95_ms", "setup_s"}
    assert out["checks"]["valid_mismatch"]["value"] == 0, out["checks"]
    assert out["attempted"] > 0 and list(out)[-1] == "checks"
