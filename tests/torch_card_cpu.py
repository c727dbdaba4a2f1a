"""The card-against-CPU check of ``rgbmanip_tpu_torch.bench``'s estimate,
which ``tests/test_torch_cuda.py`` runs on the card and
``tests/test_torch_bench.py`` holds on the CPU.

The bench's two views share their orientation and their crop rows, so the
cost volume's first and last rows land on the source's border, where each
device's last bit decides whether a ray falls inside. The CPU's run
replays the card's in-or-out decisions for rays within ``TIE_PX`` of the
border (``estimate_projections``, which fails on any other differing
decision), and then holds the bbox to 1e-3 m. Imports neither JAX nor the
JAX package: pytest does not collect this module, the card tests import it.
"""

from unittest import mock

import numpy as np
import torch

TIE_PX = 1e-4                  # a ray this close to the source's border is a tie
PROJ_TOL = 1e-3                # px between two devices' projections of one ray


class Disagreement(AssertionError):
    """The card's and the CPU's estimates part beyond what a tie explains."""


def check(cond, msg):
    if not cond:
        raise Disagreement(msg)


def view2_raised(ext2):
    """``bench.bench_inputs``' second extrinsics with the camera raised
    1 mm: 1 mm moves the border rows' rays 0.04-0.9 px off the border at
    every depth hypothesis."""
    raised = ext2.clone()
    raised[:, 1, 3] += 1e-3
    return raised


def estimate_projections(est, inputs, replay=None):
    """``est._estimate`` on ``inputs`` (moved to its device): its (bbox,
    valid) as numpy, the plane sweep's projections (px, py, inside) of each
    ``stereo._project`` call on the CPU, and how many in-or-out decisions
    were taken from ``replay``: the projections of the same estimate on
    another device. After checking that the two devices' coordinates agree
    within PROJ_TOL px and that their decisions differ only for rays within
    TIE_PX px of the source's border, where the last bit decides, each ray
    whose decision differs takes ``replay``'s decision and coordinates."""
    from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo

    project, calls, taken = stereo._project, [], [0]

    def projected(rot, trans, xyz, depth_values, H, W):
        px, py, inside = project(rot, trans, xyz, depth_values, H, W)
        calls.append(tuple(t.cpu() for t in (px, py, inside)))
        if replay is None:
            return px, py, inside
        check(len(calls) <= len(replay), "the replayed estimate projects more often")
        rpx, rpy, rin = replay[len(calls) - 1]
        cpx, cpy, cin = calls[-1]
        gap = max(float((cpx - rpx).abs().max()), float((cpy - rpy).abs().max()))
        check(gap <= PROJ_TOL, f"the two devices' projections part by {gap:.3g} px")
        tie = ((cpx.abs() < TIE_PX) | ((cpx - (W - 1)).abs() < TIE_PX)
               | (cpy.abs() < TIE_PX) | ((cpy - (H - 1)).abs() < TIE_PX))
        flip = cin != rin
        check(not bool((flip & ~tie).any()), f"{int((flip & ~tie).sum())} in-or-out "
              f"decisions differ for rays off the border")
        taken[0] += int(flip.sum())
        # a flipped ray takes the card's coordinates too: at the border the
        # bilinear taps of py = -1e-7 and of +1e-7 are a row apart
        return tuple(torch.where(flip, r, c).to(inside.device)
                     for r, c in ((rpx, cpx), (rpy, cpy), (rin, cin)))

    with mock.patch.object(stereo, "_project", projected):
        bbox, valid, _ = est._estimate(*(t.to(est.device) for t in inputs))
    check(replay is None or len(calls) == len(replay),
          f"{len(calls)} projections against {len(replay or ())} replayed")
    return (bbox.cpu().numpy(), valid.cpu().numpy()), calls, taken[0]


def bench_card_against_cpu(ests, B, raised):
    """The bench's estimate at batch ``B`` on ``ests["card"]`` against
    ``ests["cpu"]`` (the same knobs, weights and dtype): its inputs made on
    the card, the same point draws, on the bench's own views or, if
    ``raised``, with view 2 raised 1 mm (``view2_raised``). The CPU's run
    replays the card's border-tie decisions (``estimate_projections``: only
    ties may differ), and then the bbox must agree within 1e-3 m, the
    two-view rule of ``tests/test_torch_estimator.py``, and the valid flags
    equal. Returns (max |bbox diff| m, n valid, decisions replayed); raises
    on a disagreement."""
    from rgbmanip_tpu_torch import bench

    g = torch.Generator().manual_seed(5)
    u1, u2 = (torch.rand(B, ests["cpu"].img_size ** 2, generator=g) for _ in range(2))
    K, rgb1, mask, ext1, rgb2, ext2 = bench.bench_inputs(B, bench.SEED, ests["card"].device)
    if raised:
        ext2 = view2_raised(ext2)
    inputs = (K, rgb1, mask, ext1, rgb2, mask, ext2, u1, u2)
    (cbox, cvalid), calls, _ = estimate_projections(ests["card"], inputs)
    (pbox, pvalid), _, taken = estimate_projections(ests["cpu"], inputs, calls)
    bdiff = float(np.abs(cbox - pbox).max())
    check(np.isfinite(cbox).all() and (cvalid == pvalid).all() and bdiff <= 1e-3,
          f"the bench estimate at B={B} (view 2 raised: {raised}): card and CPU disagree "
          f"(valid {cvalid} / {pvalid}, max |bbox diff| {bdiff:.3g} m, limit 1e-3)")
    return bdiff, int(cvalid.sum()), taken
