"""Temporal fusion of the per-step bbox estimates of the RL camera-scheduling
controller: a copy of ``consensus_fuse`` from
``rgbmanip_tpu/models/controller/rl_pose.py``. ``ControlInterface`` and the
controller wait for the port of the simulator.
"""

from __future__ import annotations

import numpy as np


def consensus_fuse(pred_bbox, cur_step, cluster_tol=0.06, stereo_ok=None):
    """Robust temporal fusion of the per-step bbox estimates.

    Deviation from the reference (rl_pose.py:491-516), which acts on the
    LAST estimate only: the scene is static while the camera schedules
    views, so every per-step estimate predicts the SAME part bbox and the
    per-step errors differ systematically (the policy's late close-in view
    pairs are the worst — measured 3.1/4.1/8.6 cm at steps 2/3/4,
    docs/RESULTS.md). Per env: pick the medoid of the non-sentinel per-step
    centers (the estimate in best agreement with the others), then average
    the estimates within ``cluster_tol`` of it. Falls back to the last
    estimate (reference behavior) when fewer than 3 steps are usable. Uses
    no ground truth and no per-k tuning.

    ``stereo_ok`` (M, N bool, optional) marks which per-step estimates came
    from a genuine two-view pair. Estimates made while only ONE valid view
    existed (the lone view is duplicated into both stereo slots,
    ``get_estimation``) are quasi-monocular and systematically worse; at
    k=3 a quasi-mono step-1 estimate pairing with step-2 can outvote the
    better step-3 stereo estimate (measured 87.50 -> 76.92, docs/RESULTS.md
    r4). With ``stereo_ok`` given, only stereo estimates are CANDIDATES for
    the vote; if fewer than 3 remain the fallback is the last estimate.

    Cluster membership additionally requires open-direction agreement with
    the medoid (corners 0/1 define the direction the manipulation acts
    along downstream): two estimates whose centers agree but whose corner
    orderings disagree must not average into a degenerate direction.

    pred_bbox: (M, N, 8, 3) per-step estimate queue (steps 1..cur_step
    written by ``ControlInterface.add_bbox``). Returns (N, 8, 3).
    """
    pred_bbox = np.asarray(pred_bbox)
    N = pred_bbox.shape[1]
    out = pred_bbox[cur_step].copy()
    for j in range(N):
        steps, centers, dirs, voters = [], [], [], []
        for t in range(1, cur_step + 1):
            c = (pred_bbox[t, j, 0] + pred_bbox[t, j, 7]) / 2
            if np.linalg.norm(c) >= 5.0:  # sentinel bbox sits at ~+10
                continue
            d = pred_bbox[t, j, 1] - pred_bbox[t, j, 0]
            steps.append(t)
            centers.append(c)
            dirs.append(d / (np.linalg.norm(d) + 1e-9))
            voters.append(stereo_ok is None or bool(stereo_ok[t, j]))
        nv = int(np.sum(voters))
        if nv < 3:
            # Too few stereo candidates for a vote. If gating left ANY
            # usable stereo estimate, act on the LATEST one (recency, like
            # the reference, but never a gated degenerate-pair estimate —
            # falling back to the raw last estimate would act on exactly
            # the near-zero-baseline estimate the gate excluded); with no
            # usable candidate at all, keep the reference behavior (raw
            # last estimate).
            if stereo_ok is not None and nv >= 1:
                out[j] = pred_bbox[[s for s, v in zip(steps, voters) if v][-1], j]
            continue
        # medoid vote runs over STEREO candidates only (a degenerate-pair
        # estimate must not steer the vote), but gated estimates may still
        # JOIN the averaged cluster when they agree with the stereo medoid
        # — agreement with independent stereo consensus is itself evidence
        C = np.stack(centers)
        n = len(steps)
        vi = np.nonzero(voters)[0]
        D = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
        Dv = D[np.ix_(vi, vi)]
        off = ~np.eye(len(vi), dtype=bool)
        med = np.array([np.median(Dv[i][off[i]]) for i in range(len(vi))])
        best = int(vi[np.argmin(med - 1e-9 * np.arange(len(vi)))])  # tie -> later
        agree = np.stack(dirs) @ dirs[best] > 0.0
        keep = np.nonzero((D[best] <= cluster_tol) & agree)[0]
        out[j] = pred_bbox[[steps[i] for i in keep], j].mean(axis=0)
    return out
