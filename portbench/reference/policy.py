"""Plain PyTorch reference of the camera-scheduling policy's deterministic
action and of the evaluation's fusion of the per-step bbox estimates.

The actor is the PPO checkpoint's ``actor`` MLP: dense layers ``Dense_0`` ...
``Dense_n`` with ELU between them and none after the last; its mean is the
action. The fusion is the evaluation's consensus rule, restated here from
its description: per env, the medoid of the usable per-step centres among
the stereo candidates (a centre nearer the origin than 5 m; the candidate
with the least median distance to the others, the later one on a tie), then
the mean of the estimates within ``cluster_tol`` of it whose opening
direction agrees; with fewer than 3 candidates, the latest usable stereo
estimate, else the estimate of the last step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def actor_layers(tree, device):
    """[(weight (O, I), bias (O,))] of the checkpoint's actor, on ``device``."""
    actor = tree["params"]["params"]["actor"]
    return [(torch.as_tensor(np.asarray(actor[f"Dense_{i}"]["kernel"]).T.copy(),
                             dtype=torch.float32, device=device),
             torch.as_tensor(np.asarray(actor[f"Dense_{i}"]["bias"]), dtype=torch.float32,
                             device=device))
            for i in range(len(actor))]


def act(layers, obs):
    """obs (B, obs_dim) -> mean action (B, A)."""
    x = obs
    for i, (w, b) in enumerate(layers):
        x = F.linear(x, w, b)
        if i < len(layers) - 1:
            x = F.elu(x)
    return x


def consensus_fuse(pred_bbox, cur_step, stereo_ok, cluster_tol=0.06):
    """pred_bbox (M, N, 8, 3) per-step estimates, steps 1..cur_step used;
    stereo_ok (M, N) bool. Returns (N, 8, 3)."""
    pred_bbox = np.asarray(pred_bbox)
    out = pred_bbox[cur_step].copy()
    for j in range(pred_bbox.shape[1]):
        steps, centres, dirs, voters = [], [], [], []
        for t in range(1, cur_step + 1):
            c = (pred_bbox[t, j, 0] + pred_bbox[t, j, 7]) / 2
            if np.linalg.norm(c) >= 5.0:
                continue
            d = pred_bbox[t, j, 1] - pred_bbox[t, j, 0]
            steps.append(t)
            centres.append(c)
            dirs.append(d / (np.linalg.norm(d) + 1e-9))
            voters.append(bool(stereo_ok[t, j]))
        vi = np.nonzero(voters)[0]
        if len(vi) < 3:
            if len(vi):
                out[j] = pred_bbox[steps[vi[-1]], j]
            continue
        C = np.stack(centres)
        dist = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
        sub = dist[np.ix_(vi, vi)]
        med = np.array([np.median(np.delete(sub[i], i)) for i in range(len(vi))])
        best = int(vi[np.argmin(med - 1e-9 * np.arange(len(vi)))])
        agree = np.stack(dirs) @ dirs[best] > 0.0
        keep = np.nonzero((dist[best] <= cluster_tol) & agree)[0]
        out[j] = pred_bbox[[steps[i] for i in keep], j].mean(axis=0)
    return out
