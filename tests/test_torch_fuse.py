"""The port's copy of consensus_fuse equals the JAX package's on seeded
queues of per-step bbox estimates, with and without the stereo gate."""

import numpy as np
import pytest

from rgbmanip_tpu.models.controller.rl_pose import consensus_fuse as jax_fuse
from rgbmanip_tpu_torch.models.controller.rl_pose import consensus_fuse

UNIT = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                 [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.float32) * 0.1


def queue(seed, M=5, N=8):
    """Per-step estimates around one bbox per env: noise, outliers, +10
    sentinels and flipped corner orderings."""
    rng = np.random.default_rng(seed)
    q = np.zeros((M, N, 8, 3), np.float32)
    for j in range(N):
        centre = rng.uniform(-0.5, 0.5, size=3)
        for t in range(1, M):
            q[t, j] = UNIT + centre + rng.normal(scale=0.02, size=3)
            r = rng.uniform()
            if r < 0.15:
                q[t, j] += rng.normal(scale=0.3, size=3)        # outlier
            elif r < 0.25:
                q[t, j] = UNIT + 10.0                           # sentinel
            elif r < 0.35:
                q[t, j] = q[t, j][::-1]                         # flipped
    return q


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cur_step", [2, 3, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_consensus_fuse_matches_jax(seed, cur_step, gated):
    q = queue(seed)
    stereo_ok = None
    if gated:
        stereo_ok = np.random.default_rng(100 + seed).uniform(size=q.shape[:2]) > 0.3
    np.testing.assert_array_equal(consensus_fuse(q, cur_step, stereo_ok=stereo_ok),
                                  jax_fuse(q, cur_step, stereo_ok=stereo_ok))
