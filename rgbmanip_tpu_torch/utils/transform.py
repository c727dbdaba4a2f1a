"""Batched quaternion / rigid-transform math (host-side, numpy).

Semantics mirror the reference's ``utils/transform.py`` (quaternion algebra,
camera lookat frames, frame-matching rotations; reference
``utils/transform.py:3-244``) but the implementation is original: closed-form
matrix<->quaternion conversions replace the reference's per-sample python
loops and 4x4 eigen-decompositions, and everything is batched numpy.

Quaternion convention: ``(w, x, y, z)`` scalar-first (SAPIEN convention).

This is the port's copy of ``rgbmanip_tpu/utils/transform.py``, kept so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-9


def normalize(x: np.ndarray, eps: float = EPS) -> np.ndarray:
    """Normalize vectors along the last axis."""
    x = np.asarray(x, dtype=np.float64)
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


# ---------------------------------------------------------------------------
# Quaternion algebra
# ---------------------------------------------------------------------------

def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of two (…, 4) quaternion arrays (wxyz)."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    w1, x1, y1, z1 = np.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        axis=-1,
    )


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate (…, 3) vectors by (…, 4) quaternions: ``q * v * q^-1``."""
    q = np.asarray(q, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    qv = q[..., 1:]
    qw = q[..., :1]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(…, 4) quaternion -> (…, 3, 3) rotation matrix."""
    q = normalize(np.asarray(q, dtype=np.float64))
    w, x, y, z = np.moveaxis(q, -1, 0)
    row0 = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return np.stack([row0, row1, row2], axis=-2)


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """(…, 3, 3) rotation matrix -> (…, 4) quaternion (wxyz), branch-free.

    Uses the four-candidate construction (one per largest diagonal term) and
    selects per-element, so it is stable for all rotations and batcheable.
    """
    m = np.asarray(m, dtype=np.float64)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # candidate 0: trace
    q0 = np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    # candidate 1: m00 largest
    q1 = np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    # candidate 2: m11 largest
    q2 = np.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], axis=-1)
    # candidate 3: m22 largest
    q3 = np.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], axis=-1)

    # pick the candidate with the largest leading term (best conditioned)
    lead = np.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], axis=-1)
    idx = np.argmax(lead, axis=-1)
    cands = np.stack([q0, q1, q2, q3], axis=-2)  # (…, 4 candidates, 4)
    q = np.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = normalize(q)
    # canonical sign: w >= 0
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis: np.ndarray, angle) -> np.ndarray:
    """Quaternion rotating ``angle`` radians about ``axis`` (…, 3)."""
    axis = normalize(np.asarray(axis, dtype=np.float64))
    angle = np.asarray(angle, dtype=np.float64)[..., None]
    half = angle / 2.0
    return np.concatenate([np.cos(half), axis * np.sin(half)], axis=-1)


def quat_to_axis(q: np.ndarray, axis_id: int) -> np.ndarray:
    """Column ``axis_id`` of the rotation matrix of q — the rotated basis axis."""
    return quat_to_matrix(q)[..., :, axis_id]


def compute_quat_err(targ: np.ndarray, curr: np.ndarray) -> np.ndarray:
    """Small-angle orientation error vector between target and current quats."""
    q_r = quat_mul(targ, quat_conjugate(curr))
    return q_r[..., 1:4] * np.sign(q_r[..., :1] + EPS)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def frame_quat(from_vs: np.ndarray, to_vs: np.ndarray) -> np.ndarray:
    """Quaternion rotating orthonormal frame ``from_vs`` onto ``to_vs``.

    Both are (…, 3 vectors, 3) row-stacked. Solves R @ a_i = b_i in closed
    form: with A/B holding the vectors as columns, R = B @ A^T. Replaces the
    reference's 4x4 eigendecomposition (``utils/transform.py:168-211``) with
    a direct, batched construction.
    """
    A = np.asarray(from_vs, dtype=np.float64)
    B = np.asarray(to_vs, dtype=np.float64)
    # rows are vectors: columns(A) = A.T  =>  R = B^T? careful:
    # A_cols = swapaxes(A, -1, -2); R = B_cols @ A_cols^T = B^T_rows… compute directly:
    R = np.swapaxes(B, -1, -2) @ A
    return matrix_to_quat(R)


def lookat_quat(direction: np.ndarray) -> np.ndarray:
    """Camera orientation whose +x axis points along ``direction`` (…, 3).

    Frame convention matches the reference (``utils/transform.py:50-99``):
    x = view direction, y = normalize(z_world x dir), z = dir x y. Degenerate
    straight-up/straight-down directions fall back to a fixed frame.
    """
    d = np.asarray(direction, dtype=np.float64)
    shape = d.shape
    d = normalize(d.reshape(-1, 3))

    z_ = np.array([0.0, 0.0, 1.0])
    dot = d @ z_
    generic = np.abs(np.abs(dot) - 1.0) >= 1e-6

    y = np.cross(np.broadcast_to(z_, d.shape), d)
    y = np.where(generic[:, None], normalize(y), np.array([0.0, 1.0, 0.0]))
    x = np.where(
        generic[:, None],
        d,
        np.where(dot[:, None] > 0, z_, -z_),
    )
    z = np.cross(x, y)
    z = normalize(z)
    # columns of R are the images of the basis vectors
    R = np.stack([x, y, z], axis=-1)
    return matrix_to_quat(R).reshape(*shape[:-1], 4)


# ---------------------------------------------------------------------------
# Rigid pose (p, q) helpers
# ---------------------------------------------------------------------------

class Pose:
    """Minimal rigid transform: position (3,) + quaternion (4,) wxyz.

    Drop-in for the subset of ``sapien.Pose`` the reference relies on
    (composition, inverse, transformation matrix).
    """

    __slots__ = ("p", "q")

    def __init__(self, p=None, q=None):
        self.p = np.zeros(3) if p is None else np.asarray(p, dtype=np.float64).copy()
        self.q = np.array([1.0, 0, 0, 0]) if q is None else np.asarray(q, dtype=np.float64).copy()

    def __mul__(self, other: "Pose") -> "Pose":
        return Pose(self.p + quat_rotate(self.q, other.p), quat_mul(self.q, other.q))

    def inv(self) -> "Pose":
        qi = quat_conjugate(self.q)
        return Pose(-quat_rotate(qi, self.p), qi)

    def transform_points(self, pts: np.ndarray) -> np.ndarray:
        return quat_rotate(self.q[None], np.asarray(pts)) + self.p

    def to_transformation_matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = quat_to_matrix(self.q)
        m[:3, 3] = self.p
        return m

    @staticmethod
    def from_transformation_matrix(m: np.ndarray) -> "Pose":
        return Pose(m[:3, 3], matrix_to_quat(m[:3, :3]))

    def to_7d(self) -> np.ndarray:
        return np.concatenate([self.p, self.q])

    @staticmethod
    def from_7d(v: np.ndarray) -> "Pose":
        v = np.asarray(v, dtype=np.float64)
        return Pose(v[:3], v[3:7])

    def __repr__(self):
        return f"Pose(p={self.p.tolist()}, q={self.q.tolist()})"
