"""Batched quaternion / rigid-transform math on tensors (counterpart of
``rgbmanip_tpu/ops/transform.py``): the device-side mirror of
``utils/transform.py``, branch-free, any leading batch shape.

Quaternion convention: ``(w, x, y, z)`` scalar-first.
"""

from __future__ import annotations

import torch

EPS = 1e-9


def normalize(x, eps: float = EPS):
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
    ], dim=-1)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    qv = q[..., 1:]
    qw = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_matrix(q):
    w, x, y, z = normalize(q).unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(m):
    """The candidate of the largest leading term (the first of equal ones,
    as ``jnp.argmax``), normalised, with w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                        1.0 + m22 - m00 - m11], dim=-1)
    idx = torch.argmax(lead, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(*idx.shape, 1, 4),
                             dim=-2)[..., 0, :]
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis, angle):
    axis = normalize(axis)
    half = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_to_axis(q, axis_id: int):
    return quat_to_matrix(q)[..., :, axis_id]


def compute_quat_err(targ, curr):
    q_r = quat_mul(targ, quat_conjugate(curr))
    return q_r[..., 1:4] * torch.sign(q_r[..., :1] + EPS)


def frame_quat(from_vs, to_vs):
    """Quaternion rotating row-stacked orthonormal frame ``from_vs`` -> ``to_vs``."""
    return matrix_to_quat(to_vs.transpose(-1, -2) @ from_vs)


def lookat_quat(direction):
    """Camera quaternion whose +x axis looks along ``direction`` (..., 3)."""
    d = normalize(direction)
    z_ = torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
    dot = (d * z_).sum(-1)
    generic = (torch.abs(torch.abs(dot) - 1.0) >= 1e-6)[..., None]
    y = _cross(z_.expand_as(d), d)
    y = torch.where(generic, normalize(y), torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype,
                                                        device=d.device))
    x = torch.where(generic, d, torch.where(dot[..., None] > 0, z_, -z_))
    z = normalize(_cross(x, y))
    return matrix_to_quat(torch.stack([x, y, z], dim=-1))


def pose_mul(p1, q1, p2, q2):
    """Compose rigid transforms given as (pos, quat) tensors."""
    return p1 + quat_rotate(q1, p2), quat_mul(q1, q2)


def pose_inv(p, q):
    qi = quat_conjugate(q)
    return -quat_rotate(qi, p), qi
