"""Articulation specs: the Python-side scene description fed to the C++ core.

Replaces URDF loading (reference ``env/sapien_envs/base_manipulation.py:265-389``
loads PartNet-Mobility / Panda URDFs through SAPIEN): our assets are expressed
directly as kinematic trees of primitive shapes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..utils.transform import axis_angle_to_quat, quat_mul

J_FIXED, J_REVOLUTE, J_PRISMATIC = 0, 1, 2
S_BOX, S_SPHERE, S_CYLINDER, S_MESH = 0, 1, 2, 3


def rpy_to_quat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """URDF rpy convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    qx = axis_angle_to_quat(np.array([1.0, 0, 0]), roll)
    qy = axis_angle_to_quat(np.array([0, 1.0, 0]), pitch)
    qz = axis_angle_to_quat(np.array([0, 0, 1.0]), yaw)
    return quat_mul(qz, quat_mul(qy, qx))


def pose7(xyz=(0, 0, 0), q=(1, 0, 0, 0)) -> np.ndarray:
    return np.concatenate([np.asarray(xyz, dtype=np.float64),
                           np.asarray(q, dtype=np.float64)])


@dataclass
class ShapeSpec:
    kind: int = S_BOX
    params: tuple = (0.05, 0.05, 0.05)  # box: half extents; sphere: (r,-,-); cyl: (r, hh, -)
    local: np.ndarray = field(default_factory=lambda: pose7())
    color: tuple = (0.7, 0.7, 0.7)
    visual_id: int = 0
    collide: bool = True
    mesh: int = -1  # S_MESH: registered mesh id (assets.objmesh.register_obj)


@dataclass
class LinkSpec:
    name: str
    parent: int = -1
    joint_type: int = J_FIXED
    origin: np.ndarray = field(default_factory=lambda: pose7())
    axis: tuple = (0, 0, 1)
    lo: float = 0.0
    hi: float = 0.0
    stiffness: float = 0.0
    damping: float = 0.0
    friction: float = 0.0
    armature: float = 1.0
    shapes: List[ShapeSpec] = field(default_factory=list)


@dataclass
class ArticulationSpec:
    links: List[LinkSpec] = field(default_factory=list)

    def link_index(self, name: str) -> int:
        for i, l in enumerate(self.links):
            if l.name == name:
                return i
        raise KeyError(name)

    def dof(self) -> int:
        return sum(1 for l in self.links if l.joint_type != J_FIXED)
