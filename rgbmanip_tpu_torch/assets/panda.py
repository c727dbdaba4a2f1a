"""Franka Panda kinematic description (7-DoF arm + 2 prismatic fingers).

Joint origins/axes/limits are the public franka_description values (the same
robot the reference loads from ``assets/panda/panda.urdf``); link geometry is
approximated with primitive boxes/cylinders sized for correct rendering
silhouettes and planner collision spheres. PD drive gains mirror the
reference's SAPIEN setup (``env/sapien_envs/base_manipulation.py:354-359``):
stiffness 160 / damping 40 on the arm; fingers are kinematic in the C++ core.
"""

from __future__ import annotations

import numpy as np

from .spec import (
    J_FIXED, J_PRISMATIC, J_REVOLUTE, S_BOX, S_CYLINDER,
    ArticulationSpec, LinkSpec, ShapeSpec, pose7, rpy_to_quat,
)

PI = np.pi

ARM_STIFFNESS = 160.0
ARM_DAMPING = 40.0
# effective joint-space inertia (PhysX integrates real link inertias; we use a
# per-joint effective value that reproduces similar settle times)
ARM_ARMATURE = [1.2, 1.2, 1.0, 1.0, 0.6, 0.4, 0.3]

QLIM = [
    (-2.8973, 2.8973),
    (-1.7628, 1.7628),
    (-2.8973, 2.8973),
    (-3.0718, -0.0698),
    (-2.8973, 2.8973),
    (-0.0175, 3.7525),
    (-2.8973, 2.8973),
]

ROBOT_COLOR = (0.92, 0.92, 0.92)
DARK = (0.25, 0.25, 0.27)


def panda_spec() -> ArticulationSpec:
    s = ArticulationSpec()

    def add(name, parent, jt, xyz, rpy, axis=(0, 0, 1), lim=(0, 0), arm_idx=None):
        stiff = ARM_STIFFNESS if arm_idx is not None else (4000.0 if jt == J_PRISMATIC else 0.0)
        damp = ARM_DAMPING if arm_idx is not None else (10.0 if jt == J_PRISMATIC else 0.0)
        arma = ARM_ARMATURE[arm_idx] if arm_idx is not None else 1.0
        s.links.append(LinkSpec(
            name=name, parent=parent, joint_type=jt,
            origin=pose7(xyz, rpy_to_quat(*rpy)),
            axis=axis, lo=lim[0], hi=lim[1],
            stiffness=stiff, damping=damp, armature=arma,
        ))
        return len(s.links) - 1

    def shape(link, kind, params, xyz=(0, 0, 0), rpy=(0, 0, 0), color=ROBOT_COLOR):
        s.links[link].shapes.append(ShapeSpec(
            kind=kind, params=params, local=pose7(xyz, rpy_to_quat(*rpy)),
            color=color, visual_id=0, collide=True,
        ))

    l0 = add("panda_link0", -1, J_FIXED, (0, 0, 0), (0, 0, 0))
    shape(l0, S_BOX, (0.1, 0.09, 0.07), (-0.04, 0, 0.07), color=DARK)

    l1 = add("panda_link1", l0, J_REVOLUTE, (0, 0, 0.333), (0, 0, 0), lim=QLIM[0], arm_idx=0)
    shape(l1, S_CYLINDER, (0.065, 0.11, 0), (0, 0, -0.08))

    l2 = add("panda_link2", l1, J_REVOLUTE, (0, 0, 0), (-PI / 2, 0, 0), lim=QLIM[1], arm_idx=1)
    shape(l2, S_CYLINDER, (0.065, 0.08, 0), (0, -0.07, 0), rpy=(PI / 2, 0, 0))

    l3 = add("panda_link3", l2, J_REVOLUTE, (0, -0.316, 0), (PI / 2, 0, 0), lim=QLIM[2], arm_idx=2)
    shape(l3, S_CYLINDER, (0.06, 0.09, 0), (0, 0, -0.06))
    shape(l3, S_BOX, (0.055, 0.045, 0.05), (0.04, 0.02, 0))

    l4 = add("panda_link4", l3, J_REVOLUTE, (0.0825, 0, 0), (PI / 2, 0, 0), lim=QLIM[3], arm_idx=3)
    shape(l4, S_BOX, (0.055, 0.055, 0.055), (-0.04, 0.04, 0))

    l5 = add("panda_link5", l4, J_REVOLUTE, (-0.0825, 0.384, 0), (-PI / 2, 0, 0), lim=QLIM[4], arm_idx=4)
    shape(l5, S_CYLINDER, (0.055, 0.11, 0), (0, 0.025, -0.12))
    shape(l5, S_BOX, (0.035, 0.045, 0.09), (0, 0.065, -0.04))

    l6 = add("panda_link6", l5, J_REVOLUTE, (0, 0, 0), (PI / 2, 0, 0), lim=QLIM[5], arm_idx=5)
    shape(l6, S_BOX, (0.05, 0.05, 0.045), (0.02, 0, 0), color=DARK)

    l7 = add("panda_link7", l6, J_REVOLUTE, (0.088, 0, 0), (PI / 2, 0, 0), lim=QLIM[6], arm_idx=6)
    shape(l7, S_CYLINDER, (0.045, 0.035, 0), (0, 0, 0.045))

    l8 = add("panda_link8", l7, J_FIXED, (0, 0, 0.107), (0, 0, 0))

    hand = add("panda_hand", l8, J_FIXED, (0, 0, 0), (0, 0, -PI / 4))
    shape(hand, S_BOX, (0.032, 0.1, 0.033), (0, 0, 0.033), color=DARK)

    lf = add("panda_leftfinger", hand, J_PRISMATIC, (0, 0, 0.0584), (0, 0, 0),
             axis=(0, 1, 0), lim=(0.0, 0.04))
    shape(lf, S_BOX, (0.011, 0.011, 0.027), (0, 0.0105, 0.0265))

    rf = add("panda_rightfinger", hand, J_PRISMATIC, (0, 0, 0.0584), (0, 0, 0),
             axis=(0, -1, 0), lim=(0.0, 0.04))
    shape(rf, S_BOX, (0.011, 0.011, 0.027), (0, -0.0105, 0.0265))

    return s


HAND_LINK = "panda_hand"
N_ARM = 7
DOF = 9
