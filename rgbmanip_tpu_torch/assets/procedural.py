"""Procedural articulated-object generator.

Stands in for the PartNet-Mobility URDF dataset (reference ``install.sh``
downloads it; the reference's dataset YAMLs enumerate per-object
``mobility.urdf`` paths — ``cfg/dataset/cabinet_train.yaml``). Each object id
maps deterministically (via its seed) to a randomized articulated asset:

- ``one_door_cabinet``: body + revolute front door + vertical handle bar
- ``one_drawer_cabinet``: body + prismatic drawer + horizontal handle bar
- ``pot``: body cylinder + prismatic-z lid (disc + top knob)
- ``mug``: prismatic-z lift dof carrying cylinder body + side handle bar

Canonical frame: z-up, front face toward -x (the placement yaw in the task
envs then points the front at the robot). Link frames reproduce the
reference data's conventions so the bbox-derived grasp frames match
(door-link local axes in world at dof=0: x=+y_w, y=-z_w, z=-x_w — see
``models/controller/gt_pose.py:31-34`` + ``models/manipulation/open_cabinet.py:23-29``
for how axis[0]=-z_link must be the horizontal approach direction).

Visual-id convention (reference ``env/sapien_envs/open_cabinet.py:129-144``):
0 = background/robot/body, 128 = active part, 129 = graspable part
("handle"/"lid"/whole mug).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from .spec import (
    J_FIXED, J_PRISMATIC, J_REVOLUTE, S_BOX, S_CYLINDER,
    ArticulationSpec, LinkSpec, ShapeSpec, pose7,
)
from ..utils.transform import matrix_to_quat

VID_PART = 128
VID_GRASP = 129


@dataclass
class ObjectMeta:
    """Everything a task env needs to know about a generated object."""
    category: str
    part_link: str          # link whose dof is the task dof / seg target
    half_depth: float       # half extent along canonical x (for placement)
    half_height: float      # half extent along canonical z
    dof_lo: float
    dof_hi: float


def _frame_quat_cols(x, y, z) -> np.ndarray:
    """Quaternion whose rotation matrix has columns x, y, z."""
    m = np.stack([np.asarray(x, float), np.asarray(y, float), np.asarray(z, float)], axis=-1)
    return matrix_to_quat(m)

# door/drawer link frame: local x=+y_w, y=-z_w, z=-x_w at dof 0 (see module docstring)
PART_FRAME_Q = _frame_quat_cols([0, 1, 0], [0, 0, -1], [-1, 0, 0])


def _one_door_cabinet(rng: np.random.Generator) -> Tuple[ArticulationSpec, ObjectMeta]:
    W = rng.uniform(0.55, 0.95)     # width (y)
    D = rng.uniform(0.32, 0.48)     # depth (x)
    H = rng.uniform(0.65, 1.1)      # height (z)
    door_w = W * rng.uniform(0.45, 0.95)
    door_h = H - 0.04
    hinge_side = 1 if rng.uniform() < 0.5 else -1   # +1: hinge at +y edge
    handle_h = rng.uniform(0.3, 0.7) * door_h - door_h / 2
    handle_len = rng.uniform(0.10, 0.17)
    standoff = 0.045

    body_col = tuple(rng.uniform(0.35, 0.75, 3))
    door_col = tuple(np.clip(np.asarray(body_col) + rng.uniform(-0.15, 0.15, 3), 0.05, 0.95))
    handle_col = (0.75, 0.75, 0.78)

    s = ArticulationSpec()
    root = LinkSpec(name="base")
    # body: solid box behind the door plane (front face at x=-D/2)
    root.shapes.append(ShapeSpec(
        S_BOX, (D / 2 - 0.012, W / 2, H / 2), pose7((0.012, 0, 0)), body_col, 0, True))
    # static front strip beside the door
    strip_w = (W - door_w) / 2
    if strip_w > 0.01:
        for side in (1, -1):
            root.shapes.append(ShapeSpec(
                S_BOX, (0.01, strip_w / 2, H / 2),
                pose7((-D / 2 + 0.002, side * (W / 2 - strip_w / 2), 0)),
                body_col, 0, True))
    s.links.append(root)

    # door link: hinge on a vertical front edge. The link frame sits at the
    # hinge with the PART_FRAME orientation; axis expressed in that frame so
    # that positive dof swings the door outward (-x world).
    hinge_y = hinge_side * door_w / 2 if strip_w <= 0.01 else hinge_side * (W / 2 - strip_w)
    # world axis for outward opening: -z for hinge at +y, +z for hinge at -y
    axis_world = np.array([0, 0, -1.0]) * hinge_side
    # convert world axis to the door link frame (frame cols: x=+y,y=-z,z=-x)
    m = np.stack([[0, 1, 0], [0, 0, -1], [-1, 0, 0]], axis=-1).astype(float)
    axis_local = m.T @ axis_world
    door = LinkSpec(
        name="door", parent=0, joint_type=J_REVOLUTE,
        origin=pose7((-D / 2, hinge_y, handle_h * 0 + 0), PART_FRAME_Q),
        axis=tuple(axis_local), lo=0.0, hi=1.6, friction=0.8, damping=4.0)
    # door panel: in the door frame, world -y*hinge_side (toward the free
    # edge) is local ... world y -> local x; panel spans from hinge to free edge
    panel_cx = -hinge_side * door_w / 2  # world-y offset -> local x
    door.shapes.append(ShapeSpec(
        S_BOX, (door_w / 2, door_h / 2, 0.01),
        pose7((panel_cx, 0, 0.008)),  # local z = -x_w: +0.008 puts panel just behind front plane
        door_col, VID_PART, True))
    # handle: vertical bar (long along world z = local -y), on the free edge
    # side, standing off the front face toward the robot (world -x = local +z)
    handle_cx = -hinge_side * (door_w - 0.09)
    door.shapes.append(ShapeSpec(
        S_BOX, (0.013, handle_len / 2, 0.014),
        pose7((handle_cx, -handle_h, standoff)),
        handle_col, VID_GRASP, True))
    # standoff posts
    for dz in (-handle_len / 2 + 0.02, handle_len / 2 - 0.02):
        door.shapes.append(ShapeSpec(
            S_BOX, (0.008, 0.008, standoff / 2),
            pose7((handle_cx, -handle_h + dz, standoff / 2)),
            handle_col, VID_GRASP, True))
    s.links.append(door)
    return s, ObjectMeta("one_door_cabinet", "door", D / 2, H / 2, 0.0, 1.6)


def _one_drawer_cabinet(rng: np.random.Generator) -> Tuple[ArticulationSpec, ObjectMeta]:
    W = rng.uniform(0.45, 0.9)
    D = rng.uniform(0.35, 0.55)
    H = rng.uniform(0.5, 1.0)
    dr_h = rng.uniform(0.14, 0.26)               # drawer front height
    # keep the drawer in the upper half of the body so its handle stays in
    # the robot's comfortable workspace (PartNet drawers used by the
    # reference are top drawers)
    dr_cz = rng.uniform(0.5, 0.8) * H - H / 2    # drawer center height
    dr_w = W - 0.06
    handle_len = rng.uniform(0.10, 0.18)
    standoff = 0.045

    body_col = tuple(rng.uniform(0.35, 0.75, 3))
    front_col = tuple(np.clip(np.asarray(body_col) + rng.uniform(-0.15, 0.15, 3), 0.05, 0.95))
    handle_col = (0.75, 0.75, 0.78)

    s = ArticulationSpec()
    root = LinkSpec(name="base")
    root.shapes.append(ShapeSpec(
        S_BOX, (D / 2 - 0.012, W / 2, H / 2), pose7((0.012, 0, 0)), body_col, 0, True))
    # front panels above/below the drawer
    top_h = H / 2 - (dr_cz + dr_h / 2)
    bot_h = (dr_cz - dr_h / 2) + H / 2
    if top_h > 0.02:
        root.shapes.append(ShapeSpec(S_BOX, (0.01, W / 2, top_h / 2),
                                     pose7((-D / 2 + 0.002, 0, H / 2 - top_h / 2)), body_col, 0, True))
    if bot_h > 0.02:
        root.shapes.append(ShapeSpec(S_BOX, (0.01, W / 2, bot_h / 2),
                                     pose7((-D / 2 + 0.002, 0, -H / 2 + bot_h / 2)), body_col, 0, True))
    s.links.append(root)

    # drawer link at the drawer front center, PART_FRAME orientation.
    # prismatic, slides outward (-x world). world -x -> local z (frame col z=-x_w)
    drawer = LinkSpec(
        name="drawer", parent=0, joint_type=J_PRISMATIC,
        origin=pose7((-D / 2, 0, dr_cz), PART_FRAME_Q),
        axis=(0, 0, 1), lo=0.0, hi=max(0.35, D - 0.1), friction=2.0, damping=8.0)
    # front panel: local x = +y_w (width), local y = -z_w (height)
    drawer.shapes.append(ShapeSpec(
        S_BOX, (dr_w / 2, dr_h / 2, 0.01), pose7((0, 0, 0.008)), front_col, VID_PART, True))
    # drawer box behind the front (so an opened drawer has a body);
    # into the cabinet = world +x = local -z
    drawer.shapes.append(ShapeSpec(
        S_BOX, (dr_w / 2 - 0.02, dr_h / 2 - 0.02, (D - 0.08) / 2),
        pose7((0, 0, -(0.02 + (D - 0.08) / 2))), body_col, VID_PART, True))
    # horizontal handle bar (long along width = local x), standing off the
    # front toward the robot (world -x = local +z)
    drawer.shapes.append(ShapeSpec(
        S_BOX, (handle_len / 2, 0.013, 0.014), pose7((0, 0, standoff)),
        handle_col, VID_GRASP, True))
    for dx in (-handle_len / 2 + 0.02, handle_len / 2 - 0.02):
        drawer.shapes.append(ShapeSpec(
            S_BOX, (0.008, 0.008, standoff / 2), pose7((dx, 0, standoff / 2)),
            handle_col, VID_GRASP, True))
    s.links.append(drawer)
    return s, ObjectMeta("one_drawer_cabinet", "drawer", D / 2, H / 2, 0.0, max(0.35, D - 0.1))


def _pot(rng: np.random.Generator) -> Tuple[ArticulationSpec, ObjectMeta]:
    R = rng.uniform(0.09, 0.16)
    Hh = rng.uniform(0.06, 0.12)   # body half height
    lid_t = 0.015                  # lid half thickness
    knob_h = rng.uniform(0.015, 0.025)
    body_col = tuple(rng.uniform(0.3, 0.8, 3))
    lid_col = tuple(np.clip(np.asarray(body_col) + rng.uniform(-0.2, 0.2, 3), 0.05, 0.95))

    s = ArticulationSpec()
    root = LinkSpec(name="base")
    # body cylinder, origin at body center
    root.shapes.append(ShapeSpec(S_CYLINDER, (R, Hh, 0), pose7((0, 0, 0)), body_col, 0, True))
    # side grips (cosmetic)
    for side in (1, -1):
        root.shapes.append(ShapeSpec(S_BOX, (0.015, 0.03, 0.012),
                                     pose7((0, side * (R + 0.02), Hh * 0.5)), body_col, 0, True))
    s.links.append(root)

    # lid: prismatic z, PART_FRAME-like orientation is irrelevant for the
    # top-down skill (pre_grasp_axis is hard-coded -z); keep identity frame.
    lid = LinkSpec(name="lid", parent=0, joint_type=J_PRISMATIC,
                   origin=pose7((0, 0, Hh + lid_t)), axis=(0, 0, 1),
                   lo=0.0, hi=0.6, friction=0.02, damping=2.0)
    lid.shapes.append(ShapeSpec(S_CYLINDER, (R + 0.012, lid_t, 0), pose7((0, 0, 0)),
                                lid_col, VID_GRASP, True))
    # knob bar on top (graspable)
    lid.shapes.append(ShapeSpec(S_BOX, (0.012, 0.035, knob_h),
                                pose7((0, 0, lid_t + knob_h)), lid_col, VID_GRASP, True))
    s.links.append(lid)
    return s, ObjectMeta("pot", "lid", R, Hh + lid_t, 0.0, 0.6)


def _mug(rng: np.random.Generator) -> Tuple[ArticulationSpec, ObjectMeta]:
    R = rng.uniform(0.038, 0.06)
    Hh = rng.uniform(0.05, 0.08)
    handle_out = rng.uniform(0.035, 0.055)
    body_col = tuple(rng.uniform(0.25, 0.9, 3))

    s = ArticulationSpec()
    root = LinkSpec(name="base")   # empty anchor at the rest position
    s.links.append(root)
    # the whole mug rides a vertical prismatic dof (its lift height is the
    # task dof: success = lifted above success_dof, reference
    # cfg/task/pick_mug.yaml success_dof 0.03)
    mug = LinkSpec(name="mug", parent=0, joint_type=J_PRISMATIC,
                   origin=pose7((0, 0, 0), PART_FRAME_Q),
                   axis=(0, -1, 0),  # local -y = world +z under PART_FRAME
                   lo=0.0, hi=0.6, friction=0.02, damping=2.0)
    # body cylinder: world z = local -y; cylinder axis is local z, so rotate
    # the shape so its axis points along local -y (world z): rot x by +90deg
    from .spec import rpy_to_quat
    mug.shapes.append(ShapeSpec(
        S_CYLINDER, (R, Hh, 0), pose7((0, 0, 0), rpy_to_quat(np.pi / 2, 0, 0)),
        body_col, VID_GRASP, True))
    # handle sticks out along link-local +x (the skill's approach axis[1] is
    # -x_link horizontal-projected: it approaches from beyond the handle
    # toward the body — models/manipulation/pick_mug.py:23-29).
    # vertical bar: long along world z = local -y.
    mug.shapes.append(ShapeSpec(
        S_BOX, (0.011, Hh * 0.55, 0.011), pose7((R + handle_out, 0, 0)),
        body_col, VID_GRASP, True))
    for dzy in (-Hh * 0.45, Hh * 0.45):
        mug.shapes.append(ShapeSpec(
            S_BOX, ((R + handle_out) / 2 - 0.002, 0.009, 0.009),
            pose7(((R + handle_out) / 2, dzy, 0)), body_col, VID_GRASP, True))
    s.links.append(mug)
    return s, ObjectMeta("mug", "mug", R + handle_out, Hh, 0.0, 0.6)


_GENERATORS = {
    "one_door_cabinet": _one_door_cabinet,
    "one_drawer_cabinet": _one_drawer_cabinet,
    "pot": _pot,
    "mug": _mug,
}

_CACHE: Dict[Tuple[str, int], Tuple[ArticulationSpec, ObjectMeta]] = {}


def generate(category: str, seed: int) -> Tuple[ArticulationSpec, ObjectMeta]:
    key = (category, seed)
    if key not in _CACHE:
        rng = np.random.default_rng(seed)
        _CACHE[key] = _GENERATORS[category](rng)
    return _CACHE[key]
