"""PartNet-Mobility-style URDF objects -> (ArticulationSpec, ObjectMeta).

The reference's dataset entries point at ``mobility.urdf`` files with the
active (task) link encoded in the entry name (``44781_link_0`` -> link_0)
and handles identified by visual names containing "handle"
(``env/sapien_envs/open_cabinet.py:86-144``). This module loads such files
through :func:`.urdf.load_urdf` with mesh AABBs from
:mod:`.mesh` and derives the same ObjectMeta the
procedural generator produces, so URDF objects drop into the task envs
unchanged.

(The port's copy of ``rgbmanip_tpu/assets/urdf_object.py``.)
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..utils.transform import quat_rotate
from .procedural import VID_GRASP, VID_PART, ObjectMeta
from .mesh import mesh_bounds
from .spec import ArticulationSpec, J_FIXED

_CACHE: Dict[Tuple[str, str], Tuple[ArticulationSpec, ObjectMeta]] = {}


def _subtree(spec: ArticulationSpec, root_idx: int):
    out = set()
    for i in range(len(spec.links)):
        a = i
        while a >= 0:
            if a == root_idx:
                out.add(i)
                break
            a = spec.links[a].parent
    return out


def load_object_urdf(path: str, active_link: str, category: str = "urdf",
                     log=None) -> Tuple[ArticulationSpec, ObjectMeta]:
    """Load a mobility.urdf as a task object.

    active_link: the link whose joint is the task dof (seg target). Visuals
    of its subtree whose names contain "handle" get seg id 129, the rest of
    the subtree 128, everything else 0 (reference _set_part_mask,
    open_cabinet.py:129-144).
    """
    key = (os.path.abspath(path), active_link)
    if key in _CACHE:
        return _CACHE[key]

    # pass 1: plain load to discover the tree
    spec = load_urdf_raw(path, active_link, in_part=None, log=log)
    part_idx = spec.link_index(active_link)
    part_set = _subtree(spec, part_idx)
    part_names = {spec.links[i].name for i in part_set}

    # pass 2: assign seg ids with subtree knowledge
    spec = load_urdf_raw(path, active_link, in_part=part_names, log=log)
    _canonicalize_active_link(spec, part_idx)

    # meta: overall AABB at q=0 for placement offsets, active joint limits
    lo = np.full(3, 1e18)
    hi = np.full(3, -1e18)
    poses = _fk_zero(spec)
    for li, link in enumerate(spec.links):
        for s in link.shapes:
            p, q = poses[li]
            sp = p + quat_rotate(q, _shape_center_local(s))
            half = np.asarray(_shape_aabb_half(s))
            lo = np.minimum(lo, sp - half)
            hi = np.maximum(hi, sp + half)
    if not np.all(np.isfinite(lo)):
        lo, hi = np.zeros(3), np.zeros(3)
    part = spec.links[part_idx]
    meta = ObjectMeta(category, active_link,
                      half_depth=float((hi[0] - lo[0]) / 2),
                      half_height=float((hi[2] - lo[2]) / 2),
                      dof_lo=float(part.lo), dof_hi=float(part.hi))
    _CACHE[key] = (spec, meta)
    return spec, meta


def load_urdf_raw(path: str, active_link: str, in_part, log=None):
    from .urdf import load_urdf

    def vid_table(link_name: str):
        if in_part is None or link_name not in in_part:
            return 0
        def vid_of(visual_name: str) -> int:
            # "handle" for doors/drawers (open_cabinet.py:129-144); "lid"
            # for pots/mugs (open_pot.py:140-155)
            n = visual_name.lower()
            return VID_GRASP if ("handle" in n or "lid" in n) else VID_PART
        return vid_of

    # build per-link visual_ids mapping of callables (resolved per visual)
    import xml.etree.ElementTree as ET
    names = [el.get("name") for el in ET.parse(path).getroot().findall("link")]
    visual_ids = {n: vid_table(n) for n in names}
    return load_urdf(path, visual_ids=visual_ids, mesh_bounds=mesh_bounds,
                     prefer_visual_shapes=True, log=log)


def _canonicalize_active_link(spec: ArticulationSpec, part_idx: int) -> None:
    """Rotate the active link's frame into the canonical part orientation.

    The gt handle bbox is the AABB of the handle shapes IN THE PART LINK
    FRAME with a fixed corner permutation (reference open_cabinet.py:276-291
    + handle_pose:146-178): handle axis0 = link -z must point INTO the part
    face (the grasp approach direction), axis2 = link +y must point world-up
    at q=0. Real PartNet frames satisfy this by convention; arbitrary URDFs
    do not, so we re-express the link frame (rotating the joint origin and
    counter-rotating shapes + joint axis — pure reparameterization, no
    behavior change) with the outward direction derived from geometry: from
    the whole-object center toward the handle centroid, horizontalized.
    """
    from ..utils.transform import quat_mul

    link = spec.links[part_idx]
    poses = _fk_zero(spec)
    lp, lq = poses[part_idx]

    # object AABB (all links), active-part AABB, per-shape boxes and the
    # handle centroid, world at q=0
    lo = np.full(3, 1e18)
    hi = np.full(3, -1e18)
    plo = np.full(3, 1e18)
    phi = np.full(3, -1e18)
    part_boxes = []      # (center, half) of non-grasp shapes in the part
    grasp_centers = []
    any_part = False
    for li, l in enumerate(spec.links):
        p, q = poses[li]
        for s in l.shapes:
            c = p + quat_rotate(q, _shape_center_local(s))
            half = _shape_aabb_half(s)
            lo = np.minimum(lo, c - half)
            hi = np.maximum(hi, c + half)
            if li == part_idx:
                if s.visual_id == VID_GRASP:
                    grasp_centers.append(c)
                else:
                    # panel only: the handle's standoff would thicken the
                    # normal axis
                    plo = np.minimum(plo, c - half)
                    phi = np.maximum(phi, c + half)
                    part_boxes.append((c, np.asarray(half)))
                    any_part = True
    if not any_part:
        return
    center_w = (lo + hi) / 2
    if grasp_centers:
        # The face the handle stands off is the non-grasp shape NEAREST the
        # handle centroid; its thinnest axis is the face normal, signed
        # toward the handle (the reference derives approach from the handle
        # OBB the same way, open_cabinet.py:146-178). Using the whole part
        # subtree's AABB instead picks the wrong axis for drawers, whose
        # storage box behind the front panel dominates the depth axis.
        hc = np.mean(np.stack(grasp_centers), axis=0)
        pc, ph = min(part_boxes, key=lambda b: np.linalg.norm(b[0] - hc))
        ax = int(np.argmin(ph))
        d = hc[ax] - pc[ax]
        sign = (1.0 if d >= 0 else -1.0) if abs(d) > 1e-4 else \
               (1.0 if pc[ax] >= center_w[ax] else -1.0)
    else:
        # no handle: the part panel's thinnest axis, sign away from the
        # object center (a door/drawer front is thin along its normal, a
        # lid is thin along world z -> top-down approach)
        pdims = phi - plo
        ax = int(np.argmin(pdims))
        pc = (plo + phi) / 2
        sign = 1.0 if pc[ax] >= center_w[ax] else -1.0
    out_w = np.zeros(3)
    out_w[ax] = sign
    if ax != 2:
        y_w = np.array([0.0, 0.0, 1.0])
    else:
        y_w = np.array([0.0, 1.0, 0.0])   # lid: any horizontal up-substitute
    # canonical axes expressed in WORLD: local z -> outward (so handle
    # axis0 = -z points INTO the face), local y -> up, x right-handed
    z_w = out_w
    x_w = np.cross(y_w, z_w)
    # rotation matrix world->link applied to canonical axes gives their
    # link-frame coordinates = columns of R_c (canon frame in link coords)
    def to_link(v):
        return quat_rotate(_q_conj(lq), v)
    cols = np.stack([to_link(x_w), to_link(y_w), to_link(z_w)], axis=-1)
    qc = _quat_from_mat(cols)

    # link orientation picks up qc; shapes and joint axis counter-rotate
    o = np.asarray(link.origin, np.float64).copy()
    o[3:] = quat_mul(o[3:], qc)
    link.origin = o
    qc_inv = _q_conj(qc)
    for s in link.shapes:
        loc = np.asarray(s.local, np.float64).copy()
        loc[:3] = quat_rotate(qc_inv, loc[:3])
        loc[3:] = quat_mul(qc_inv, loc[3:])
        s.local = loc
    link.axis = tuple(quat_rotate(qc_inv, np.asarray(link.axis, np.float64)))
    # children of the active link (their joint origins live in this frame)
    for i, l in enumerate(spec.links):
        if l.parent == part_idx:
            o = np.asarray(l.origin, np.float64).copy()
            o[:3] = quat_rotate(qc_inv, o[:3])
            o[3:] = quat_mul(qc_inv, o[3:])
            l.origin = o


def _q_conj(q):
    q = np.asarray(q, np.float64)
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _quat_from_mat(m):
    """Quaternion from a 3x3 rotation matrix (columns orthonormal)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1e-12, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _shape_aabb_half(s):
    from .spec import S_BOX, S_MESH, S_SPHERE
    p = np.asarray(s.params, np.float64)
    if s.kind in (S_BOX, S_MESH):   # mesh params mirror its local AABB half
        return p[:3]
    if s.kind == S_SPHERE:
        return np.array([p[0]] * 3)
    return np.array([p[0], p[0], p[1]])   # cylinder (conservative, no rot)


def _shape_center_local(s):
    """Shape AABB center in the LINK frame (meshes are not origin-centered)."""
    loc = np.asarray(s.local, np.float64)
    from .spec import S_MESH
    if s.kind == S_MESH:
        from .objmesh import mesh_aabb
        lo, hi, _ = mesh_aabb(s.mesh)
        return loc[:3] + quat_rotate(loc[3:], (lo + hi) / 2)
    return loc[:3]


def _fk_zero(spec: ArticulationSpec):
    """Link world poses at zero joint positions (root at origin)."""
    from ..utils.transform import quat_mul
    poses = []
    for link in spec.links:
        o = np.asarray(link.origin, np.float64)
        if link.parent < 0:
            poses.append((o[:3].copy(), o[3:].copy()))
        else:
            pp, pq = poses[link.parent]
            poses.append((pp + quat_rotate(pq, o[:3]), quat_mul(pq, o[3:])))
    return poses
