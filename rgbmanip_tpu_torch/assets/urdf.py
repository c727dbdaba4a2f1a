"""URDF -> ArticulationSpec parser.

The reference loads robots and PartNet-Mobility objects from URDF through
SAPIEN (``env/sapien_envs/base_manipulation.py:265-389``,
``cfg/dataset/*.yaml`` object catalogs point at ``mobility.urdf`` files).
This parser maps the same files onto the C++ simcore's articulation spec:

- joints become the child link's (joint_type, origin, axis, limits) — the
  URDF joint origin is the child-frame pose in the parent frame and the
  axis is expressed in the child/joint frame, which is exactly the spec's
  convention (``spec.LinkSpec``);
- ``continuous`` joints become revolute with wide limits;
- box / cylinder / sphere geometries map 1:1 (URDF box size is full
  extents -> half extents; cylinder length -> half height);
- mesh geometries (.obj) load as REAL triangle meshes into the C++ core's
  BVH registry (``assets.objmesh``) — exact collision, raycast rendering,
  and gt part bboxes, like SAPIEN's native mesh path; the ``mesh_bounds``
  callback (path, scale) -> (center, half_extents) remains as a fallback
  for non-obj formats or when ``load_meshes=False`` (shape becomes its
  AABB box); with neither, the shape is skipped with a warning and the
  link stays massless-collisionless, matching how the reference treats
  pure-visual links.

Links are re-ordered topologically (the C++ core requires parent index <
child index). Per-link segmentation ids and drive gains are caller
overrides (the reference sets Panda drive stiffness/damping in code, not
URDF — ``base_manipulation.py:354-359``).

(The port's copy of ``rgbmanip_tpu/assets/urdf.py``.)
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .spec import (ArticulationSpec, LinkSpec, ShapeSpec, J_FIXED, J_PRISMATIC,
                   J_REVOLUTE, S_BOX, S_CYLINDER, S_MESH, S_SPHERE, pose7,
                   rpy_to_quat)

_JOINT_TYPES = {"fixed": J_FIXED, "revolute": J_REVOLUTE,
                "prismatic": J_PRISMATIC, "continuous": J_REVOLUTE}


def _floats(text: Optional[str], n: int, default=0.0) -> np.ndarray:
    if not text:
        return np.full(n, default, dtype=np.float64)
    vals = [float(v) for v in text.split()]
    return np.asarray(vals + [default] * (n - len(vals)), dtype=np.float64)


def _origin_pose(el: Optional[ET.Element]) -> np.ndarray:
    if el is None:
        return pose7()
    xyz = _floats(el.get("xyz"), 3)
    rpy = _floats(el.get("rpy"), 3)
    return pose7(xyz, rpy_to_quat(*rpy))


def _shapes_from(link_el: ET.Element, collide: bool, visual_id: int,
                 color: Tuple[float, float, float],
                 mesh_bounds: Optional[Callable], urdf_dir: str, log=None,
                 load_meshes: bool = True):
    shapes = []
    tag = "collision" if collide else "visual"
    for el in link_el.findall(tag):
        geom = el.find("geometry")
        if geom is None:
            continue
        # visual_id may be a callable (element name -> id): PartNet-Mobility
        # marks handles at the VISUAL level (<visual name="handle-3">), the
        # reference's seg-id convention keys off that name
        # (open_cabinet.py:129-144)
        vid = visual_id(el.get("name", "") or "") if callable(visual_id) \
            else visual_id
        local = _origin_pose(el.find("origin"))
        box = geom.find("box")
        cyl = geom.find("cylinder")
        sph = geom.find("sphere")
        mesh = geom.find("mesh")
        if box is not None:
            size = _floats(box.get("size"), 3, 0.01)
            shapes.append(ShapeSpec(S_BOX, tuple(size / 2), local, color,
                                    vid, collide))
        elif cyl is not None:
            r = float(cyl.get("radius", 0.01))
            hh = float(cyl.get("length", 0.02)) / 2
            shapes.append(ShapeSpec(S_CYLINDER, (r, hh, 0.0), local, color,
                                    vid, collide))
        elif sph is not None:
            r = float(sph.get("radius", 0.01))
            shapes.append(ShapeSpec(S_SPHERE, (r, 0.0, 0.0), local, color,
                                    vid, collide))
        elif mesh is not None:
            fname = mesh.get("filename", "")
            scale = _floats(mesh.get("scale"), 3, 1.0)
            mpath = os.path.join(urdf_dir, fname)
            # true triangle geometry first: .obj meshes load into the C++
            # BVH registry (collision, raycast render, gt bboxes all exact)
            if load_meshes and mpath.lower().endswith(".obj") \
                    and os.path.exists(mpath):
                from .objmesh import register_obj
                try:
                    mid = register_obj(mpath, scale)
                except (ValueError, OSError) as e:
                    if log is not None:
                        log.warning(f"urdf: mesh {fname!r} failed to load "
                                    f"({e}); trying AABB fallback")
                    mid = -1
                if mid >= 0:
                    # params mirror the mesh's local AABB half extents so
                    # Python-side conservative-AABB consumers
                    # (urdf_object._shape_aabb_half) keep working; the AABB
                    # center offset is queried via objmesh.mesh_aabb.
                    from .objmesh import mesh_aabb
                    mlo, mhi, _ = mesh_aabb(mid)
                    shapes.append(ShapeSpec(S_MESH, tuple((mhi - mlo) / 2),
                                            local, color, vid, collide,
                                            mesh=mid))
                    continue
            bounds = None
            if mesh_bounds is not None:
                bounds = mesh_bounds(mpath, scale)
            if bounds is None:
                if log is not None:
                    log.warning(f"urdf: no bounds for mesh {fname!r}; skipped")
                continue
            center, half = bounds
            p = np.asarray(local, dtype=np.float64).copy()
            # shift the box local pose by the mesh AABB center (rotation of
            # `local` applied to the offset)
            from ..utils.transform import quat_rotate
            p[:3] = p[:3] + quat_rotate(p[3:], np.asarray(center, np.float64))
            shapes.append(ShapeSpec(S_BOX, tuple(np.asarray(half, np.float64)),
                                    p, color, vid, collide))
    return shapes


def load_urdf(path: str,
              visual_ids: Optional[Dict[str, int]] = None,
              colors: Optional[Dict[str, Tuple[float, float, float]]] = None,
              drive: Optional[Dict[str, Tuple[float, float]]] = None,
              mesh_bounds: Optional[Callable] = None,
              use_visual_as_collision: bool = False,
              prefer_visual_shapes: bool = False,
              load_meshes: bool = True,
              log=None) -> ArticulationSpec:
    """Parse a URDF file into an ArticulationSpec.

    visual_ids: link name -> segmentation id (e.g. handle link -> 129,
    reference ``open_cabinet.py:129-144`` id convention).
    drive: joint name -> (stiffness, damping) drive gains.
    mesh_bounds: (abs mesh path, scale[3]) -> (center[3], half_extents[3])
    or None; consulted for mesh geometries when true mesh loading is off or
    fails. load_meshes: parse .obj files into real triangle geometry
    (BVH-backed collision/raycast in the C++ core); default on.
    """
    tree = ET.parse(path)
    robot = tree.getroot()
    urdf_dir = os.path.dirname(os.path.abspath(path))
    visual_ids = visual_ids or {}
    colors = colors or {}
    drive = drive or {}

    link_els: Dict[str, ET.Element] = {}
    for el in robot.findall("link"):
        link_els[el.get("name")] = el

    # child link name -> joint element
    joint_of: Dict[str, ET.Element] = {}
    parent_of: Dict[str, str] = {}
    for el in robot.findall("joint"):
        child = el.find("child").get("link")
        parent_of[child] = el.find("parent").get("link")
        joint_of[child] = el

    roots = [n for n in link_els if n not in parent_of]
    if len(roots) != 1:
        raise ValueError(f"urdf {path}: expected one root link, got {roots}")

    # topological order (children after parents)
    order = [roots[0]]
    children: Dict[str, list] = {}
    for c, p in parent_of.items():
        children.setdefault(p, []).append(c)
    i = 0
    while i < len(order):
        order.extend(sorted(children.get(order[i], [])))
        i += 1
    if len(order) != len(link_els):
        missing = sorted(set(link_els) - set(order))
        raise ValueError(f"urdf {path}: links unreachable from root "
                         f"{roots[0]!r} (broken parent name or cycle): "
                         f"{missing}")

    spec = ArticulationSpec()
    index: Dict[str, int] = {}
    for name in order:
        el = link_els[name]
        vid = visual_ids.get(name, 0)
        color = colors.get(name, (0.7, 0.7, 0.7))
        if prefer_visual_shapes:
            # PartNet-Mobility: visuals carry the semantic names ("handle-3")
            # the seg-id convention needs, collisions are unnamed duplicates —
            # use the visual set for BOTH rendering and collision
            shapes = _shapes_from(el, False, vid, color, mesh_bounds,
                                  urdf_dir, log, load_meshes)
            for s in shapes:
                s.collide = True
            if not shapes:
                shapes = _shapes_from(el, True, vid, color, mesh_bounds,
                                      urdf_dir, log, load_meshes)
        else:
            shapes = _shapes_from(el, True, vid, color, mesh_bounds, urdf_dir,
                                  log, load_meshes)
            if not shapes and use_visual_as_collision:
                shapes = _shapes_from(el, False, vid, color, mesh_bounds,
                                      urdf_dir, log, load_meshes)
                for s in shapes:
                    s.collide = True
        if name == order[0]:
            spec.links.append(LinkSpec(name, parent=-1, joint_type=J_FIXED,
                                       shapes=shapes))
            index[name] = 0
            continue
        j = joint_of[name]
        jtype = _JOINT_TYPES.get(j.get("type", "fixed"), J_FIXED)
        origin = _origin_pose(j.find("origin"))
        axis_el = j.find("axis")
        # URDF spec: <axis> defaults to (1, 0, 0) when omitted
        axis = tuple(_floats(axis_el.get("xyz") if axis_el is not None else "1 0 0", 3))
        limit = j.find("limit")
        if j.get("type") == "continuous":
            lo, hi = -2 * np.pi, 2 * np.pi
        elif limit is not None and jtype != J_FIXED:
            lo = float(limit.get("lower", 0.0))
            hi = float(limit.get("upper", 0.0))
        else:
            lo = hi = 0.0
        dyn = j.find("dynamics")
        fric = float(dyn.get("friction", 0.0)) if dyn is not None else 0.0
        ov = drive.get(j.get("name", name))
        if ov is not None:
            st, dp = ov   # explicit caller gains, even (x, 0.0)
        else:
            st = 0.0
            dp = float(dyn.get("damping", 0.0)) if dyn is not None else 0.0
        spec.links.append(LinkSpec(
            name, parent=index[parent_of[name]], joint_type=jtype,
            origin=origin, axis=axis, lo=lo, hi=hi, stiffness=st, damping=dp,
            friction=fric, shapes=shapes))
        index[name] = len(spec.links) - 1
    return spec
