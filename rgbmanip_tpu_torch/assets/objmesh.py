"""Wavefront OBJ loading + registration with the C++ simcore mesh registry.

PartNet-Mobility objects ship per-part ``.obj`` meshes referenced from
``mobility.urdf`` (the reference loads them through SAPIEN,
``env/sapien_envs/base_manipulation.py:265-389``; gt part bboxes read the
same meshes, ``utils/sapien_utils.py:90-172``). This module parses the
geometry (``v``/``f`` records only — materials/normals/uvs are irrelevant to
collision and the flat-shaded raycaster), triangulates polygon faces as
fans, applies the URDF scale, and registers the result with the process-
global BVH registry in ``simcore.cpp`` (``sc_mesh_register``).

Registration is cached per (realpath, mtime, scale): PartNet scenes reuse
the same part meshes across envs and episodes, and the C++ registry is
immutable and shared by every env/thread, so each distinct mesh is parsed
and BVH-built exactly once per process.

(The port's copy of ``rgbmanip_tpu/assets/objmesh.py``.)
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..sim.bindings import dptr, get_lib, i32ptr

_cache: Dict[Tuple[str, float, Tuple[float, float, float]], int] = {}


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (verts (V, 3) float64, tris (T, 3) int32).

    Handles ``v x y z`` and ``f`` records with ``v``, ``v/vt``, ``v/vt/vn``,
    ``v//vn`` index forms, negative (relative) indices, and >3-gon faces
    (fan triangulation).
    """
    verts = []
    tris = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    f = np.asarray(tris, dtype=np.int32).reshape(-1, 3)
    return v, f


def register_mesh(verts: np.ndarray, tris: np.ndarray) -> int:
    """Register raw geometry with the simcore registry -> mesh id."""
    lib = get_lib()
    v = np.ascontiguousarray(np.asarray(verts, np.float64).reshape(-1, 3))
    f = np.ascontiguousarray(np.asarray(tris, np.int32).reshape(-1, 3))
    if len(v) == 0 or len(f) == 0:
        raise ValueError("register_mesh: empty geometry")
    if f.min() < 0 or f.max() >= len(v):
        raise ValueError(f"register_mesh: face index out of range "
                         f"[{f.min()}, {f.max()}] for {len(v)} verts")
    return lib.sc_mesh_register(dptr(v), len(v), i32ptr(f), len(f))


def register_obj(path: str, scale=(1.0, 1.0, 1.0)) -> int:
    """Load + register an OBJ file (cached) -> mesh id."""
    key = (os.path.realpath(path), os.path.getmtime(path),
           tuple(float(s) for s in np.broadcast_to(scale, (3,))))
    mid = _cache.get(key)
    if mid is not None:
        return mid
    v, f = load_obj(path)
    v = v * np.asarray(key[2], np.float64)
    mid = register_mesh(v, f)
    _cache[key] = mid
    return mid


def mesh_aabb(mesh_id: int):
    """(lo (3,), hi (3,), n_tris) of a registered mesh."""
    lib = get_lib()
    lo = np.zeros(3, np.float64)
    hi = np.zeros(3, np.float64)
    nt = lib.sc_mesh_stats(mesh_id, dptr(lo), dptr(hi))
    if nt < 0:
        raise KeyError(f"mesh id {mesh_id} not registered")
    return lo, hi, nt
