"""Mesh AABB extraction for URDF mesh geometries.

PartNet-Mobility assets reference Wavefront ``.obj`` meshes (the reference
loads them through SAPIEN's mesh pipeline, ``utils/sapien_utils.py:90-172``);
the sim core is primitive-based, so mesh geoms enter as their AABB box via
``load_urdf``'s ``mesh_bounds`` callback. This module supplies that callback:
a dependency-free OBJ/STL vertex reader with a per-file cache.

(The port's copy of ``rgbmanip_tpu/assets/mesh.py``.)
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_CACHE: Dict[str, Optional[Tuple[np.ndarray, np.ndarray]]] = {}


def _obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                if len(parts) >= 4:
                    verts.append((float(parts[1]), float(parts[2]),
                                  float(parts[3])))
    return np.asarray(verts, np.float64)


def _stl_vertices(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(80)
        if head.lstrip().startswith(b"solid"):
            # could still be binary with a 'solid' header; try ascii first
            f.seek(0)
            try:
                text = f.read().decode("ascii")
                verts = []
                for line in text.splitlines():
                    line = line.strip()
                    if line.startswith("vertex"):
                        p = line.split()
                        verts.append((float(p[1]), float(p[2]), float(p[3])))
                if verts:
                    return np.asarray(verts, np.float64)
            except (UnicodeDecodeError, ValueError, IndexError):
                pass
            f.seek(80)
        n = struct.unpack("<I", f.read(4))[0]
        data = np.frombuffer(f.read(n * 50), dtype=np.uint8)
        if len(data) < n * 50:
            n = len(data) // 50
            data = data[: n * 50]
        tri = data.reshape(n, 50)
        floats = tri[:, :48].copy().view("<f4").reshape(n, 12)
        return floats[:, 3:12].reshape(-1, 3).astype(np.float64)


def mesh_aabb(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(center, half_extents) of the mesh's vertex AABB, or None."""
    key = os.path.abspath(path)
    if key in _CACHE:
        return _CACHE[key]
    result = None
    try:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            v = _obj_vertices(path)
        elif ext == ".stl":
            v = _stl_vertices(path)
        else:
            v = np.zeros((0, 3))
        if len(v):
            lo, hi = v.min(0), v.max(0)
            result = ((lo + hi) / 2.0, np.maximum((hi - lo) / 2.0, 1e-4))
    except (OSError, ValueError, struct.error):
        result = None
    _CACHE[key] = result
    return result


def mesh_bounds(path: str, scale) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``load_urdf`` mesh_bounds callback: scaled AABB of the mesh file."""
    ab = mesh_aabb(path)
    if ab is None:
        return None
    s = np.asarray(scale, np.float64)
    return ab[0] * s, np.abs(ab[1] * s)
