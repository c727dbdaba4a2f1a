"""ctypes bindings to the port's own ``libsimcore`` (the C++ physics,
planner and renderer core in ``csrc/``, a byte-for-byte copy of the JAX
package's).

The library is built with ``g++`` on first use into
``build/libsimcore-<hash>.so`` at the repo root (a directory that
``.gitignore`` lists), the way ``ops/_build.py`` builds the CUDA kernels.
The flags are those of the JAX package's Makefile, so both packages render
identical frames on one machine. The hash covers the sources, the flags,
the compiler's version and the host's CPU model: a ``-march=native`` library
built on one machine is never loaded on another. The library is written
under a temporary name and renamed, so processes that build at once do not
race. It is loaded by its absolute path with ``RTLD_LOCAL``: the JAX
package's library exports the same ``sc_*`` symbols, and the two can live in
one process. All batched entry points release the GIL for the duration of
the C call; parallelism lives in the C++ thread pool.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from .. import REPO_ROOT

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("simcore.cpp", "math3d.h")
BUILD_DIR = os.path.join(REPO_ROOT, "build")
# rgbmanip_tpu/sim/csrc/Makefile:3-4 (warnings left out: they change no code)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_LOCK = threading.Lock()


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the simulator's C++ core is built with "
                           "g++ on first use")
    return gxx


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return os.uname().machine


def library_path() -> str:
    """``build/libsimcore-<hash>.so`` for these sources, flags, compiler and
    CPU model."""
    gxx = _gxx()
    version = subprocess.run([gxx, "-dumpfullversion"], capture_output=True,
                             text=True, check=True).stdout.strip()
    h = hashlib.sha1()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join((*CXX_FLAGS, version, _cpu_model())).encode())
    return os.path.join(BUILD_DIR, f"libsimcore-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``csrc/simcore.cpp`` unless its library exists; returns the
    library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_gxx(), *CXX_FLAGS, os.path.join(CSRC_DIR, "simcore.cpp"),
                              "-o", tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for {CSRC_DIR}/simcore.cpp:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> C.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = C.CDLL(build(), mode=os.RTLD_LOCAL)

        d = C.POINTER(C.c_double)
        f = C.POINTER(C.c_float)
        u8 = C.POINTER(C.c_uint8)
        i32 = C.POINTER(C.c_int32)
        vp = C.c_void_p

        sigs = {
            "sc_pool_create": ([C.c_int, C.c_int], vp),
            "sc_pool_destroy": ([vp], None),
            "sc_pool_threads": ([vp], C.c_int),
            "sc_env_clear": ([vp, C.c_int], None),
            "sc_env_seed": ([vp, C.c_int, C.c_uint64], None),
            "sc_env_set_dt": ([vp, C.c_int, C.c_double], None),
            "sc_art_create": ([vp, C.c_int, d], C.c_int),
            "sc_art_add_link": ([vp, C.c_int, C.c_int, C.c_int, C.c_int, d, d,
                                 C.c_double, C.c_double, C.c_double, C.c_double,
                                 C.c_double, C.c_double], C.c_int),
            "sc_link_add_shape": ([vp, C.c_int, C.c_int, C.c_int, C.c_int, d, d, d,
                                   C.c_int, C.c_int], None),
            "sc_mesh_register": ([d, C.c_int, i32, C.c_int], C.c_int),
            "sc_mesh_stats": ([C.c_int, d, d], C.c_int),
            "sc_link_add_mesh": ([vp, C.c_int, C.c_int, C.c_int, C.c_int, d, d,
                                  C.c_int, C.c_int], None),
            "sc_art_finish": ([vp, C.c_int, C.c_int], None),
            "sc_set_robot": ([vp, C.c_int, C.c_int, C.c_int, C.c_int], None),
            "sc_set_grasp_config": ([vp, C.c_int, C.c_int, C.c_int, C.c_int,
                                     C.c_double, C.c_double, C.c_int], None),
            "sc_get_grasped": ([vp, C.c_int], C.c_int),
            "sc_release_grasp": ([vp, C.c_int], None),
            "sc_art_dof": ([vp, C.c_int, C.c_int], C.c_int),
            "sc_art_links": ([vp, C.c_int, C.c_int], C.c_int),
            "sc_art_get_qpos": ([vp, C.c_int, C.c_int, d], None),
            "sc_art_set_qpos": ([vp, C.c_int, C.c_int, d], None),
            "sc_art_get_qvel": ([vp, C.c_int, C.c_int, d], None),
            "sc_art_get_qlimits": ([vp, C.c_int, C.c_int, d, d], None),
            "sc_art_set_root": ([vp, C.c_int, C.c_int, d], None),
            "sc_art_set_drive_target": ([vp, C.c_int, C.c_int, d], None),
            "sc_art_get_drive_target": ([vp, C.c_int, C.c_int, d], None),
            "sc_art_get_link_pose": ([vp, C.c_int, C.c_int, C.c_int, d], None),
            "sc_get_hand_pose": ([vp, C.c_int, d], None),
            "sc_get_part_aabb": ([vp, C.c_int, C.c_int, C.c_int, C.c_int, d, d], C.c_int),
            "sc_step_all": ([vp, u8, d, C.c_int, C.c_int, C.c_int], None),
            "sc_exec_ik_move": ([vp, u8, d, C.c_int, C.c_int, u8], None),
            "sc_exec_path_move": ([vp, u8, d, C.c_int, C.c_int, C.c_int, C.c_int, u8], None),
            "sc_gripper_toggle": ([vp, u8, C.c_int, C.c_int], None),
            "sc_release_target": ([vp, u8], None),
            "sc_ik": ([vp, C.c_int, d, d, d, C.c_int, C.c_double], C.c_int),
            "sc_link_jacobian": ([vp, C.c_int, C.c_int, C.c_int, d], None),
            "sc_render_all": ([vp, u8, d, C.c_int, C.c_int, C.c_double, f, f, f, f, i32],
                              None),
            "sc_version": ([], C.c_int),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def _check(a: np.ndarray, dtype) -> None:
    if a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"simcore needs a C-contiguous {np.dtype(dtype)} array, "
                         f"got {a.dtype} (contiguous: {a.flags['C_CONTIGUOUS']})")


def dptr(a: np.ndarray):
    _check(a, np.float64)
    return a.ctypes.data_as(C.POINTER(C.c_double))


def fptr(a: np.ndarray):
    _check(a, np.float32)
    return a.ctypes.data_as(C.POINTER(C.c_float))


def u8ptr(a):
    if a is None:
        return None
    _check(a, np.uint8)
    return a.ctypes.data_as(C.POINTER(C.c_uint8))


def i32ptr(a: np.ndarray):
    _check(a, np.int32)
    return a.ctypes.data_as(C.POINTER(C.c_int32))
