"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/lib<name>-<hash>.so`` at the repo root (a directory that
``.gitignore`` lists), for ``sm_90a``. The file name carries a hash of the
source, so an edited kernel is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

from .. import PACKAGE_DIR, REPO_ROOT

BUILD_DIR = os.path.join(REPO_ROOT, "build")
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# what ptxas said about each kernel's registers and spills, by kernel name
PTXAS_REPORTS: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def _compile(name: str) -> str:
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
        PTXAS_REPORTS[name] = (res.stdout + res.stderr).strip()
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_all(names: Iterable[str]) -> None:
    """Compile several kernels at once, one ``nvcc`` per source."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for fut in [ex.submit(_compile, n) for n in names]:
            fut.result()


def load_library(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(_compile(name))
            _LIBS[name] = lib
        return lib
