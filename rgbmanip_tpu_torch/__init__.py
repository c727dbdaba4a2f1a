"""rgbmanip_tpu_torch: the PyTorch/CUDA port of ``rgbmanip_tpu`` for NVIDIA
Hopper cards.

The package stands alone: it imports ``torch``, ``numpy``, ``msgpack`` and
``yaml``, never JAX or the JAX package. Entry points take ``device=None``,
which means the card (``"cuda"``); they raise when CUDA is asked for and is
missing. Pass ``device="cpu"`` explicitly to run the plain PyTorch path.
"""

from __future__ import annotations

import os

import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)


def repo_path(path: str) -> str:
    """Resolve a repo-relative path (``checkpoints/...``) from this file,
    not from the current working directory. Absolute paths pass through."""
    return path if os.path.isabs(path) else os.path.join(REPO_ROOT, path)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
