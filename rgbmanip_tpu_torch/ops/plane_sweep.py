"""The fused bilinear plane-sweep warp (kernel K2).

``warp_fuse(src, ref, rays, trans, depth)`` is the fused cost volume of one
direction of the stereo network's plane sweep: the reference features plus
the source features warped bilinearly over the depth hypotheses, zero where
a ray leaves the source image or falls behind its camera, by
``csrc/plane_sweep_fuse.cu`` on the card, for f32 or bf16 features of any
width. It is returned as (B, C, D, H, W) in the channels-last-3d layout the
3-D U-Net runs in on the card: the memory is (B, D, H, W, C), each point's
channels one contiguous row. Its plain version is the eager path of
``models/pose_estimator/nets/stereo.py`` (``fused_volume_plain``), which
returns the same layout.

The kernel computes, op for op, what that eager path computes (``_project``,
``_sample`` in bilinear mode and the fusing add): the projection of each
pixel's rotated ray ``rays`` (B, 3, H * W) at each depth, each product and
sum rounded to f32, the tap weights rounded to the features' dtype, each
product and sum of the taps rounded to it in the eager order, then the mask,
then the add of the reference features. So it equals the eager path bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.logger import count
from ._build import load_library

_KERNEL = "plane_sweep_fuse"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _entry(dtype):
    """The kernel's C entry point ``plane_sweep_fuse_<f32|bf16>``, built on
    first use."""
    fn = getattr(load_library(_KERNEL), f"{_KERNEL}_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(src, ref, rays, trans, depth):
    if src.dim() != 4 or src.shape != ref.shape:
        raise ValueError(f"src and ref must be one (B, H, W, C) shape, got "
                         f"{tuple(src.shape)} and {tuple(ref.shape)}")
    if src.dtype not in _SUFFIX or ref.dtype != src.dtype:
        raise ValueError(f"src and ref must be both float32 or both bfloat16, got "
                         f"{src.dtype} and {ref.dtype}")
    B, H, W, _ = src.shape
    for name, t, shape in (("rays", rays, (B, 3, H * W)), ("trans", trans, (B, 3)),
                           ("depth", depth, (B, depth.shape[-1]))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")


def warp_fuse(src, ref, rays, trans, depth):
    """K2. src, ref (B, H, W, C) f32 or bf16 on the card; rays (B, 3,
    H * W), trans (B, 3), depth (B, D) f32 on the same device. Returns the
    fused volume (B, C, D, H, W), channels-last-3d: a permuted view of the
    (B, D, H, W, C) rows the kernel writes."""
    _check(src, ref, rays, trans, depth)
    if not src.is_cuda:
        raise ValueError(f"K2 runs on the card, not on {src.device}: the eager warp "
                         f"(stereo.fused_volume_plain) is its plain version")
    B, H, W, C = src.shape
    D = depth.shape[1]
    if B * D * H * W >= 2 ** 31:
        raise ValueError(f"shape (B={B}, D={D}, H={H}, W={W}) is past the kernel's "
                         f"32-bit point indexing")
    # contiguous NHWC maps (a copy where the PSPNet hands a permuted view),
    # contiguous f32 tables; the kernel reads rows as 16-byte vectors where
    # they are whole vectors at aligned addresses, else channel by channel
    src, ref = src.contiguous(), ref.contiguous()
    rays, trans, depth = rays.contiguous(), trans.contiguous(), depth.contiguous()
    out = torch.empty((B, D, H, W, C), dtype=src.dtype, device=src.device)
    fn = _entry(src.dtype)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), ref.data_ptr(), rays.data_ptr(), trans.data_ptr(),
                 depth.data_ptr(), out.data_ptr(), B, H, W, C, D, stream)
    if err != 0:
        raise RuntimeError(f"plane_sweep_fuse kernel launch failed: cudaError {err}")
    warp_fuse.launches += 1
    count(k2_launches=1)
    return out.permute(0, 4, 1, 2, 3)


# kernel launches so far; a run sets it to 0 and reads it to show that its
# path went through the kernel
warp_fuse.launches = 0
