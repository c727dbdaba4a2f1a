"""Fused crop -> bilinear resize -> ImageNet normalise (kernel K1), in two
border modes.

``crop_resize_normalize`` launches the CUDA kernel in
``csrc/crop_resize_normalize.cu`` for a CUDA tensor and takes the plain
PyTorch version, ``crop_resize_normalize_plain``, only for a CPU tensor.
Both compute what the Pallas kernel
``rgbmanip_tpu/ops/pallas_preprocess.py::crop_resize_normalize`` computes:
per image, the square window (rmin, cmin, inv_ratio = 1/ratio) resampled to
S x S with renormalised hat weights (a tap outside the frame is dropped and
the remaining taps divided by their sum, floor 1e-6), then normalised.
The window's scale comes in as ``inv_ratio``, the value the kernel
multiplies by, so that the caller decides how it is rounded (the JAX
wrapper's ``1 / ratio`` is rewritten by XLA when the crop is inlined into
its caller; see ``ops/preprocess.py``).

``crop_resize_normalize_clamp`` (plain twin
``crop_resize_normalize_clamp_plain``) is the kernel's clamping border mode:
what the JAX package's portable fallback computes (``prepare_model_input``
without Pallas, over ``bilinear_sample_batched``), which is the crop of its
estimator trainer's every batch. It takes (rmin, cmin, ratio), clamps the
taps into the frame with weights from the unclamped floor, and rounds as
XLA does on the CPU (see the kernel's source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_KERNEL = "crop_resize_normalize"
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _entry(name: str, out_dtype):
    """The kernel's C entry point ``<name>_<f32|bf16>``, built on first use."""
    fn = getattr(load_library(_KERNEL), f"{name}_{_SUFFIX[out_dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_params(rmin, cmin, inv_ratio) -> torch.Tensor:
    """(B, 3) f32 rows (rmin, cmin, inv_ratio)."""
    return torch.stack([rmin.float(), cmin.float(), inv_ratio.float()], dim=-1)


def _hat_taps(lo, inv_ratio, S: int, n: int):
    """The two taps of each renormalised hat row: (B, S) indices i0, i1
    (clamped into the frame) and weights w0, w1 (0 outside the frame)."""
    ii = torch.arange(S, dtype=torch.float32, device=lo.device)[None]
    # src = fma(i + 0.5, inv_ratio, lo) - 0.5: XLA fuses the multiply-add,
    # and so does the kernel. The f32 product is exact in f64 and the sum
    # with an integral lo as well, so one rounding to f32 is the FMA's.
    src = ((ii + 0.5).double() * inv_ratio[:, None].double()
           + lo[:, None].double()).float() - 0.5
    f0 = torch.floor(src)
    f1 = f0 + 1.0
    w0 = torch.clamp_min(1.0 - torch.abs(src - f0), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(src - f1), 0.0)
    in0 = (f0 >= 0) & (f0 <= n - 1)
    in1 = (f1 >= 0) & (f1 <= n - 1)
    w0 = torch.where(in0, w0, torch.zeros_like(w0))
    w1 = torch.where(in1, w1, torch.zeros_like(w1))
    norm = torch.clamp_min(w0 + w1, 1e-6)
    i0 = torch.where(in0, f0, torch.zeros_like(f0)).long()
    i1 = torch.where(in1, f1, torch.zeros_like(f1)).long()
    return i0, i1, w0 / norm, w1 / norm


def _fma(a, b, c):
    """fma(a, b, c) of f32 tensors, rounded once. The f64 product is exact;
    the f64 sum is made round-to-odd (its last bit set where TwoSum finds it
    inexact), and a round-to-odd value of 53 bits rounds to 24 as the exact
    sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, torch.inf), err))
    return torch.where((err != 0) & even, away, s).float()


def _clamp_taps(lo, ratio, S: int, n: int):
    """The clamping mode's taps: (B, S) indices i0 = clip(floor(src)),
    i1 = min(i0 + 1, n - 1) and weights 1 - w, w from the unclamped floor,
    with src = (lo + (i + 0.5) / ratio) - 0.5, each step rounded once."""
    ii = torch.arange(S, dtype=torch.float32, device=lo.device)[None]
    src = (lo[:, None] + (ii + 0.5) / ratio[:, None]) - 0.5
    f = torch.floor(src)
    w = src - f
    i0 = f.clamp(0, n - 1).long()
    return i0, (i0 + 1).clamp_max(n - 1), 1.0 - w, w


def crop_resize_normalize_clamp_plain(rgb, rmin, cmin, ratio, out_size: int = 224,
                                      out_dtype=torch.float32):
    """Plain PyTorch version of K1's clamping mode, on any device. rgb
    (B, H, W, 3) f32 in [0, 1]; rmin/cmin/ratio (B,), ratio = S / side.
    Returns (B, S, S, 3) in ``out_dtype``."""
    B, H, W, _ = rgb.shape
    S = out_size
    rgb = rgb.float()
    win = window_params(rmin, cmin, ratio)
    y0, y1, wy0, wy1 = _clamp_taps(win[:, 0], win[:, 2], S, H)
    x0, x1, wx0, wx1 = _clamp_taps(win[:, 1], win[:, 2], S, W)
    bb = torch.arange(B, device=rgb.device)[:, None, None]

    def tap(yi, xi):
        return rgb[bb, yi[:, :, None], xi[:, None, :]]           # (B, S, S, 3)

    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]
    wx0, wx1 = wx0[:, None, :, None], wx1[:, None, :, None]
    # XLA's order: fma(g00 wy0, wx0, (g01 wy0) wx1), + g10 wy1 wx0, + g11 wy1 wx1
    v = _fma(tap(y0, x0) * wy0, wx0, (tap(y0, x1) * wy0) * wx1)
    v = _fma(tap(y1, x0) * wy1, wx0, v)
    v = _fma(tap(y1, x1) * wy1, wx1, v)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=rgb.device)
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, dtype=torch.float32, device=rgb.device)
    return ((v - mean) * inv_std).to(out_dtype)


def crop_resize_normalize_plain(rgb, rmin, cmin, inv_ratio, out_size: int = 224,
                                out_dtype=torch.float32):
    """Plain PyTorch version of K1, on any device. rgb (B, H, W, 3) f32 in
    [0, 1]; rmin/cmin/inv_ratio (B,). Returns (B, S, S, 3) in ``out_dtype``."""
    B, H, W, _ = rgb.shape
    S = out_size
    rgb = rgb.float()
    win = window_params(rmin, cmin, inv_ratio)
    y0, y1, wy0, wy1 = _hat_taps(win[:, 0], win[:, 2], S, H)
    x0, x1, wx0, wx1 = _hat_taps(win[:, 1], win[:, 2], S, W)
    bb = torch.arange(B, device=rgb.device)[:, None, None]

    def tap(yi, xi):
        return rgb[bb, yi[:, :, None], xi[:, None, :]]           # (B, S, S, 3)

    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]
    wx0, wx1 = wx0[:, None, :, None], wx1[:, None, :, None]
    # rows first, then columns: the TPU kernel's (Wy @ img) @ Wx^T
    col0 = wy0 * tap(y0, x0) + wy1 * tap(y1, x0)
    col1 = wy0 * tap(y0, x1) + wy1 * tap(y1, x1)
    v = wx0 * col0 + wx1 * col1
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=rgb.device)
    return ((v - mean) / std).to(out_dtype)


def _check(rgb, rmin, cmin, inv_ratio, out_dtype):
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be (B, H, W, 3), got {tuple(rgb.shape)}")
    if rgb.dtype != torch.float32:
        raise ValueError(f"rgb must be float32, got {rgb.dtype}")
    if not rgb.is_contiguous():
        raise ValueError("rgb must be contiguous (B, H, W, 3)")
    B = rgb.shape[0]
    for name, t in (("rmin", rmin), ("cmin", cmin), ("inv_ratio", inv_ratio)):
        if t.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},), got {tuple(t.shape)}")
        if t.device != rgb.device:
            raise ValueError(f"{name} is on {t.device}, rgb on {rgb.device}")
    if out_dtype not in _SUFFIX:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _launch(name: str, rgb, rmin, cmin, scale, out_size: int, out_dtype):
    """Launch the C entry point ``name`` on a CUDA tensor (or raise)."""
    if rgb.device.type != "cuda":
        raise ValueError(f"no kernel for device {rgb.device}")
    B, H, W, _ = rgb.shape
    if rgb.data_ptr() % 16:
        raise ValueError("rgb must be 16-byte aligned (a view at an offset?): the "
                         "kernel reads it in 16-byte vectors")
    if B > 65535 or H * W * 3 >= 2 ** 31:
        raise ValueError(f"shape (B={B}, H={H}, W={W}) is past the kernel's grid "
                         f"(B <= 65535) or its 32-bit frame indexing")
    win = window_params(rmin, cmin, scale).contiguous()
    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype,
                      device=rgb.device)
    fn = _entry(name, out_dtype)
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream(rgb.device).cuda_stream
        err = fn(rgb.data_ptr(), win.data_ptr(), out.data_ptr(), B, H, W,
                 out_size, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def _count(wrapper, out_dtype):
    wrapper.launches += 1
    if out_dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1


def crop_resize_normalize(rgb, rmin, cmin, inv_ratio, out_size: int = 224,
                          out_dtype=torch.float32):
    """K1. rgb (B, H, W, 3) f32 contiguous in [0, 1] (on the card also
    16-byte aligned); rmin/cmin/inv_ratio (B,) on the same device. Returns
    (B, S, S, 3) normalised, in ``out_dtype`` (float32 or bfloat16). A CUDA
    tensor goes through the kernel (or the call raises); only a CPU tensor
    takes the plain version."""
    _check(rgb, rmin, cmin, inv_ratio, out_dtype)
    if rgb.device.type == "cpu":
        return crop_resize_normalize_plain(rgb, rmin, cmin, inv_ratio, out_size,
                                           out_dtype)
    out = _launch("crop_resize_normalize", rgb, rmin, cmin, inv_ratio, out_size,
                  out_dtype)
    _count(crop_resize_normalize, out_dtype)
    return out


def crop_resize_normalize_clamp(rgb, rmin, cmin, ratio, out_size: int = 224,
                                out_dtype=torch.float32):
    """K1's clamping border mode, as ``crop_resize_normalize`` takes its
    arguments but for ``ratio`` = S / side (the value the clamping rule
    divides by) in place of ``inv_ratio``."""
    _check(rgb, rmin, cmin, ratio, out_dtype)
    if rgb.device.type == "cpu":
        return crop_resize_normalize_clamp_plain(rgb, rmin, cmin, ratio, out_size,
                                                 out_dtype)
    out = _launch("crop_resize_normalize_clamp", rgb, rmin, cmin, ratio, out_size,
                  out_dtype)
    _count(crop_resize_normalize_clamp, out_dtype)
    return out


# kernel launches so far of each border mode, and those of its bf16 entry
# point among them; a run sets them to 0 and reads them to show that the
# main path went through the kernel
crop_resize_normalize.launches = 0
crop_resize_normalize.launches_bf16 = 0
crop_resize_normalize_clamp.launches = 0
crop_resize_normalize_clamp.launches_bf16 = 0
