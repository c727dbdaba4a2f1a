"""The 3-D U-Net's one-output-channel convolution (kernel K7).

``prob_conv3d(x, weight)`` is ``CostRegNet.prob``, the U-Net's last layer, a
``Conv3d(8, 1, 3, padding=1, bias=False)``, by ``csrc/prob_conv3d.cu`` on the
card: x is the bf16 volume (B, 8, D, H, W) in the channels-last-3d layout the
U-Net runs in on the card (memory (B, D, H, W, 8)), weight the layer's
(1, 8, 3, 3, 3) filter, rounded to bf16 as the layer computes in bf16. It
returns (B, 1, D, H, W) in bf16: each product exact in f32, the 216 terms
summed in f32, the sum rounded once to bf16, the same work as cuDNN's bf16
convolution in another order of the f32 sum (so the two may differ by a
bf16 rounding). Its plain version, ``prob_conv3d_plain``, is ``F.conv3d``.

``takes`` says whether a convolution module is K7's convolution;
``nets/stereo.py::ProbConv3d`` routes through K7 where it applies.
``reference_gaps`` holds K7's output to the f64-accumulated convolution.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.logger import count
from ._build import load_library

_KERNEL = "prob_conv3d"
CHANNELS = 8


@functools.cache
def _entry():
    """The kernel's C entry point ``prob_conv3d_bf16``, built on first use."""
    fn = load_library(_KERNEL).prob_conv3d_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def takes(conv) -> bool:
    """Whether ``conv`` (an ``nn.Conv3d``) is K7's convolution: 8 -> 1
    channels, a 3x3x3 filter, stride 1, zero padding 1, no dilation, no
    groups, no bias."""
    return (conv.in_channels == CHANNELS and conv.out_channels == 1
            and tuple(conv.kernel_size) == (3, 3, 3) and tuple(conv.stride) == (1, 1, 1)
            and tuple(conv.padding) == (1, 1, 1) and tuple(conv.dilation) == (1, 1, 1)
            and conv.groups == 1 and conv.bias is None and conv.padding_mode == "zeros")


def _check(x, weight):
    if x.dim() != 5 or x.shape[1] != CHANNELS:
        raise ValueError(f"x must be (B, {CHANNELS}, D, H, W), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError("x must be channels-last-3d: memory (B, D, H, W, C)")
    if tuple(weight.shape) != (1, CHANNELS, 3, 3, 3):
        raise ValueError(f"weight must be (1, {CHANNELS}, 3, 3, 3), got {tuple(weight.shape)}")
    if weight.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight must be float32 or bfloat16, got {weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"weight is on {weight.device}, x on {x.device}")


def prob_conv3d(x, weight):
    """K7. x (B, 8, D, H, W) bf16 channels-last-3d on the card; weight
    (1, 8, 3, 3, 3) f32 or bf16 on the same device. Returns (B, 1, D, H, W)
    bf16, contiguous."""
    _check(x, weight)
    if not x.is_cuda:
        raise ValueError(f"K7 runs on the card, not on {x.device}: F.conv3d "
                         f"(prob_conv.prob_conv3d_plain) is its plain version")
    B, _, D, H, W = x.shape
    if B >= 2 ** 16:
        raise ValueError(f"batch {B} is past the kernel's grid (at most 65535)")
    if x.data_ptr() % 16:
        raise ValueError("x must start at a 16-byte aligned address")
    w = weight.detach().float().contiguous()   # the f32 parameter as it is
    out = torch.empty((B, 1, D, H, W), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, D, H, W, stream)
    if err != 0:
        raise RuntimeError(f"prob_conv3d kernel launch failed: cudaError {err}")
    count(k7_launches=1)
    return out


def prob_conv3d_plain(x, weight):
    """K7's plain version: ``F.conv3d`` of x and weight in x's dtype, stride
    1, padding 1, no bias."""
    return F.conv3d(x, weight.to(x.dtype), None, 1, 1)


def _ulp(t):
    """One bf16 ulp of each value of ``t`` (bf16 values as f64)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(1e-30))) - 7)


def reference_gaps(out, x, weight) -> dict:
    """K7's ``out`` of (x, weight) and cuDNN's bf16 convolution of them, each
    against the reference: the convolution of the same bf16 values
    accumulated in f64 and rounded once to bf16. Returns the largest error
    of each (``max_err``, ``library_max_err``), K7's share of outputs equal
    to the reference (``equal``), and ``held``: every K7 error is at most
    the larger of 1 bf16 ulp of the reference value and cuDNN's largest
    error, and at least 99% of K7's outputs equal the reference. The room
    is for the f32 sum's order: where an output's terms cancel, the two
    engines' f32 sums round apart, by more than an ulp of the small result."""
    wb = weight.detach().to(torch.bfloat16)
    ref = F.conv3d(x.double(), wb.double(), None, 1, 1).to(torch.bfloat16).double()
    lib = prob_conv3d_plain(x, wb).double()
    err, lib_err = (out.double() - ref).abs(), (lib - ref).abs()
    lib_max = lib_err.max().item()
    equal = (out.double() == ref).double().mean().item()
    within = bool((err <= _ulp(ref).clamp_min(lib_max)).all().item())
    return {"max_err": err.max().item(), "library_max_err": lib_max, "equal": equal,
            "held": within and equal >= 0.99}
