"""Layers that compute in a chosen dtype by flax's rule, the rule of the JAX
package's modules (``dtype=jnp.bfloat16`` there):

- the parameters stay f32;
- a convolution, transposed convolution or dense layer casts its input and
  its weight to ``dtype``, computes there (f32 accumulation, one rounding)
  and returns ``dtype``; a bias is cast too and added after the product,
  a second rounding, as flax's ``y += bias`` is;
- ``PReLU`` multiplies by its f32 slope, so its output is f32 whatever its
  input (flax promotes ``alpha * x``);
- ``cumsum`` rounds after every add, as XLA's reduce-window cumulative sum
  does in a reduced dtype (up to 16 terms on the CPU; longer sums are
  blocked there).

At f32 every cast is the identity and the layers are PyTorch's own; so are
the pooling and resize ops of the networks, which in a reduced dtype follow
the JAX modules' rounding steps instead (at f32 the order of a sum moves
results by f32 rounding only, and PyTorch's ops are the fast ones). The
mirrored steps are what hold each layer to the JAX package's bf16: with
PyTorch's pooling, resize, point sampling and norm computed in f32 and
rounded once, the average pool, point sample, PSP module, PSP upsample and
pose heads part from the JAX package's bf16 by 0.6 to 1.2 of its own
bf16-to-f32 gap, where a port that ran f32 would sit at 1
(``tests/test_torch_precision.py::test_bf16_layer_matches_jax_bf16_well_inside_its_gap``,
whose limit is a tenth). The casts are written out rather than left to
``torch.autocast``, which picks per op what runs in f32, and that is not
flax's rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _apply(mod, fn, x, bias_view):
    """``fn(x, weight, bias)`` with everything in ``mod.compute_dtype``."""
    dt = mod.compute_dtype
    w = mod.weight.to(dt)
    b = None if mod.bias is None else mod.bias.to(dt)
    if b is None or dt == torch.float32:
        return fn(x.to(dt), w, b)
    return fn(x.to(dt), w, None) + b.view(bias_view)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        return _apply(self, self._conv_forward, x, (-1, 1, 1))


class _Bf16Conv3dOnCpu(torch.autograd.Function):
    """``F.conv3d`` of a bf16 ``x`` and ``w`` on the CPU, whose weight
    gradient is computed in f32 from the same bf16 values and rounded once to
    bf16: the f32 sum that the bf16 kernel accumulates, without that kernel.
    PyTorch 2.11's CPU bf16 weight-gradient kernel (oneDNN) now and then
    leaves elements of it unwritten at the CostRegNet's 2x3x3 volume, so
    they hold NaN or whatever the memory held
    (``scripts/cpu_bf16_conv_probe.py`` counts it). The forward and the input
    gradient are the bf16 kernels'."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        return F.conv3d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv3d_input(x.shape, w, grad, *ctx.conf)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv3d_weight(x.float(), w.shape, grad.float(),
                                             *ctx.conf).to(w.dtype)
        return gx, gw, None, None, None, None


class Conv3d(nn.Conv3d):
    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        if x.device.type == "cpu" and self.compute_dtype == torch.bfloat16:
            def conv(x, w, b):      # b is None: _apply adds a bf16 bias after
                return _Bf16Conv3dOnCpu.apply(x, w, self.stride, self.padding,
                                              self.dilation, self.groups)
            return _apply(self, conv, x, (-1, 1, 1, 1))
        return _apply(self, self._conv_forward, x, (-1, 1, 1, 1))


class ConvTranspose3d(nn.ConvTranspose3d):
    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        def fn(x, w, b):
            return F.conv_transpose3d(x, w, b, self.stride, self.padding,
                                      self.output_padding, self.groups, self.dilation)
        return _apply(self, fn, x, (-1, 1, 1, 1))


class Linear(nn.Linear):
    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        return _apply(self, F.linear, x, (-1,))


class PReLU(nn.PReLU):
    """flax's ``jnp.where(x >= 0, x, alpha * x)`` with an f32 ``alpha``: the
    output is f32."""

    def forward(self, x):
        return super().forward(x.float())


def cumsum(x, dim: int):
    """Cumulative sum along ``dim`` in x's reduced dtype, rounded after every
    add (XLA's sequential reduce-window sum)."""
    parts = x.unbind(dim)
    out = [parts[0]]
    for p in parts[1:]:
        out.append(out[-1] + p)
    return torch.stack(out, dim)
