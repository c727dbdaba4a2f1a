"""The bf16 pyramid pooling of the port's PSPNet
(``nets/pspnet.py::pyramid_pool``: one integral image for all four bins, the
windows read by one gather from cached device tables) against the per-bin
integral-image pooling it replaced, copied below as the plain reference:
outputs and input gradients equal bit for bit, alone and through
``PSPModule``. Imports neither JAX nor the JAX package, so
``tests/test_torch_cuda.py`` runs the reference on the card too."""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from rgbmanip_tpu_torch.models.pose_estimator.nets import pspnet
from rgbmanip_tpu_torch.models.pose_estimator.nets.layers import cumsum
from rgbmanip_tpu_torch.utils import logger as L

torch.set_num_threads(2)


def reference_pool(x, out_size):
    """``AdaptiveAvgPool2d(out_size)`` of x in its reduced dtype: the
    bin's own integral image and its windows indexed with Python lists."""
    B, C, H, W = x.shape
    cs = F.pad(cumsum(cumsum(x, 2), 3), (1, 0, 1, 0))
    (ylo, yhi), (xlo, xhi) = pspnet._edges(H, out_size), pspnet._edges(W, out_size)

    def at(rows, cols):
        return cs[:, :, rows][:, :, :, cols]
    s = at(yhi, xhi) - at(ylo, xhi) - at(yhi, xlo) + at(ylo, xlo)
    area = torch.tensor([[(b - a) * (d - c) for c, d in zip(xlo, xhi)]
                         for a, b in zip(ylo, yhi)], dtype=torch.float32)
    return s / area.to(device=x.device, dtype=x.dtype)


def reference_psp(module, x):
    """``PSPModule.forward`` of a reduced dtype with ``reference_pool``."""
    size = x.shape[-2:]

    def stage(pool, conv):
        return pspnet.resize_bilinear(F.relu(conv(reference_pool(x, pool.output_size))), size)
    return torch.cat([x] + [stage(*s) for s in module.stages], dim=1)


def equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# (H, W, B, tables made in inference mode): the fast configuration's 6x6
# map, the paper's 28x28, and 7x9, whose windows overlap
CASES = [(6, 6, 1, False), (6, 6, 3, False), (28, 28, 1, False), (28, 28, 3, False),
         (7, 9, 1, False), (7, 9, 3, False), (7, 9, 3, True)]


@pytest.mark.parametrize("H,W,B,inference_tables", CASES)
def test_pyramid_pool_equals_the_per_bin_pooling_bitwise(H, W, B, inference_tables):
    C = 16
    g = torch.Generator().manual_seed(H * 100 + W * 10 + B)
    module = pspnet.PSPModule(C, torch.bfloat16)
    x = torch.randn(B, C, H, W, generator=g).to(torch.bfloat16)
    bins_grad = [torch.randn(B, C, s, s, generator=g).to(torch.bfloat16) for s in pspnet.BINS]
    out_grad = torch.randn(B, 2 * C, H, W, generator=g).to(torch.bfloat16)
    if inference_tables:
        pspnet.pool_tables.cache_clear()
        with torch.inference_mode():
            assert equal(module(x), reference_psp(module, x))
        assert pspnet.pool_tables.cache_info().currsize == 1

    def run(pool, psp):
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        pooled = pool(xa)
        sum((p * w).sum() for p, w in zip(pooled, bins_grad)).backward()
        y = psp(xb)
        y.backward(out_grad)
        grads = [p.grad.clone() for p in module.parameters()]
        module.zero_grad()
        return pooled, xa.grad, y, xb.grad, grads
    got = run(pspnet.pyramid_pool, module)
    want = run(lambda t: [reference_pool(t, s) for s in pspnet.BINS],
               lambda t: reference_psp(module, t))
    pooled, pool_grad, y, psp_grad, weight_grads = got
    assert all(equal(a, b) for a, b in zip(pooled, want[0]))
    assert [p.shape[-1] for p in pooled] == list(pspnet.BINS)
    assert equal(pool_grad, want[1])
    assert equal(y, want[2])
    assert equal(psp_grad, want[3])
    assert all(equal(a, b) for a, b in zip(weight_grads, want[4]))


def test_bf16_psp_module_counts_one_gather_per_forward_and_f32_none():
    x = torch.randn(2, 8, 6, 6)
    L.SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for dtype in (torch.bfloat16, torch.float32):
                with L.span(str(dtype)):
                    pspnet.PSPModule(8, dtype)(x.to(dtype))
        s = L.SPANS.summary()
    finally:
        L.SPANS.reset()
    assert s["torch.bfloat16"]["psp_pool_gathers"] == 1
    assert "psp_pool_gathers" not in s["torch.float32"]
