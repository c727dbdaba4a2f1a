"""Cross-attention view fusion (counterpart of
``rgbmanip_tpu/models/pose_estimator/nets/fusion.py``, reference
AdaPose/lib/fusion.py:27-82): blocks of cross-attention between the per-point
features of the two views. The reference keeps it as an alternative to the
cost-volume fusion that no network of its runs; so does this package.

Plain tensor ops with flax's definitions: LayerNorm with epsilon 1e-6 and
the variance as ``E[x^2] - E[x]^2``; multi-head attention with the query
scaled by ``1 / sqrt(head_dim)`` before the product; ``nn.gelu``'s tanh
approximation. ``load_flax_params`` carries a flax tree across, whose
attention kernels are laid out (C, heads, head_dim) and (heads, head_dim, C).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in f32, the result in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.compute_dtype)


class Attention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, qkv_features=dim)``
    of queries x (B, N, C) over a context (B, M, C)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Linear(dim, dim, dtype=dtype))
        self.compute_dtype = dtype

    def forward(self, x, context):
        B, N, C = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, -1)
        q, k, v = heads(self.query(x)), heads(self.key(context)), heads(self.value(context))
        q = q / torch.tensor(q.shape[-1] ** 0.5, dtype=q.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w.to(self.compute_dtype), v)
        return self.out(o.reshape(B, N, C))


class CrossAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype)
        self.LayerNorm_2 = LayerNorm(dim, dtype=dtype)
        self.Dense_0 = Linear(dim, 2 * dim, dtype=dtype)
        self.Dense_1 = Linear(2 * dim, dim, dtype=dtype)

    def forward(self, x, context):
        x = x + self.attn(self.LayerNorm_0(x), self.LayerNorm_1(context))
        h = F.gelu(self.Dense_0(self.LayerNorm_2(x)), approximate="tanh")
        return x + self.Dense_1(h)


class ViewFusion(nn.Module):
    """Bidirectional cross-attention fusion of the two views' point features
    (B, N, in1) and (B, N, in2) -> two (B, N, dim)."""

    def __init__(self, in1: int, in2: int, dim: int = 64, depth: int = 2,
                 num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.proj = Linear(in1, dim, dtype=dtype)
        self.proj2 = Linear(in2, dim, dtype=dtype)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block12_{i}", CrossAttentionBlock(dim, num_heads, dtype))
            setattr(self, f"block21_{i}", CrossAttentionBlock(dim, num_heads, dtype))

    def forward(self, feat1, feat2):
        f1, f2 = self.proj(feat1), self.proj2(feat2)
        for i in range(self.depth):
            f1, f2 = (getattr(self, f"block12_{i}")(f1, f2),
                      getattr(self, f"block21_{i}")(f2, f1))
        return f1, f2


def load_flax_params(module: nn.Module, params: dict) -> None:
    """Copy the flax tree of the JAX package's module into ``module`` (a
    ``ViewFusion`` or one of its parts) in place."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

    with torch.no_grad():
        for name, child in module.named_children():
            p = params[name]
            if isinstance(child, Attention):
                for k in ("query", "key", "value"):
                    kern = np.asarray(p[k]["kernel"])              # (C, heads, head_dim)
                    getattr(child, k).weight.copy_(t(kern.reshape(kern.shape[0], -1).T))
                    getattr(child, k).bias.copy_(t(np.asarray(p[k]["bias"]).reshape(-1)))
                kern = np.asarray(p["out"]["kernel"])              # (heads, head_dim, C)
                child.out.weight.copy_(t(kern.reshape(-1, kern.shape[-1]).T))
                child.out.bias.copy_(t(p["out"]["bias"]))
            elif isinstance(child, nn.Linear):
                child.weight.copy_(t(np.asarray(p["kernel"]).T))
                child.bias.copy_(t(p["bias"]))
            elif isinstance(child, LayerNorm):
                child.scale.copy_(t(p["scale"]))
                child.bias.copy_(t(p["bias"]))
            else:
                load_flax_params(child, p)
