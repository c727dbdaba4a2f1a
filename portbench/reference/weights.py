"""Weights for the reference: read from a flax msgpack checkpoint with this
module's own reader, or drawn from a seed on the device.

A flax checkpoint is a msgpack map whose array leaves are ext type 1
holding (shape, dtype name, raw buffer) and whose numpy scalars are ext type
3. ``net_state`` maps the estimator's flax tree onto the reference network's
torch names, with the layouts turned: a 2-D convolution kernel (kh, kw, I,
O) to (O, I, kh, kw), a 3-D one (kd, kh, kw, I, O) to (O, I, kd, kh, kw), a
transposed 3-D one to (I, O, kd, kh, kw), a dense kernel (I, O) to (O, I),
and a BatchNorm's scale, bias and batch statistics to its weight, bias and
running mean and variance.
"""

from __future__ import annotations

import re

import msgpack
import numpy as np
import torch


def _ext(code, data):
    if code in (1, 3):
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr.copy() if code == 1 else arr[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def read_checkpoint(path):
    """The checkpoint's tree of nested dicts with numpy leaves."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_ext, raw=False, strict_map_key=False)


_HEADS = {"rotation_estimator": "rotation", "translation_estimator": "translation",
          "size_estimator": "size"}


def _flax_path(key):
    """torch name -> (collection, flax path, layout)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "img_extractor":
        p = parts[1:-1]
        if p[0] == "feats":
            if p[1] == "conv1":
                return "params", ("img_extractor", "feats", "conv1", "kernel"), "conv2d"
            layer, block, conv = p[1], p[2], p[3]
            name = "downsample" if conv == "downsample" else conv
            return ("params", ("img_extractor", "feats", f"{layer}_{block}", name, "kernel"),
                    "conv2d")
        if p[0] == "psp":
            return "params", ("img_extractor", "psp", f"stage{p[2]}", "kernel"), "conv2d"
        if p[0].startswith("up_"):
            if p[2] == "1":
                return "params", ("img_extractor", p[0], "prelu"), "copy"
            return ("params", ("img_extractor", p[0], "conv",
                               "kernel" if leaf == "weight" else "bias"),
                    "conv2d" if leaf == "weight" else "copy")
        if p[0] == "final":
            return ("params", ("img_extractor", "final", "kernel" if leaf == "weight" else "bias"),
                    "conv2d" if leaf == "weight" else "copy")
    if parts[0] == "cost_regularization":
        cr = ("cost_regularization",)
        if parts[1] == "prob":
            return "params", cr + ("prob", "kernel"), "conv3d"
        name, sub = parts[1], parts[2]
        if sub == "conv":
            kind = "deconv3d" if name in ("conv7", "conv9", "conv11") else "conv3d"
            return "params", cr + (name, "conv", "kernel"), kind
        bn = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
        coll, leafname = bn[leaf]
        return coll, cr + (name, "bn", leafname), "copy"
    mod, idx = parts[0], int(parts[1])
    i = idx // 2
    kind = "dense" if leaf == "weight" else "copy"
    fleaf = "kernel" if leaf == "weight" else "bias"
    if mod in _HEADS:
        return "params", ("heads", f"{_HEADS[mod]}_{i}", fleaf), kind
    base = ("heads", mod) if mod in ("pose_mlp1", "pose_mlp2") else (mod,)
    return "params", base + (f"dense_{i}", fleaf), kind


_LAYOUT = {
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "conv3d": lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
    "deconv3d": lambda w: np.transpose(w, (3, 4, 0, 1, 2)),
    "dense": lambda w: np.transpose(w),
    "copy": lambda w: np.asarray(w),
}


def net_state(tree, net):
    """The estimator checkpoint's tree as a state dict of ``net`` (the
    reference network); raises on a missing leaf or a shape mismatch."""
    trees = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
    out = {}
    for key, ref in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path, kind = _flax_path(key)
        node = trees[coll]
        for name in path:
            node = node[name]
        w = _LAYOUT[kind](np.asarray(node, dtype=np.float32))
        if tuple(w.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint {'/'.join(path)} has shape {w.shape}, "
                             f"expected {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(w))
    return out


def seeded_state(net, seed, device):
    """A state dict for ``net`` drawn from ``seed`` on ``device`` in one call
    of a device generator: every convolution and dense weight normal with
    variance 1 / fan-in (fan-in: input channels times kernel taps), biases
    zero, PReLU slopes 0.25, BatchNorm the identity (scale 1, bias 0,
    running mean 0, running variance 1; a BatchNorm is a module with a
    running mean)."""
    state = net.state_dict()
    batch_norms = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    weights = [(k, v) for k, v in state.items()
               if k.endswith(".weight") and v.dim() >= 2]
    total = sum(v.numel() for _, v in weights)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, v in weights:
        n = v.numel()
        transposed = re.search(r"conv(7|9|11)\.conv\.weight$", k) is not None
        taps = v[0, 0].numel() if v.dim() > 2 else 1
        fan_in = (v.shape[0] if transposed else v.shape[1]) * taps
        out[k] = flat[at:at + n].view(v.shape) * fan_in ** -0.5
        at += n
    for k, v in state.items():
        if k in out or k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var") or (k.endswith(".weight")
                                         and k.rsplit(".", 1)[0] in batch_norms):
            out[k] = torch.ones(v.shape, device=device)
        elif k.endswith(".weight"):            # PReLU slope
            out[k] = torch.full(v.shape, 0.25, device=device)
        else:
            out[k] = torch.zeros(v.shape, device=device)
    return out
