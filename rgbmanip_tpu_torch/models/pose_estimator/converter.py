"""Carry estimator weights into the port's ``StereoPoseNetWithDepth`` and
``StereoPoseNetV1``: the JAX package's (a flax tree of numpy arrays, ``load_jax_params``) and the
reference's released torch state dicts (a ``.pth`` file,
``load_torch_state_dict``).

The port's modules are named after the reference torch state_dict keys, so
the key map below is the JAX package's ``converter.torch_key_map`` (torch key
-> flax path), with the block counts and downsample convs of the model's
backend (resnet34, resnet18 or resnet10s) and the parameters the
architecture adds or drops (``volume_reduce``, ``camera_pts_mlp``, no
``heads`` without pose regression; V1's ``volume_conv`` and ``fuse_conv`` in
place of the U-Net), and a ``.pth`` of the reference loads into the same
names. The backbone stride changes no parameter:
a stride-8 downsample conv is a 1x1 conv of stride 1, and the slim
resnet10s ``up_1`` a 1x1 conv. Layouts, flax -> torch:

  Conv         (kh, kw, I, O)      -> Conv2d (O, I, kh, kw)
  Conv 3-D     (kd, kh, kw, I, O)  -> Conv3d (O, I, kd, kh, kw)
  deconv 3-D   (kd, kh, kw, I, O)  -> ConvTranspose3d (I, O, kd, kh, kw), no
               flip: the JAX module flips at apply time only to emulate
               torch's ConvTranspose3d alignment
  Dense        (I, O)              -> Linear (O, I)
  BatchNorm    scale/bias + batch_stats mean/var -> weight/bias/running_*
               (eps 1e-5 on both sides)

``to_jax_params`` is the inverse: it turns the port's modules back into the
flax ``params`` / ``batch_stats`` trees (the transposes undone), so that a
head trained in the port loads into the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...utils.checkpoint import flatten
from .nets.pspnet import ARCH, has_downsample

Path = Tuple[str, ...]

FLAX_TO_TORCH = {
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "conv3d": lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
    "deconv3d": lambda w: np.transpose(w, (3, 4, 0, 1, 2)),
    "dense": lambda w: np.transpose(w),
    "copy": lambda w: np.asarray(w),
}
TORCH_TO_FLAX = {
    "conv2d": lambda w: np.transpose(w, (2, 3, 1, 0)),
    "conv3d": lambda w: np.transpose(w, (2, 3, 4, 1, 0)),
    "deconv3d": lambda w: np.transpose(w, (2, 3, 4, 0, 1)),
    "dense": lambda w: np.transpose(w),
    "copy": lambda w: np.asarray(w),
}


def torch_key_map(backend: str = "resnet18", *, arch: str = "with_depth",
                  regress_pose: bool = True, volume_channels: int = 0,
                  realworld_pts: bool = False) -> Dict[str, Tuple[str, Path, str]]:
    """torch key -> (flax collection, flax path, layout kind) for the port's
    ``StereoPoseNetWithDepth`` (``arch="with_depth"``, its knobs that add or
    drop parameters as given) or ``StereoPoseNetV1`` (``arch="v1"``) with
    ``backend``. ``model_key_map`` reads them off a model."""
    if backend not in ARCH:
        raise ValueError(f"backend must be one of {sorted(ARCH)}, got {backend!r}")
    blocks_per_stage, planes, _ = ARCH[backend]
    m: Dict[str, Tuple[str, Path, str]] = {}

    def p(tk, path, kind):
        m[tk] = ("params", path, kind)

    def conv2d(tk, *fp):
        p(tk + ".weight", fp + ("kernel",), "conv2d")

    pe = ("img_extractor",)
    conv2d("img_extractor.feats.conv1", *pe, "feats", "conv1")
    for li, blocks in enumerate(blocks_per_stage, start=1):
        for b in range(blocks):
            base = f"img_extractor.feats.layer{li}.{b}"
            fbase = pe + ("feats", f"layer{li}_{b}")
            conv2d(base + ".conv1", *fbase, "conv1")
            conv2d(base + ".conv2", *fbase, "conv2")
            if b == 0 and has_downsample(li - 1, planes):
                conv2d(base + ".downsample.0", *fbase, "downsample")
    for s in range(4):
        conv2d(f"img_extractor.psp.stages.{s}.1", *pe, "psp", f"stage{s}")
    for u in (1, 2, 3):
        conv2d(f"img_extractor.up_{u}.conv.0", *pe, f"up_{u}", "conv")
        p(f"img_extractor.up_{u}.conv.0.bias", pe + (f"up_{u}", "conv", "bias"), "copy")
        p(f"img_extractor.up_{u}.conv.1.weight", pe + (f"up_{u}", "prelu"), "copy")
    conv2d("img_extractor.final", *pe, "final")
    p("img_extractor.final.bias", pe + ("final", "bias"), "copy")

    def mlp(tk, fpath, seq_idx):
        for i, t in enumerate(seq_idx):
            p(f"{tk}.{t}.weight", fpath + (f"dense_{i}", "kernel"), "dense")
            p(f"{tk}.{t}.bias", fpath + (f"dense_{i}", "bias"), "copy")

    def bn(tk, fpath):
        p(tk + ".weight", fpath + ("scale",), "copy")
        p(tk + ".bias", fpath + ("bias",), "copy")
        m[tk + ".running_mean"] = ("batch_stats", fpath + ("mean",), "copy")
        m[tk + ".running_var"] = ("batch_stats", fpath + ("var",), "copy")

    mlp("instance_color", ("instance_color",), (0,))
    mlp("nocs_head", ("nocs_head",), (0, 2, 4))

    if arch == "v1":
        for i in range(3):
            p(f"volume_conv.conv_{i}.weight", ("volume_conv", f"conv_{i}", "kernel"), "conv3d")
            bn(f"volume_conv.bn_{i}", ("volume_conv", f"bn_{i}"))
        mlp("fuse_conv", ("fuse_conv",), (0, 2))
    elif arch == "with_depth":
        if volume_channels:
            conv2d("volume_reduce", "volume_reduce")
        cr = ("cost_regularization",)
        for name in ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6",
                     "conv7", "conv9", "conv11"):
            kind = "deconv3d" if name in ("conv7", "conv9", "conv11") else "conv3d"
            tk = f"cost_regularization.{name}"
            p(tk + ".conv.weight", cr + (name, "conv", "kernel"), kind)
            bn(tk + ".bn", cr + (name, "bn"))
        p("cost_regularization.prob.weight", cr + ("prob", "kernel"), "conv3d")
        if not regress_pose:
            return m
        if realworld_pts:
            mlp("camera_pts_mlp", ("camera_pts_mlp",), (0, 2))
    else:
        raise ValueError(f"unknown estimator arch {arch!r}")

    mlp("nocs_pts_mlp", ("nocs_pts_mlp",), (0, 2))
    hd = ("heads",)
    mlp("pose_mlp1", hd + ("pose_mlp1",), (0, 2))
    mlp("pose_mlp2", hd + ("pose_mlp2",), (0, 2))
    for head, fh in (("rotation_estimator", "rotation"),
                     ("translation_estimator", "translation"),
                     ("size_estimator", "size")):
        for i, t in enumerate((0, 2, 4)):
            p(f"{head}.{t}.weight", hd + (f"{fh}_{i}", "kernel"), "dense")
            p(f"{head}.{t}.bias", hd + (f"{fh}_{i}", "bias"), "copy")
    return m


def model_key_map(model: torch.nn.Module) -> Dict[str, Tuple[str, Path, str]]:
    """``torch_key_map`` of ``model``, a ``StereoPoseNetWithDepth`` or a
    ``StereoPoseNetV1``."""
    if model.arch == "v1":
        return torch_key_map(model.backend, arch="v1")
    return torch_key_map(model.backend, regress_pose=model.regress_pose,
                         volume_channels=model.volume_channels,
                         realworld_pts=model.realworld_pts)


def load_jax_params(model: torch.nn.Module, params: dict, batch_stats: dict) -> None:
    """Copy a flax (params, batch_stats) tree into ``model``, a
    ``StereoPoseNetWithDepth`` or ``StereoPoseNetV1`` whose architecture
    picks the key map (``model_key_map``), in place. Raises
    on a torch entry with no flax leaf, a flax leaf left over, or a shape
    that does not match."""
    trees = {"params": flatten(params), "batch_stats": flatten(batch_stats)}
    kmap = model_key_map(model)
    state = model.state_dict()
    targets = [k for k in state if not k.endswith("num_batches_tracked")]
    missing = [k for k in targets if k not in kmap or kmap[k][1] not in trees[kmap[k][0]]]
    if missing:
        raise ValueError(f"no flax leaf for {len(missing)} torch entries, e.g. {missing[:5]}")
    used = {(kmap[k][0], kmap[k][1]) for k in targets}
    leftover = ["/".join((c,) + fp) for c, tree in trees.items() for fp in tree
                if (c, fp) not in used]
    if leftover:
        raise ValueError(f"{len(leftover)} flax leaves map to no torch entry, "
                         f"e.g. {leftover[:5]}")
    new_state = {}
    for k in targets:
        coll, fp, kind = kmap[k]
        w = FLAX_TO_TORCH[kind](np.array(trees[coll][fp], dtype=np.float32))
        if tuple(w.shape) != tuple(state[k].shape):
            raise ValueError(f"{k}: flax {'/'.join(fp)} gives shape {w.shape}, "
                             f"the port expects {tuple(state[k].shape)}")
        new_state[k] = torch.from_numpy(np.ascontiguousarray(w))
    with torch.no_grad():
        for k, w in new_state.items():
            state[k].copy_(w)


def to_jax_params(model: torch.nn.Module) -> Tuple[dict, dict]:
    """The flax (params, batch_stats) trees of ``model`` (a
    ``StereoPoseNetWithDepth`` or ``StereoPoseNetV1``), as nested dicts of f32 numpy arrays: the
    inverse of ``load_jax_params``, leaf for leaf."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    state = model.state_dict()
    for k, (coll, fp, kind) in model_key_map(model).items():
        w = state[k].detach().cpu().numpy().astype(np.float32)
        node = trees[coll]
        for name in fp[:-1]:
            node = node.setdefault(name, {})
        node[fp[-1]] = np.ascontiguousarray(TORCH_TO_FLAX[kind](w))
    return trees["params"], trees["batch_stats"]


def load_torch_state_dict(model: torch.nn.Module, path: str) -> Tuple[List[str], List[str]]:
    """Load a reference ``.pth`` state dict into ``model`` in place, with the
    semantics of the JAX package's ``convert_torch_checkpoint``: a
    ``module.`` prefix (the reference saved through ``nn.DataParallel``) is
    stripped, ``num_batches_tracked`` skipped, keys outside the model's key
    map are reported and left out, and a parameter the file
    does not hold keeps its initial value. A Conv1d weight (O, I, 1) loads
    into the port's Linear (O, I). Raises on a tensor whose shape does not
    match. Returns the (missing, unknown) keys."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    kmap = model_key_map(model)
    state = model.state_dict()
    new_state, unknown = {}, []
    for key, w in obj.items():
        key = key[len("module."):] if key.startswith("module.") else key
        if key.endswith("num_batches_tracked"):
            continue
        if key not in kmap:
            unknown.append(key)
            continue
        want = tuple(state[key].shape)
        if w.dim() == len(want) + 1 and w.shape[-1] == 1:
            w = w[..., 0]
        if tuple(w.shape) != want:
            raise ValueError(f"{key}: the file holds shape {tuple(w.shape)}, the port "
                             f"expects {want}")
        new_state[key] = w.float()
    missing = [k for k in kmap if k not in new_state]
    model.load_state_dict(new_state, strict=False)
    return missing, unknown
