"""The checkpoint metadata patcher (``rgbmanip_tpu_torch/scripts/patch_ckpt_meta.py``,
msgpack through ``utils/checkpoint.py``) against the JAX package's
``scripts/patch_ckpt_meta.py`` (flax): the same patched tree from the same
synthetic checkpoint, the same refusal of a shape-affecting knob, and a
patched estimator checkpoint that the port's ``AdaPoseEstimator.load``
accepts only at the patched ``d_min``."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
from rgbmanip_tpu_torch.scripts import patch_ckpt_meta as port_patch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUG = os.path.join(REPO, "checkpoints", "estimator_fast_mug_fine_r5.ckpt")
PATCH = ["d_min=0.3", "d_interval=0.07"]


def run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["patch_ckpt_meta.py"] + argv)
    spec = importlib.util.spec_from_file_location(
        "jax_patch_ckpt_meta", os.path.join(REPO, "scripts", "patch_ckpt_meta.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def restored(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture
def synthetic(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                                "bias": np.zeros(8, np.float32)},
                       "dense": {"kernel": rng.normal(size=(8, 2)).astype(np.float32)}},
            "batch_stats": {"bn": {"mean": rng.normal(size=8).astype(np.float32),
                                   "var": np.ones(8, np.float32)}},
            "step": np.int32(7),
            "meta": json.dumps({"backend": "resnet18", "n_depth": 16, "d_min": 0.1,
                                "d_interval": 0.15, "img_size": 192})}
    path = tmp_path / "src.ckpt"
    path.write_bytes(serialization.msgpack_serialize(tree))
    return path


def test_the_patched_tree_equals_the_jax_patchers(synthetic, tmp_path, monkeypatch, capsys):
    run_jax(monkeypatch, [str(synthetic), str(tmp_path / "jax.ckpt")] + PATCH)
    ref_out = capsys.readouterr().out
    port_patch.main([str(synthetic), str(tmp_path / "port.ckpt")] + PATCH)
    out = capsys.readouterr().out
    assert out.replace("port.ckpt", "X") == ref_out.replace("jax.ckpt", "X")
    assert "d_min: 0.1 -> 0.3" in out
    ref, got = restored(tmp_path / "jax.ckpt"), restored(tmp_path / "port.ckpt")
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == ref_def
    for a, b in zip(got_leaves, ref_leaves):
        assert type(a) is type(b)
        if isinstance(a, np.ndarray) or np.isscalar(a):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    meta = json.loads(got["meta"])
    assert (meta["d_min"], meta["d_interval"], meta["backend"]) == (0.3, 0.07, "resnet18")
    assert sorted(os.listdir(tmp_path)) == ["jax.ckpt", "port.ckpt", "src.ckpt"]  # no .tmp left


def test_both_refuse_a_shape_knob(synthetic, tmp_path, monkeypatch):
    for patcher in (lambda a: run_jax(monkeypatch, a), port_patch.main):
        with pytest.raises(SystemExit, match="refusing to patch shape-affecting knobs"):
            patcher([str(synthetic), str(tmp_path / "out.ckpt"), "d_min=0.3",
                     "backbone_stride=8"])
    assert not (tmp_path / "out.ckpt").exists()


def test_the_port_estimator_loads_the_patched_depth_anchor(tmp_path):
    dst = str(tmp_path / "mug_coarse.ckpt")
    port_patch.main([MUG, dst, "d_min=0.3"])
    cfg = load_group("pose_estimator", "adapose_mug_fast", {"checkpoint_path": dst})
    with pytest.raises(ValueError, match="d_min"):
        AdaPoseEstimator(cfg, device="cpu")           # the file's own 0.35 no longer matches
    est = AdaPoseEstimator(dict(cfg, d_min=0.3), device="cpu")
    assert est.d_min == 0.3 and est.d_interval == 0.08
    ref = AdaPoseEstimator(load_group("pose_estimator", "adapose_mug_fast"), device="cpu")
    for a, b in zip(est.model.state_dict().values(), ref.model.state_dict().values()):
        assert torch.equal(a, b)
