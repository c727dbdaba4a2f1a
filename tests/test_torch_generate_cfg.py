"""The port's config generator (``rgbmanip_tpu_torch/config/generate_cfg.py``)
and ``load_config``'s ``cfg_root`` against the JAX package's
(``rgbmanip_tpu/config/{generate_cfg,loader}.py``).

Each spec function gives the JAX generator's dicts except where the port's
tree differs by design: the ``rl`` controller's ``learn`` block has no
``device: tpu``, and ``config.yaml`` carries ``device: cuda``. Both
generators write into temporary directories (``CFG`` patched): ``main``
rewrites the committed tree otherwise. The JAX ``load_config(cfg_root=...)``
makes ``cfg_root`` its module's ``CFG_ROOT`` for every later call, so each
test that calls it puts the old value back with ``monkeypatch``; the port's
applies it to that call only.
"""

import os

import pytest
import yaml

from rgbmanip_tpu.config import generate_cfg as jgen
from rgbmanip_tpu.config import loader as jloader
from rgbmanip_tpu_torch.config import generate_cfg as pgen
from rgbmanip_tpu_torch.config import loader as ploader

SPECS = ("tasks", "datasets", "manipulations", "pose_estimators", "controllers", "trains")
# the flagship evaluation's groups, with the paper-size estimator of the same
# task: its adapose_cabinet_fast is one of the files no generator writes
FLAGSHIP = ["dataset=cabinet_test", "task=open_cabinet", "manipulation=open_cabinet",
            "controller=rl", "pose_estimator=adapose_cabinet", "train=test"]
# committed files the generator rewrites differently (edited by hand after
# generation) and committed files it does not write at all
HAND_EDITED = {"manipulation/close_cabinet.yaml", "manipulation/close_drawer.yaml",
               "controller/rl.yaml"}
NOT_WRITTEN = {"dataset/mug_urdf_fixture.yaml", "pose_estimator/adapose_cabinet_fast.yaml",
               "pose_estimator/adapose_drawer_fast.yaml",
               "pose_estimator/adapose_mug_fast.yaml", "pose_estimator/adapose_pot_fast.yaml"}


def generate(module, out):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "CFG", str(out))
        module.main()
    return str(out)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(JAX tree, port tree), each generated into a directory of its own."""
    root = tmp_path_factory.mktemp("generated")
    return generate(jgen, root / "jax"), generate(pgen, root / "port")


def yaml_files(root):
    return {os.path.relpath(os.path.join(d, n), root): os.path.join(d, n)
            for d, _, names in os.walk(root) for n in names if n.endswith(".yaml")}


def load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("spec", SPECS)
def test_each_spec_gives_the_jax_generators_dicts(spec):
    jax_dicts, port_dicts = getattr(jgen, spec)(), getattr(pgen, spec)()
    if spec == "controllers":
        assert jax_dicts["rl"]["learn"].pop("device") == "tpu"
        assert "device" not in port_dicts["rl"]["learn"]
    assert port_dicts == jax_dicts


def test_main_writes_52_group_files_and_the_root_config(trees):
    jax_tree, port_tree = trees
    files = yaml_files(port_tree)
    assert len(files) == 53 and "config.yaml" in files
    assert sorted(files) == sorted(yaml_files(jax_tree))
    root = load(files["config.yaml"])
    assert root.pop("device") == "cuda"
    assert root == load(os.path.join(jax_tree, "config.yaml"))


def without_device(cfg):
    cfg.pop("device", None)
    cfg["controller"]["learn"].pop("device", None)
    return cfg


def test_both_packages_compose_the_same_flagship_config_from_their_trees(
        trees, monkeypatch):
    jax_tree, port_tree = trees
    monkeypatch.setattr(jloader, "CFG_ROOT", jloader.CFG_ROOT)
    jcfg = jloader.load_config(FLAGSHIP, cfg_root=jax_tree)
    pcfg = ploader.load_config(FLAGSHIP, cfg_root=port_tree)
    assert pcfg["device"] == "cuda" and jcfg["controller"]["learn"]["device"] == "tpu"
    assert without_device(pcfg) == without_device(jcfg)


def test_the_generated_tree_differs_from_the_committed_one_where_listed(trees):
    generated, committed = yaml_files(trees[1]), yaml_files(ploader.CFG_ROOT)
    assert set(committed) - set(generated) == NOT_WRITTEN
    assert not set(generated) - set(committed)
    differ = {k for k in generated if load(generated[k]) != load(committed[k])}
    assert differ == HAND_EDITED
    # the composed flagship run differs in the hand-edited controller only
    gen = ploader.load_config(FLAGSHIP, cfg_root=trees[1])
    com = ploader.load_config(FLAGSHIP)
    assert {k for k in com if gen[k] != com[k]} == {"controller"}


def test_cfg_root_holds_for_one_call_in_the_port_and_sticks_in_jax(trees, monkeypatch):
    jax_tree, port_tree = trees
    ploader.load_config(cfg_root=port_tree)
    assert ploader.CFG_ROOT.endswith(os.path.join("rgbmanip_tpu_torch", "config", "cfg"))
    # the committed rl.yaml (hand-edited) is read again without cfg_root
    assert ploader.load_config(["controller=rl"])["controller"] == load(
        os.path.join(ploader.CFG_ROOT, "controller", "rl.yaml"))
    committed = jloader.CFG_ROOT
    with monkeypatch.context() as mp:
        mp.setattr(jloader, "CFG_ROOT", committed)
        jloader.load_config(cfg_root=jax_tree)
        assert jloader.CFG_ROOT == jax_tree      # the reference's sticky root
        assert jloader.load_config(["controller=rl"])["controller"] == load(
            os.path.join(jax_tree, "controller", "rl.yaml"))
    assert jloader.CFG_ROOT == committed
    assert jloader.load_config(["controller=rl"])["controller"] == load(
        os.path.join(committed, "controller", "rl.yaml"))
