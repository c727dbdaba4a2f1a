"""The port stands alone: importing every module of rgbmanip_tpu_torch (and
chip_smoke.py's own imports) pulls in neither JAX, flax, optax nor the JAX
package; entry points default to the card."""

import importlib
import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import rgbmanip_tpu_torch
from rgbmanip_tpu_torch import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rgbmanip_tpu")
IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|rgbmanip_tpu)\b",
                       re.MULTILINE)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(rgbmanip_tpu_torch.__path__,
                                                        "rgbmanip_tpu_torch."))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    for m in ("models.pose_estimator.adapose", "sim.bindings", "envs.vec_env",
              "assets.procedural", "train", "config.generate_cfg", "parallel.mesh",
              "parallel.launch", "graft_entry", "scripts.eval_sweep",
              "scripts.diag_flagship", "scripts.trace_close", "scripts.trace_drawer",
              "scripts.trace_mug", "scripts.trace_mug_learned", "scripts.patch_ckpt_meta",
              "scripts.plot_results"):
        assert f"rgbmanip_tpu_torch.{m}" in loaded


def test_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(rgbmanip_tpu_torch.PACKAGE_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if IMPORT_RE.search(open(f).read())]
    assert not offenders, offenders


def test_entry_points_default_to_the_card():
    from rgbmanip_tpu_torch.algo.ppo import ActorCritic, PPOPolicy
    from rgbmanip_tpu_torch.config.loader import load_group
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator

    cfg = load_group("pose_estimator", "adapose_cabinet_fast", {"load": False})
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        AdaPoseEstimator(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PPOPolicy(ActorCritic(60, 12))
    from rgbmanip_tpu_torch.train import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["dataset=cabinet_test", "controller=rl",
              "controller.load=checkpoints/ppo_rl_coadapt_model_165.ckpt",
              "pose_estimator=adapose_cabinet_fast", "task.num_envs=1"])
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("script,argv", [
    ("diag_flagship", ["checkpoints/ppo_rl_coadapt_model_165.ckpt", "1", "1"]),
    ("trace_close", ["close_cabinet", "1"]),
    ("trace_drawer", ["drawer_train", "1"]),
    ("trace_mug", ["mug_train", "1"]),
    ("trace_mug_learned", ["mug_test", "1"]),
])
def test_the_diagnostic_scripts_default_to_the_card(script, argv):
    """Each raises before it builds an env unless ``device=cpu`` is passed
    (the sweep's rows: tests/test_torch_eval_sweep.py)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    mod = importlib.import_module(f"rgbmanip_tpu_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)
