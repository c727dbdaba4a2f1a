"""The gt-stack failure traces (``rgbmanip_tpu_torch/scripts/trace_close.py``,
``trace_drawer.py``, ``trace_mug.py``) against the JAX package's
``scripts/trace_*.py``, both on the CPU at one round of 8 envs: the printed
tables are equal, and every hook the scripts wrap on the env fired, so the
port's skills move through the same public env methods as the JAX skills
(a skill that called a private mover would leave its trace silently
empty).

``trace_mug_learned`` (heuristic + AdaPose on the mug, one round of 8) is
held to the JAX script's rows: the estimate's signed error components within
1e-3 m, with the port's estimator fed the JAX estimator's point-sampling
draws and the JAX crop run through its Pallas kernel in interpret mode (as
in ``tests/test_torch_rl_loop.py``). Grasp and success come after the
closed-loop skill, which turns micrometres into centimetres, and are not
compared."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.scripts import trace_close, trace_drawer, trace_mug, trace_mug_learned
from test_torch_paper_estimator import init_shapes_only
from test_torch_rl_loop import jax_pallas_crop, keep_keys, replay_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    # script: (port module, argv, hook tags that must fire)
    "trace_close": (trace_close, ["close_cabinet", "1"], {"push", "hand", "grip"}),
    "trace_drawer": (trace_drawer, ["drawer_train", "1"], {"move", "hand", "grip"}),
    "trace_mug": (trace_mug, ["mug_train", "1"], {"hand", "close"}),
}


@pytest.fixture(autouse=True)
def jax_log_level():
    """The JAX scripts leave the JAX package's logger at WARNING: restore it
    for the tests that run after these in the same process."""
    from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
    log = jax_get_logger()
    level = log.level
    yield
    log.setLevel(level)


@pytest.mark.parametrize("script", sorted(CASES))
def test_trace_prints_the_jax_table_and_every_hook_fires(script, monkeypatch, capsys):
    mod, argv, tags = CASES[script]
    monkeypatch.setattr(sys, "path", list(sys.path))   # the JAX script prepends "."
    monkeypatch.setattr(sys, "argv", [f"{script}.py"] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", f"{script}.py"), run_name="__main__")
    ref = capsys.readouterr().out
    out = mod.main(argv + ["device=cpu"])
    port = capsys.readouterr().out
    print(port)
    fired = out["fired"] if "fired" in out else out
    assert set(fired) == tags and min(fired.values()) >= 1, fired
    assert port.strip() and port == ref


def test_trace_mug_learned_records_the_jax_error_components(monkeypatch, capsys):
    from rgbmanip_tpu import train as jax_train
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth

    keys = []
    jax_prepare, port_prepare = (jax_train.prepare_pose_estimator,
                                 port_train.prepare_pose_estimator)

    def keyed(*args, **kwargs):
        est = jax_prepare(*args, **kwargs)
        keep_keys(est, keys)
        return est

    def replayed(*args, **kwargs):
        est = port_prepare(*args, **kwargs)
        replay_draws(est, keys)
        return est

    monkeypatch.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
    monkeypatch.setattr(jax_train, "prepare_pose_estimator", keyed)
    monkeypatch.setattr(port_train, "prepare_pose_estimator", replayed)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["trace_mug_learned.py", "mug_test", "1"])
    with jax_pallas_crop():
        ref = runpy.run_path(os.path.join(REPO, "scripts", "trace_mug_learned.py"),
                             run_name="__main__")["rows"]
    ref_out = capsys.readouterr().out
    rows = trace_mug_learned.main(["mug_test", "1", "device=cpu"])
    out = capsys.readouterr().out
    print(out)
    assert len(keys) == 1 and len(rows) == len(ref) == 8
    got, want = np.array(rows, np.float64), np.array(ref, np.float64)
    print("max |component diff| (m):", np.abs(got[:, :4] - want[:, :4]).max())
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)
    assert out.splitlines()[0] == ref_out.splitlines()[0] == "round 1/1"
