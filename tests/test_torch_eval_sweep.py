"""The evaluation sweep (``rgbmanip_tpu_torch/scripts/eval_sweep.py``)
against the JAX package's ``scripts/eval_sweep.py``, both on the CPU: the
same rows, the same per-row results on the gt stack (which runs no network,
so the two packages agree exactly), the port's own output file beside the
JAX package's committed one, and an error row recorded in the JAX form with
a non-zero exit."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from rgbmanip_tpu_torch.scripts import eval_sweep as port_sweep

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "docs", "sweep_gt_pose_ground_truth.json")
# four gt rows of the sweep, one per skill family
SUBSET = [("open_cabinet", "open_cabinet", [("test", "cabinet_test")]),
          ("open_drawer", "open_drawer", [("train", "drawer_train")]),
          ("pick_mug", "pick_mug", [("test", "mug_test")]),
          ("close_drawer", "close_drawer", [("test", "drawer_test")])]
SMALL = ["1", "gt_pose", "ground_truth", "task.num_envs=2"]


@pytest.fixture(autouse=True)
def jax_log_level():
    """The JAX scripts leave the JAX package's logger at WARNING: restore it
    for the tests that run after these in the same process."""
    from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
    log = jax_get_logger()
    level = log.level
    yield
    log.setLevel(level)


def jax_sweep_module(monkeypatch):
    """``scripts/eval_sweep.py`` loaded by path; the ``sys.path`` entry it
    adds is undone when the test ends."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        "jax_eval_sweep", os.path.join(REPO, "scripts", "eval_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, rows, argv):
    mod = jax_sweep_module(monkeypatch)
    monkeypatch.setattr(mod, "ROWS", rows)
    monkeypatch.setattr(sys, "argv", ["eval_sweep.py"] + argv)
    mod.main()
    with open("docs/sweep_gt_pose_ground_truth.json") as f:
        return json.load(f)


def run_port(monkeypatch, rows, argv):
    monkeypatch.setattr(port_sweep, "ROWS", rows)
    port_sweep.main(argv + ["device=cpu"])


def read_port():
    with open("docs/sweep_torch_gt_pose_ground_truth.json") as f:
        return json.load(f)


def test_rows_equal_the_jax_scripts(monkeypatch):
    assert port_sweep.ROWS == jax_sweep_module(monkeypatch).ROWS


def test_gt_rows_equal_the_jax_sweep(monkeypatch, tmp_path):
    with open(COMMITTED, "rb") as f:
        committed = f.read()
    monkeypatch.chdir(tmp_path)
    (tmp_path / "docs").mkdir()        # the JAX script writes into docs/ and makes no directory
    ref = run_jax(monkeypatch, SUBSET, SMALL)
    run_port(monkeypatch, SUBSET, SMALL)
    out = read_port()
    print("port", out["results"], "jax", ref["results"])
    assert sorted(out["results"]) == ["close_drawer/test", "open_cabinet/test",
                                      "open_drawer/train", "pick_mug/test"]
    assert out["results"] == ref["results"]
    assert all(r["episodes"] == 2 for r in out["results"].values())
    assert {k: out[k] for k in ("controller", "estimator", "rounds")} == \
        {"controller": "gt_pose", "estimator": "ground_truth", "rounds": 1}
    assert sorted(os.listdir(tmp_path / "docs")) == ["sweep_gt_pose_ground_truth.json",
                                                      "sweep_torch_gt_pose_ground_truth.json"]
    with open(COMMITTED, "rb") as f:
        assert f.read() == committed


def test_an_error_row_is_recorded_in_the_jax_form_and_fails_the_run(monkeypatch, tmp_path):
    rows = [("open_drawer", "open_drawer", [("train", "drawer_train")]),
            ("no_such_task", "open_cabinet", [("test", "cabinet_test")])]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "docs").mkdir()
    ref = run_jax(monkeypatch, rows, SMALL)["results"]
    with pytest.raises(SystemExit) as exc:
        run_port(monkeypatch, rows, SMALL)
    assert exc.value.code not in (0, None)
    assert "no_such_task/test" in str(exc.value.code)
    out = read_port()["results"]          # written before the exit
    assert out["open_drawer/train"] == ref["open_drawer/train"]
    assert sorted(out["no_such_task/test"]) == ["error"]
    port_err, jax_err = out["no_such_task/test"]["error"], ref["no_such_task/test"]["error"]
    assert port_err.startswith("ConfigError: config file not found")
    assert port_err.replace("rgbmanip_tpu_torch", "rgbmanip_tpu") == jax_err


def test_the_sweep_needs_a_card_unless_told_otherwise(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_sweep, "ROWS", SUBSET[:1])
    with pytest.raises(SystemExit):
        port_sweep.main(["1", "task.num_envs=2"])
    err = read_port()["results"]["open_cabinet/test"]["error"]
    assert err.startswith("RuntimeError: device cuda requested")
