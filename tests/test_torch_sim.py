"""The port's simulator and env against the JAX package's: the same
dataset, task and seed give bit-identical frames, masks, camera matrices,
joint states and handle boxes, after ``reset`` and after the same three
camera moves, for the cabinet and the drawer. The port builds its own
``libsimcore`` into ``build/`` and leaves the JAX package's sources alone.
"""

import os

import numpy as np
import pytest

from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu.train import prepare_env as jax_prepare_env
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch.config.loader import load_config
from rgbmanip_tpu_torch.sim import bindings
from rgbmanip_tpu_torch.train import prepare_env
from rgbmanip_tpu_torch.utils.logger import get_logger
from rgbmanip_tpu_torch.utils.transform import lookat_quat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CSRC = os.path.join(REPO, "rgbmanip_tpu", "sim", "csrc")
TASKS = {"cabinet": ["dataset=cabinet_train", "task=open_cabinet",
                     "manipulation=open_cabinet"],
         "drawer": ["dataset=drawer_train", "task=open_drawer",
                    "manipulation=open_drawer"]}
# three camera targets in the robot frame, as ControlInterface commands them
MOVES = [((-0.3, 0.0, 0.7), (1.0, 0.0, -0.2)),
         ((-0.1, 0.2, 0.8), (1.0, -0.3, -0.4)),
         ((0.1, -0.15, 0.6), (1.0, 0.2, 0.1))]


def snapshot(env):
    cam = env.get_image()["camera0"]
    out = {k: cam[k] for k in ("Color", "Mask", "Depth", "Intrinsic", "Extrinsic")}
    out["robot_qpos"] = env.robot_qpos()
    out["obj_dof"] = env.obj_dof()
    out["handle_bbox"] = env.handle_bbox()
    out["camera_pose"] = env.camera_pose(robot_frame=True)
    return out


def assert_same(port, ref, when):
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, (when, k)
        assert np.array_equal(port[k], ref[k]), (
            f"{when}: {k} differs, max |diff| "
            f"{np.abs(port[k].astype(np.float64) - ref[k].astype(np.float64)).max()}")


@pytest.fixture(scope="module", params=sorted(TASKS))
def envs(request):
    over = TASKS[request.param] + ["task.num_envs=2"]
    jcfg, pcfg = jax_load_config(over), load_config(over)
    jenv = jax_prepare_env(jcfg["task"], jcfg["dataset"], log=jax_get_logger(), seed=0)
    penv = prepare_env(pcfg["task"], pcfg["dataset"], log=get_logger(), seed=0)
    yield jenv, penv
    jenv.close()
    penv.close()


def test_reset_and_moves_render_the_same_frames(envs):
    jenv, penv = envs
    jenv.reset()
    penv.reset()
    assert_same(snapshot(penv), snapshot(jenv), "after reset")
    for i, (pos, look) in enumerate(MOVES):
        before = penv.camera_pose(robot_frame=True)
        pose = np.tile(np.concatenate([pos, lookat_quat(np.asarray(look))]), (2, 1))
        ok_j = jenv.cam_move_to(pose, time=2, wait=0.5, planner="path", robot_frame=True)
        ok_p = penv.cam_move_to(pose, time=2, wait=0.5, planner="path", robot_frame=True)
        np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_j))
        assert_same(snapshot(penv), snapshot(jenv), f"after move {i + 1}")
        assert not np.allclose(penv.camera_pose(robot_frame=True), before), "no move"
    assert penv.get_image()["camera0"]["Mask"].any(), "no view saw the handle"


def test_teleported_moves_render_the_same_frames(envs):
    """``cam_move_to(..., skip_move=True)``: the camera jumps to the target
    without a planned path, as PPO training (``ControlInterface.step`` with
    ``eval=False``) and the estimator's view sampler move it."""
    jenv, penv = envs
    jenv.reset()
    penv.reset()
    seen = False
    for i, (pos, look) in enumerate(MOVES):
        pose = np.tile(np.concatenate([pos, lookat_quat(np.asarray(look))]), (2, 1))
        kw = dict(time=2, wait=0.5, planner="path", robot_frame=True, skip_move=True,
                  no_collision_with_front=False)
        ok_j = jenv.cam_move_to(pose, **kw)
        ok_p = penv.cam_move_to(pose, **kw)
        np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_j))
        shot = snapshot(penv)
        assert_same(shot, snapshot(jenv), f"after teleport {i + 1}")
        seen |= bool(shot["Mask"].any())
    assert seen, "no view saw the handle"


def jax_csrc_listing():
    """Names and mtimes under the JAX package's ``sim/csrc``, less its own
    build product, which the JAX package's tests may be building in another
    worker at the same time."""
    return {n: os.stat(os.path.join(JAX_CSRC, n)).st_mtime_ns
            for n in os.listdir(JAX_CSRC) if n != "libsimcore.so"}


def test_the_port_builds_its_library_into_build_only(tmp_path, monkeypatch):
    jax_csrc_before = jax_csrc_listing()
    bindings.get_lib()
    default = bindings.library_path()
    assert os.path.dirname(default) == os.path.join(REPO, "build")
    assert os.path.basename(default).startswith("libsimcore-")
    assert os.path.exists(default)

    monkeypatch.setattr(bindings, "BUILD_DIR", str(tmp_path))
    out = bindings.build()
    assert out == str(tmp_path / os.path.basename(default))
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(default)]
    assert jax_csrc_listing() == jax_csrc_before


def test_the_library_hash_covers_the_cpu_model(monkeypatch):
    here = bindings.library_path()
    monkeypatch.setattr(bindings, "_cpu_model", lambda: "another CPU")
    assert bindings.library_path() != here
