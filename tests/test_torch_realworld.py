"""The real-world env in the port (``rgbmanip_tpu_torch/envs/realworld/``:
``BaseRealworldEnv`` and its hand-eye calibration file, with
``dataset/real_world.yaml`` and ``task/real_world.yaml``) against the JAX
package's, both on the CPU, with the fake robot, camera and segmenter of
tests/test_realworld.py (no hardware exists for either package).

- A missing driver raises the same error in both.
- Hand-eye frames: ``cam_move_to`` puts the camera at the target and
  ``gripper_move_to`` the grip centre, in both, to 1e-9; the driver
  receives the same hand poses.
- ``get_image``: the same dict (keys, dtypes, shapes, values).
- The calibration file ships in the port and loads the same pose.
- The ``realworld`` estimate (``make_estimator("realworld")``, resnet10s at
  64 px, 128 points, 8 bins, as tests/test_realworld.py builds it) on the
  env's images: seeded weights carried to the port by the converter, the
  JAX estimator's point-sampling draws, the JAX crop through its Pallas
  kernel in interpret mode (the estimate's rule on the TPU): the world bbox
  within 1e-3 m and equal valid flags; an empty mask gives the sentinel
  (every corner at 9 m or more) in both.
- ``task=real_world`` through ``train.main`` builds the env without drivers
  and raises the JAX package's error on the first observation.
"""

import os

import jax
import numpy as np
import pytest
import torch

from rgbmanip_tpu.envs.realworld import base_realworld as J
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch.envs.realworld import base_realworld as P
from rgbmanip_tpu_torch.utils.logger import get_logger
from rgbmanip_tpu_torch.utils.transform import Pose
from test_realworld import FakeCamera, FakeRobot, FakeSAM

torch.set_num_threads(2)

EST = {"name": "adapose_realworld", "img_size": 64, "n_pts": 128, "n_depth": 8,
       "backend": "resnet10s", "load": False}
TARGET = Pose([0.5, 0.1, 0.6], [0.0, 1.0, 0.0, 0.0]).to_7d()
SECOND = Pose([0.45, 0.15, 0.55], [0.0, 1.0, 0.0, 0.0]).to_7d()


def envs():
    """The two packages' envs, each with its own fakes."""
    return (J.BaseRealworldEnv(robot_driver=FakeRobot(), camera_driver=FakeCamera(),
                               segmenter=FakeSAM(), logger=jax_get_logger()),
            P.BaseRealworldEnv(robot_driver=FakeRobot(), camera_driver=FakeCamera(),
                               segmenter=FakeSAM(), logger=get_logger()))


def raised(fn):
    with pytest.raises(RuntimeError) as e:
        fn()
    return str(e.value)


def test_a_missing_driver_raises_as_in_jax():
    jenv, penv = J.BaseRealworldEnv(logger=jax_get_logger()), P.BaseRealworldEnv(logger=get_logger())
    for name in ("hand_pose", "get_image", "reset", "camera_pose"):
        assert raised(getattr(penv, name)) == raised(getattr(jenv, name)), name
    assert "robot" in raised(penv.hand_pose) and "camera" in raised(penv.get_image)
    assert raised(lambda: penv.toggle_gripper(True)) == raised(lambda: jenv.toggle_gripper(True))


def test_hand_eye_frames_round_trip_as_in_jax():
    jenv, penv = envs()
    for env in (jenv, penv):
        env.cam_move_to(TARGET[None])
        np.testing.assert_allclose(env.camera_pose()[0], TARGET, atol=1e-9)
        env.gripper_move_to(TARGET[None])
        np.testing.assert_allclose(env.gripper_pose()[0], TARGET, atol=1e-9)
        env.toggle_gripper(open=False)
    assert len(penv.robot.moves) == len(jenv.robot.moves) == 2
    for a, b in zip(penv.robot.moves, jenv.robot.moves):
        np.testing.assert_array_equal(a, b)
    assert penv.robot.gripper == jenv.robot.gripper == 0.0
    for k, v in jenv.get_observation().items():
        np.testing.assert_array_equal(penv.get_observation()[k], v, err_msg=k)
    np.testing.assert_array_equal(penv.robot_pose(), jenv.robot_pose())


def test_get_image_gives_the_jax_dict():
    jenv, penv = envs()
    for env in (jenv, penv):
        env.cam_move_to(SECOND[None])
    j, p = jenv.get_image()["camera0"], penv.get_image()["camera0"]
    assert sorted(p) == sorted(j)
    for k in j:
        assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert p["Color"].shape == (1, 480, 640, 3) and p["Mask"].sum() == 80 * 80


def test_the_calibration_file_ships_and_loads_as_in_jax():
    assert os.path.exists(P.CALIB_FILE) and os.path.dirname(P.CALIB_FILE).startswith(
        os.path.dirname(os.path.abspath(P.__file__)))
    assert open(P.CALIB_FILE).read() == open(J.CALIB_FILE).read()
    jp, pp = J.BaseRealworldEnv(logger=jax_get_logger()).hand_cam_pose, \
        P.BaseRealworldEnv(logger=get_logger()).hand_cam_pose
    np.testing.assert_array_equal(pp.to_7d(), jp.to_7d())
    assert abs(pp.p[0] - 0.07) < 1e-6 and abs(pp.q[3] - 0.7071068) < 1e-6


@pytest.fixture(scope="module")
def estimates():
    from rgbmanip_tpu.models.pose_estimator.adapose import make_estimator as jax_make
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import make_estimator
    from rgbmanip_tpu_torch.models.pose_estimator.converter import load_jax_params
    from test_torch_paper_estimator import init_shapes_only, seeded_tree
    from test_torch_rl_loop import jax_pallas_crop, uniforms_of

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
        jest = jax_make("realworld", EST, jax_get_logger())
    rng = np.random.default_rng(0)
    jest.params = seeded_tree(jest.params, rng)
    jest.batch_stats = seeded_tree(jest.batch_stats, rng)
    pest = make_estimator("realworld", EST, get_logger(), device="cpu")
    assert pest.model.realworld_pts
    load_jax_params(pest.model, jest.params, jest.batch_stats)

    jenv, penv = envs()
    views = []
    for env in (jenv, penv):
        i1 = env.get_image()["camera0"]
        env.cam_move_to(SECOND[None])
        i2 = env.get_image()["camera0"]
        views.append((i1, i2))
    for a, b in zip(views[0], views[1]):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    i1, i2 = views[1]
    empty = np.zeros_like(i1["Mask"])
    out = {}
    for name, m1 in (("views", i1["Mask"]), ("empty", empty)):
        args = (i1["Intrinsic"], i1["Color"], m1, i1["Extrinsic"], i2["Color"], i2["Mask"],
                i2["Extrinsic"])
        key = jax.random.PRNGKey(3)
        with jax_pallas_crop():
            jb, jv, _ = jest._estimate_fn(jest.params, jest.batch_stats, *args, key)
        u1, u2 = uniforms_of(key, 1, EST["img_size"])
        t = torch.from_numpy
        pb, pv, _ = pest._estimate(t(args[0]), t(args[1]), t(args[2]), t(args[3]), t(args[4]),
                                   t(args[5]), t(args[6]), t(u1), t(u2))
        out[name] = (np.asarray(jb), np.asarray(jv), pb.numpy(), pv.numpy())
    return out


def test_the_realworld_estimate_on_the_envs_images_matches_jax(estimates):
    jb, jv, pb, pv = estimates["views"]
    assert pb.shape == jb.shape == (1, 8, 3) and np.isfinite(pb).all()
    np.testing.assert_array_equal(pv, jv)
    print("max |bbox diff| (m):", np.abs(pb - jb).max())
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)


def test_an_empty_mask_gives_the_sentinel_as_in_jax(estimates):
    jb, jv, pb, pv = estimates["empty"]
    assert (jb >= 9.0).all() and (pb >= 9.0).all()
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)


def test_task_real_world_builds_the_env_through_main_and_raises_as_jax(tmp_path):
    from rgbmanip_tpu.train import main as jax_main
    from rgbmanip_tpu_torch.train import main, prepare_env

    env = prepare_env({"name": "real_world"}, {})
    assert type(env) is P.BaseRealworldEnv and env.num_envs == 1
    args = ["dataset=real_world", "task=real_world", f"train.log_dir={tmp_path / 'l'}",
            f"train.save_dir={tmp_path / 's'}"]
    ref = raised(lambda: jax_main(args))
    assert raised(lambda: main(args + ["device=cpu"])) == ref
    assert "robot driver not configured" in ref
