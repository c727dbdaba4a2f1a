"""The URDF fixture datasets in the port (``rgbmanip_tpu_torch/assets/
{urdf,urdf_object,mesh,objmesh}.py``, the URDF branch of
``VecManipulationEnv._object_source`` and ``dataset/*_urdf_fixture.yaml``)
against the JAX package's, both on the CPU, on the four fixtures under
``tests/fixtures/mobility_*`` (URDF and OBJ files).

- ``load_urdf``: the specs equal field by field on the four fixtures
  (meshes compared by their registered geometry, since each package's
  simulator numbers its meshes from its own registry);
  ``load_object_urdf``: the meta and every shape's seg id equal.
- ``mesh.mesh_aabb`` and ``objmesh.load_obj``: equal on every fixture mesh.
- The fixture scenes render bit for bit (frames, masks, depth, cameras,
  joint states, handle boxes) after a reset and after camera moves, as
  tests/test_torch_sim.py holds the procedural scenes.
- The ground-truth stack gives equal per-episode success and move distance
  on the four fixture tasks at 8 envs x 1 round (the JAX package runs them
  end to end at 16 episodes in tests/test_urdf_object.py).
- One round of the flagship evaluation on ``cabinet_urdf_fixture`` at 2
  envs, lock-step as tests/test_torch_rl_loop.py drives it: frames bit for
  bit, actions within 1e-5, two-view estimates within 1e-3 m.
"""

import os

import numpy as np
import pytest

from rgbmanip_tpu import train as jax_train
from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.config.loader import load_config
from rgbmanip_tpu_torch.utils.logger import get_logger
from test_torch_sim import MOVES, assert_same, snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
KINDS = ("cabinet", "drawer", "pot", "mug")
TASKS = {"cabinet": ("open_cabinet", "open_cabinet"), "drawer": ("open_drawer", "open_drawer"),
         "pot": ("open_pot", "open_pot"), "mug": ("pick_mug", "pick_mug")}
CATEGORY = {"cabinet": "one_door_cabinet", "drawer": "one_drawer_cabinet", "pot": "pot",
            "mug": "mug"}


def urdf(kind):
    return os.path.join(FIXTURES, f"mobility_{kind}", "mobility.urdf")


def plain(spec, mesh_aabb):
    """An ArticulationSpec as nested lists, each mesh id replaced by the
    registered mesh's (lo, hi, triangles)."""
    links = []
    for link in spec.links:
        d = {k: v for k, v in vars(link).items() if k != "shapes"}
        d = {k: np.asarray(v).tolist() for k, v in d.items()}
        shapes = []
        for s in link.shapes:
            sd = {k: np.asarray(v).tolist() for k, v in vars(s).items() if k != "mesh"}
            if s.mesh >= 0:
                lo, hi, nt = mesh_aabb(s.mesh)
                sd["mesh"] = (lo.tolist(), hi.tolist(), int(nt))
            shapes.append(sd)
        d["shapes"] = shapes
        links.append(d)
    return links


@pytest.mark.parametrize("kind", KINDS)
def test_load_urdf_and_load_object_urdf_match_jax(kind):
    from rgbmanip_tpu.assets import objmesh as jobj
    from rgbmanip_tpu.assets import urdf as jurdf
    from rgbmanip_tpu.assets import urdf_object as juo
    from rgbmanip_tpu_torch.assets import objmesh as pobj
    from rgbmanip_tpu_torch.assets import urdf as purdf
    from rgbmanip_tpu_torch.assets import urdf_object as puo

    path = urdf(kind)
    for kw in ({}, {"prefer_visual_shapes": True}, {"load_meshes": False}):
        j = plain(jurdf.load_urdf(path, **kw), jobj.mesh_aabb)
        p = plain(purdf.load_urdf(path, **kw), pobj.mesh_aabb)
        assert p == j, (kind, kw)
    jspec, jmeta = juo.load_object_urdf(path, "link_0", category=CATEGORY[kind])
    pspec, pmeta = puo.load_object_urdf(path, "link_0", category=CATEGORY[kind])
    assert vars(pmeta) == vars(jmeta)
    assert plain(pspec, pobj.mesh_aabb) == plain(jspec, jobj.mesh_aabb)
    vids = [s.visual_id for link in pspec.links for s in link.shapes]
    assert vids == [s.visual_id for link in jspec.links for s in link.shapes]
    assert any(v > 0 for v in vids)


def test_mesh_readers_match_jax():
    from rgbmanip_tpu.assets import mesh as jmesh
    from rgbmanip_tpu.assets import objmesh as jobj
    from rgbmanip_tpu_torch.assets import mesh as pmesh
    from rgbmanip_tpu_torch.assets import objmesh as pobj

    n = 0
    for kind in KINDS:
        d = os.path.join(FIXTURES, f"mobility_{kind}")
        for name in sorted(os.listdir(d)):
            if not name.endswith(".obj"):
                continue
            path = os.path.join(d, name)
            for a, b in zip(pmesh.mesh_aabb(path), jmesh.mesh_aabb(path)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(pmesh.mesh_bounds(path, (1.0, 2.0, 0.5)),
                            jmesh.mesh_bounds(path, (1.0, 2.0, 0.5))):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(pobj.load_obj(path), jobj.load_obj(path)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            n += 1
    assert n >= 20
    assert pmesh.mesh_aabb(os.path.join(FIXTURES, "missing.obj")) is None


def over(kind, n_envs, rounds=1):
    task, manip = TASKS[kind]
    return [f"dataset={kind}_urdf_fixture", f"task={task}", f"manipulation={manip}",
            f"task.num_envs={n_envs}", f"train.total_round={rounds * n_envs}", "seed=0"]


@pytest.mark.parametrize("kind", KINDS)
def test_fixture_scenes_render_the_same_frames(kind):
    from rgbmanip_tpu_torch.utils.transform import lookat_quat

    o = over(kind, 2)
    jcfg, pcfg = jax_load_config(o), load_config(o)
    jenv = jax_train.prepare_env(jcfg["task"], jcfg["dataset"], log=jax_get_logger(), seed=0)
    penv = port_train.prepare_env(pcfg["task"], pcfg["dataset"], log=get_logger(), seed=0)
    try:
        jenv.reset()
        penv.reset()
        assert_same(snapshot(penv), snapshot(jenv), "after reset")
        for i, (pos, look) in enumerate(MOVES[:2]):
            pose = np.tile(np.concatenate([pos, lookat_quat(np.asarray(look))]), (2, 1))
            ok_j = jenv.cam_move_to(pose, time=2, wait=0.5, planner="path", robot_frame=True)
            ok_p = penv.cam_move_to(pose, time=2, wait=0.5, planner="path", robot_frame=True)
            np.testing.assert_array_equal(np.asarray(ok_p), np.asarray(ok_j))
            assert_same(snapshot(penv), snapshot(jenv), f"after move {i + 1}")
    finally:
        jenv.close()
        penv.close()


def gt_round(pkg, cfg, log):
    """``train.test`` of the gt stack, with each round's per-episode success
    and move distance."""
    per = []
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = pkg.prepare_manipulation(env, cfg["manipulation"], log)
        pe = pkg.prepare_pose_estimator(env, cfg["pose_estimator"], log)
        ctrl = pkg.prepare_controller(env, pe, manip, cfg["controller"], cfg, log)
        run = ctrl.run

        def rec(eval=False):
            run(eval=eval)
            obs = env.get_observation()
            per.append((np.array(obs["success"]), np.array(obs["total_move_distance"])))
        ctrl.run = rec
        return pkg.test(env, ctrl, cfg, log), per
    finally:
        env.close()


@pytest.mark.parametrize("kind", KINDS)
def test_gt_stack_per_episode_success_equals_jax(kind):
    o = over(kind, 8) + ["controller=gt_pose", "pose_estimator=ground_truth", "train=test"]
    ref, jper = gt_round(jax_train, jax_load_config(o), jax_get_logger())
    out, pper = gt_round(port_train, load_config(o + ["device=cpu"]), get_logger())
    print(kind, "port", out, "jax", ref)
    assert out == ref and out["rounds"] == 8
    for (ps, pm), (js, jm) in zip(pper, jper):
        np.testing.assert_array_equal(ps, js)
        np.testing.assert_array_equal(pm, jm)


@pytest.fixture(scope="module")
def fixture_loop(tmp_path_factory):
    from test_torch_rl_loop import flagship, run, run_jax

    o = flagship() + ["dataset=cabinet_urdf_fixture"]
    ref = run_jax(o, tmp_path_factory.mktemp("ppo"))
    out = run(port_train, load_config(o + ["device=cpu"]), get_logger(), drive=ref,
              device="cpu")
    return ref, out


def test_a_flagship_round_on_the_cabinet_fixture_runs_lock_step(fixture_loop):
    from test_torch_rl_loop import duplicated

    ref, out = fixture_loop
    assert len(out["actions"]) == len(ref["actions"]) == 4
    for t, (fp, fj, mp, mj) in enumerate(zip(out["frames"], ref["frames"],
                                             out["masks"], ref["masks"])):
        assert np.array_equal(fp, fj) and np.array_equal(mp, mj), f"step {t + 1}"
    assert any(m.any() for m in out["masks"]), "no step saw the handle"
    assert max(np.abs(a - b).max() for a, b in zip(out["actions"], ref["actions"])) <= 1e-5
    dup = duplicated(ref)
    np.testing.assert_array_equal(duplicated(out), dup)
    diff = np.stack([np.abs(a - b).reshape(a.shape[0], -1).max(-1)
                     for a, b in zip(out["pred_bbox"], ref["pred_bbox"])])
    print("max |pred_bbox diff| (m), two views:", diff[~dup].max(initial=0.0),
          f"({int((~dup).sum())} estimates)")
    assert (~dup).sum() >= 2, "too few two-view estimates to compare"
    assert diff[~dup].max() <= 1e-3
    for s, j in zip(out["success"], ref["success"]):
        np.testing.assert_array_equal(s, j)
