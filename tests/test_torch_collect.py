"""Offline data and the estimator's quality harnesses: ``train=collect``,
``train=test_baseline``, ``inference`` and ``evaluate`` through the port
against the JAX package's, both on the CPU.

- ``collect_pose`` and ``collect_baselines`` on ``open_cabinet_no_dr`` at 2
  envs write the same files as the JAX package: the same names, the same
  keys, arrays equal bit for bit (the simulator is bit-exact and both
  collectors draw from ``default_rng(0)`` in one order).
- ``inference.main`` on the collected pairs, at 64 px and 128 points on
  weights made from a seed (the same checkpoint for both), with the port fed
  the JAX estimator's point-sampling draws: every bbox within 1e-3 m of the
  JAX one (f32 on both sides, the convolutions summed in other orders).
- ``parse_baseline_actions`` on the four formats of action file, and
  ``test_baseline`` replaying settings that one package collected in both
  packages: equal actions, equal success.
- ``evaluate`` at the fast estimator's knobs with its committed checkpoint,
  2 rounds of 2 envs, f32 on both sides: the stats within 1e-3 m and 0.1
  degree, the same ``valid_frac``.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu import train as jax_train
from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.config.loader import load_config
from rgbmanip_tpu_torch.utils.logger import get_logger

from test_torch_paper_estimator import init_shapes_only, seeded_tree
from test_torch_rl_loop import jax_pallas_crop, keep_keys, replay_draws

torch.set_num_threads(2)

TASK = ["dataset=cabinet_train", "task=open_cabinet_no_dr", "manipulation=open_cabinet",
        "pose_estimator=ground_truth", "task.num_envs=2", "seed=3"]
TARGETS = ("collect_pose", "collect_baselines")
CKPT_FAST = "checkpoints/estimator_fast_cabinet_aug_r5.ckpt"
FAST = dict(backend="resnet18", backbone_stride=32, volume_scale=8, n_depth=16,
            d_interval=0.15, warp_mode="nearest")
PKGS = {"jax": jax_train, "port": port_train}
FORMATS = ("plain", "comma_point", "comma_pixel", "w2a_report")


def collect_into(pkg, target, root):
    over = TASK + [f"controller={target}", "train=collect", "train.total_round=2",
                   f"controller.learn.save_dir={root}", f"train.save_dir={root}/saves",
                   f"train.log_dir={root}/logs"]
    pkg.main(over + (["device=cpu"] if pkg is port_train else []))
    return root


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """{(package, target): directory of the files it collected}."""
    return {(name, target): collect_into(pkg, target,
                                         str(tmp_path_factory.mktemp(f"{name}_{target}")))
            for name, pkg in PKGS.items() for target in TARGETS}


def samples(root):
    return sorted(f for f in os.listdir(root) if f.startswith("sample_"))


def assert_same(a, b, where):
    assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("target", TARGETS)
def test_collect_writes_the_files_jax_writes(collected, target):
    ref, out = collected["jax", target], collected["port", target]
    names = samples(ref)
    assert names == samples(out) and len(names) == 4     # a .pkl and an .npz per env
    for name in names:
        if name.endswith(".pkl"):
            with open(os.path.join(ref, name), "rb") as f:
                a = pickle.load(f)
            with open(os.path.join(out, name), "rb") as f:
                b = pickle.load(f)
            assert_same(b, a, name)
        else:
            a, b = np.load(os.path.join(ref, name)), np.load(os.path.join(out, name))
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name}:{k}")


# ------------------------------------------------------------------ inference --
def patched_estimators(mp, keys, bboxes):
    """Make the next JAX ``AdaPoseEstimator`` keep its keys and the next
    port one replay them; both record each batch's bboxes."""
    from rgbmanip_tpu.models.pose_estimator import adapose as jad
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu_torch.models.pose_estimator import adapose as pad

    def record(est, name):
        estimate, full = est.estimate, est.estimate_full

        def recorded(*args):
            out = estimate(*args)
            bboxes[name].append(np.array(out))
            return out

        def recorded_full(*args):
            out = full(*args)
            bboxes[name].append(dict(out))
            return out
        est.estimate, est.estimate_full = recorded, recorded_full

    class JaxEstimator(jad.AdaPoseEstimator):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            keep_keys(self, keys)
            record(self, "jax")

    class PortEstimator(pad.AdaPoseEstimator):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            replay_draws(self, keys)
            record(self, "port")

    mp.setattr(jad, "AdaPoseEstimator", JaxEstimator)
    mp.setattr(pad, "AdaPoseEstimator", PortEstimator)
    # the JAX weights come from the checkpoint: take the init's shapes only
    mp.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)


def test_inference_on_collected_pairs_equals_jax(collected, tmp_path, monkeypatch):
    from rgbmanip_tpu.models.pose_estimator import inference as jax_inference
    from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu_torch.models.pose_estimator import inference

    args = ["--img_size", "64", "--n_pts", "128", "--batch", "8"]
    cfg = {"name": "adapose_v5", "task_name": "eval", "load": False, "img_size": 64,
           "n_pts": 128, "use_depth": True, "direct_regression": True,
           "real_world": False}
    keys, bboxes = [], {"jax": [], "port": []}
    patched_estimators(monkeypatch, keys, bboxes)
    # weights made from a seed, written as the JAX package's checkpoint
    est = AdaPoseEstimator(cfg, jax_get_logger())
    rng = np.random.default_rng(0)
    est.params = seeded_tree(est.params, rng)
    est.batch_stats = seeded_tree(est.batch_stats, rng)
    ckpt = str(tmp_path / "seeded.ckpt")
    est.save(ckpt)
    keys.clear()
    bboxes["jax"].clear()
    data = collected["jax", "collect_pose"]
    with jax_pallas_crop():
        ref = jax_inference.main(["--data_root", data, "--checkpoint", ckpt] + args)
    out = inference.main(["--data_root", data, "--checkpoint", ckpt, "--device", "cpu"]
                         + args)
    assert len(keys) == len(bboxes["jax"]) == len(bboxes["port"]) == 1
    gap = float(np.abs(bboxes["port"][0] - bboxes["jax"][0]).max())
    print(f"inference: port {out}, JAX {ref}; largest bbox gap {gap:.3g} m (limit 1e-3)")
    assert out["n"] == ref["n"] == 2
    assert gap <= 1e-3
    for k in ("center_err_mean", "center_err_median", "size_err_mean"):
        assert abs(out[k] - ref[k]) <= 1e-3, k


# --------------------------------------------------------------- baselines ---
def action_line(fmt, key, setting, position, mask):
    """One action in ``fmt`` for a collected setting: the gt handle centre
    (or the pixel nearest it) and the direction out of the handle."""
    gt = np.asarray(setting["gt_bbox"], np.float64)
    center = (gt[0] + gt[6]) / 2
    d = gt[0] - gt[1]
    d = d / np.linalg.norm(d)
    if fmt == "plain":
        return f"{key} " + " ".join(f"{v:.6f}" for v in (*center, *d))
    if fmt == "comma_point":
        return (f"{key}.pkl, [{center[0]:.6f}, {center[1]:.6f}, {center[2]:.6f}], "
                f"[{d[0]:.6f} {d[1]:.6f} {d[2]:.6f}]")
    ys, xs = np.nonzero(mask)
    i = int(np.argmin(np.linalg.norm(position[ys, xs] - center, axis=-1)))
    cx, cy = int(ys[i]), int(xs[i])     # indexes position[cx][cy]
    if fmt == "comma_pixel":
        return f"{key}, [{cx}, {cy}], [{d[0]:.6f}, {d[1]:.6f}, {d[2]:.6f}]"
    return (f"{key}.pickle ({cx}, {cy}) 0.87 [{d[0]:.6f} {d[1]:.6f} {d[2]:.6f}] "
            f"[0.0 0.0 1.0]")


def action_file(root, fmt, dest):
    """An action file of ``fmt`` for the settings under ``root``, with a line
    of junk and one for a setting that is not there."""
    lines = []
    for name in samples(root):
        if name.endswith(".pkl"):
            key = name[:-4]
            with open(os.path.join(root, name), "rb") as f:
                setting = pickle.load(f)
            npz = np.load(os.path.join(root, key + ".npz"))
            lines.append(action_line(fmt, key, setting, npz["position"], npz["mask"]))
    lines += ["", "sample_999999 0 0 0 1 0 0"]
    path = os.path.join(dest, f"actions_{fmt}" + ("_w2a_report" if fmt == "w2a_report"
                                                   else "") + ".txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def settings_of(root):
    out = {}
    for name in samples(root):
        if name.endswith(".pkl"):
            with open(os.path.join(root, name), "rb") as f:
                out[name[:-4]] = pickle.load(f)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_baseline_actions_equals_jax(collected, tmp_path, fmt):
    root = collected["jax", "collect_baselines"]
    path = action_file(root, fmt, str(tmp_path))
    settings = settings_of(root)
    parsed = {}
    for name, pkg in PKGS.items():
        parsed[name] = pkg.parse_baseline_actions(
            path, settings, lambda key, pkg=pkg: pkg._baseline_position_map(root, key))
    assert [k for k, _ in parsed["port"]] == [k for k, _ in parsed["jax"]]
    assert len(parsed["port"]) == 2
    for (_, a), (_, b) in zip(parsed["port"], parsed["jax"]):
        np.testing.assert_array_equal(a, b)


def replay(pkg, root, actions, log):
    over = TASK + ["controller=baseline", "train=test_baseline", "task.num_envs=1",
                   f"train.task_setting_root={root}", f"train.action_path={actions}"]
    cfg = load_config(over + ["device=cpu"]) if pkg is port_train else jax_load_config(over)
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    outcome = []
    try:
        manip = pkg.prepare_manipulation(env, cfg["manipulation"], log)
        pe = pkg.prepare_pose_estimator(env, cfg["pose_estimator"], log)
        ctrl = pkg.prepare_controller(env, pe, manip, cfg["controller"], cfg, log)
        run = ctrl.run

        def recorded(setting, action, eval=False):
            run(setting, action, eval)
            obs = env.get_observation()
            outcome.append((float(obs["success"].sum()),
                            float(obs["total_move_distance"].sum())))
        ctrl.run = recorded
        pkg.test_baseline(env, ctrl, cfg, log)
    finally:
        env.close()
    return outcome


@pytest.mark.parametrize("collector", ["jax", "port"])
def test_test_baseline_replays_what_either_package_collected(collected, tmp_path,
                                                             collector):
    root = collected[collector, "collect_baselines"]
    actions = action_file(root, "comma_pixel", str(tmp_path))
    ref = replay(jax_train, root, actions, jax_get_logger())
    out = replay(port_train, root, actions, get_logger())
    print(f"settings collected by {collector}: port {out}, JAX {ref}")
    assert out == ref and len(out) == 2
    # the entry point runs the mode end to end
    port_train.main(TASK + ["controller=baseline", "train=test_baseline",
                            "task.num_envs=1", f"train.task_setting_root={root}",
                            f"train.action_path={actions}", "device=cpu",
                            f"train.save_dir={tmp_path}", f"train.log_dir={tmp_path}"])


# ------------------------------------------------------------------ evaluate --
def test_evaluate_equals_jax_in_f32(monkeypatch):
    from rgbmanip_tpu.models.pose_estimator.evaluate import evaluate as jax_evaluate
    from rgbmanip_tpu_torch.models.pose_estimator.evaluate import evaluate

    keys, bboxes = [], {"jax": [], "port": []}
    patched_estimators(monkeypatch, keys, bboxes)
    over = ["dataset=cabinet_test", "task=open_cabinet", "task.num_envs=2", "seed=5"]
    kw = dict(checkpoint=CKPT_FAST, rounds=2, img_size=192, n_pts=256, est_overrides=FAST)
    with jax_pallas_crop():
        ref = jax_evaluate(over, dtype=jnp.float32, **kw)
    out = evaluate(over, device="cpu", dtype=torch.float32, **kw)
    print(f"evaluate: port {out}\n          JAX  {ref}")
    assert len(bboxes["port"]) == len(bboxes["jax"]) == 2
    for a, b in zip(bboxes["port"], bboxes["jax"]):
        np.testing.assert_array_equal(a["valid"], b["valid"])
        assert np.abs(a["bbox"] - b["bbox"]).max() <= 1e-3
    assert out["valid_frac"] == ref["valid_frac"] > 0
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        limit = 0.1 if k.endswith("_deg") else 1e-3
        assert abs(out[k] - v) <= limit, (k, out[k], v)
