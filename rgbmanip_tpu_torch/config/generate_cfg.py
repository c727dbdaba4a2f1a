"""Generate the port's config tree under ``rgbmanip_tpu_torch/config/cfg/``
(counterpart of ``rgbmanip_tpu/config/generate_cfg.py``).

The six spec functions give each group file (dataset, task, pose_estimator,
manipulation, controller, train) as the JAX package's generator gives it,
with two differences, both where the port's tree differs by design: the
``rl`` controller's ``learn`` block has no ``device: tpu`` (the port reads
the top-level ``device``), and ``config.yaml`` carries ``device: cuda``.

The committed tree is not all generated: ``manipulation/close_cabinet``,
``manipulation/close_drawer`` and ``controller/rl`` were edited by hand
after generation, and ``dataset/mug_urdf_fixture`` and the four
``pose_estimator/adapose_*_fast`` were written by hand. ``main`` rewrites
every file it generates under ``CFG``, those three included, so set ``CFG``
to a directory of your own to try it; ``load_config(..., cfg_root=CFG)``
then composes from it:

    python -c "from rgbmanip_tpu_torch.config import generate_cfg as g; \
               g.CFG = '/tmp/cfg'; g.main()"
"""

from __future__ import annotations

import copy
import os

import yaml

CFG = os.path.join(os.path.dirname(__file__), "cfg")


def _task(name, success_dof, dis, height, rot=(-0.2, 0.2), pos_angle=(-0.4, 0.4),
          dof=( [0.0], [0.0] )):
    return {
        "name": name,
        "robot_name": "panda",
        "num_envs": 8,
        "max_step": 512,
        "time_step": 0.005,
        "sim_substep": 1.0 / 360.0,
        "object_conf": {
            "init_pose": {"xyz": [0, 0, 0.5], "rot": [1.0, 0, 0, 0]},
            "init_dof": [0.0],
            "success_dof": success_dof,
            "randomization": {
                "rot": {"low": rot[0], "high": rot[1]},
                "pos_angle": {"low": pos_angle[0], "high": pos_angle[1]},
                "dis": {"low": dis[0], "high": dis[1]},
                "height": {"low": height[0], "high": height[1]},
                "dof": {"low": dof[0], "high": dof[1]},
            },
        },
        "robot_conf": {
            "hand_cam_pose": {"xyz": [0.1, 0, 0.1], "rot": [0.70710678, 0, -0.70710678, 0]},
            "init_pose": {"xyz": [0.0, 0, 0.15], "rot": [1.0, 0, 0, 0]},
            "init_dof": None,
            "randomization": {
                "pose": {
                    "xyz": {"low": [0.0, 0.0, 0.15], "high": [0.0, 0.0, 0.15]},
                    "rot": {"low": 0.0, "high": 0.0},
                },
                "dof": {
                    "low": [-0.025, -0.025, -0.025, -0.99248004, -0.025, 1.0705001, -0.025, 0.0, 0.0],
                    "high": [0.025, 0.025, 0.025, -0.89248, 0.025, 1.1705, 0.025, 0.04, 0.04],
                },
            },
        },
    }


def tasks():
    t = {}
    t["open_cabinet"] = _task("open_cabinet", [0.15], (0.5, 0.85), (0.01, 0.05))
    t["open_cabinet_45"] = copy.deepcopy(t["open_cabinet"])
    t["open_cabinet_45"]["object_conf"]["success_dof"] = [0.78]
    t["open_cabinet_no_dr"] = _task(
        "open_cabinet", [0.15], (0.6, 0.6), (0.02, 0.02), rot=(0.0, 0.0), pos_angle=(0.0, 0.0))
    t["open_drawer"] = _task("open_drawer", [0.15], (0.5, 0.8), (0.01, 0.05))
    t["open_drawer_30"] = copy.deepcopy(t["open_drawer"])
    t["open_drawer_30"]["object_conf"]["success_dof"] = [0.30]
    t["open_drawer_no_dr"] = _task(
        "open_drawer", [0.15], (0.6, 0.6), (0.02, 0.02), rot=(0.0, 0.0), pos_angle=(0.0, 0.0))
    t["open_pot"] = _task("open_pot", [0.01], (0.2, 0.38), (0.01, 0.3))
    t["pick_mug"] = _task("pick_mug", [0.03], (0.44, 0.50), (0.1, 0.15),
                          rot=(1.570796327, 4.71238898))
    t["close_cabinet"] = _task("close_cabinet", [0.15], (0.5, 0.85), (0.01, 0.05),
                               dof=([1.2], [1.2]))
    t["close_drawer"] = _task("close_drawer", [0.08], (0.5, 0.8), (0.01, 0.05),
                              dof=([0.25], [0.25]))
    t["real_world"] = _task("real_world", [0.15], (0.5, 0.85), (0.01, 0.05))
    return t


def datasets():
    # procedural datasets: (category, count, seed_base)
    spec = {
        "cabinet_train": ("one_door_cabinet", 39, 1000),
        "cabinet_test": ("one_door_cabinet", 17, 9000),
        "drawer_train": ("one_drawer_cabinet", 43, 2000),
        "drawer_test": ("one_drawer_cabinet", 17, 9500),
        "pot_train": ("pot", 21, 3000),
        "pot_test": ("pot", 4, 9800),
        "mug_train": ("mug", 35, 4000),
        "mug_test": ("mug", 15, 9900),
    }
    out = {}
    for name, (cat, count, base) in spec.items():
        out[name] = {
            "name": "procedural",
            "type": cat,
            "objects": {
                f"{cat}_{base + i}": {"category": cat, "seed": base + i, "name": f"{cat}_{base + i}"}
                for i in range(count)
            },
        }
    out["real_world"] = {"name": "real_world", "type": "real", "objects": {}}
    # PartNet-Mobility-style URDF dataset (mesh geometry through the AABB
    # seam; the fixture mirrors the reference's mobility.urdf layout,
    # cfg/dataset/cabinet_train.yaml entries). Real PartNet objects drop in
    # by listing more entries with path (+ active link in the name).
    for fixt, cat in (("cabinet", "one_door_cabinet"),
                      ("drawer", "one_drawer_cabinet"), ("pot", "pot")):
        out[f"{fixt}_urdf_fixture"] = {
            "name": "partnet_mobility",
            "type": cat,
            "dataset_root": ".",
            "objects": {
                "fixture_link_0": {
                    "name": "fixture_link_0",
                    "path": f"tests/fixtures/mobility_{fixt}/mobility.urdf",
                },
            },
        }
    return out


def manipulations():
    closed = {
        "open_cabinet": [0.13, 0.09, 0.09, 0.09, 0.09, 0.09],
        "open_drawer": [0.13, 0.09, 0.09, 0.09, 0.09, 0.09],
        "open_pot": [0.06],
        "pick_mug": [0.1],
        # close schedules extended past the reference's 6-step pull schedule
        # (reference reuses the pull lengths, close_cabinet.yaml; its close
        # skills are unbenchmarked): a door at dof 1.2 needs ~1.05 rad of
        # closing arc and the chord pushes convert distance imperfectly, so
        # episodes stalled ~0.2 rad short of the threshold
        "close_cabinet": [0.13, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09, 0.09],
        "close_drawer": [0.13, 0.09, 0.09, 0.09, 0.09],
    }
    out = {}
    for name, steps in closed.items():
        out[name] = {"name": name, "closed_loop": True, "step_sizes": steps}
        out[name + "_open_loop"] = {"name": name, "closed_loop": False, "step_sizes": [0.5]}
    return out


def pose_estimators():
    out = {"ground_truth": {"name": "ground_truth"}}
    # no-stereo-fusion ablation (reference interface_baseline.py)
    out["adapose_baseline"] = {
        "name": "adapose_baseline", "task_name": "one_door_cabinet",
        "load": False, "checkpoint_path": "", "img_size": 224,
        "use_depth": True, "n_pts": 1024, "direct_regression": True,
        "real_world": False, "volume_scale": 2, "warp_mode": "nearest",
    }
    for cat, task_name in [
        ("cabinet", "one_door_cabinet"),
        ("drawer", "one_drawer_cabinet"),
        ("pot", "pot"),
        ("mug", "mug"),
    ]:
        out[f"adapose_{cat}"] = {
            "name": "adapose_v5",
            "task_name": task_name,
            "load": False,
            "checkpoint_path": f"downloads/pose_estimator/{task_name}.pth",
            "img_size": 224,
            "use_depth": True,
            "n_pts": 1024,
            "direct_regression": True,
            "real_world": False,
            # TPU volume settings (2/nearest = production-fast; 1/bilinear =
            # reference parity)
            "volume_scale": 2,
            "warp_mode": "nearest",
        }
    return out


def controllers():
    rl = {
        "name": "rl",
        "controller": {
            "max_steps": 4,
            "action_type": "pose",
            "pose_min": [-0.3, -0.3, 0.4],
            "pose_max": [0.3, 0.3, 1.0],
            "early_stop": 4,
        },
        "reward": {
            "diff_coef": -0.5,
            "move_success_coef": 8.0,
            "move_period_coef": -0.0,
            "far_coef": -2.5,
            "ori_coef": 0.25,
            "xyz_lookat_coef": -0.05,
            "bbox_coef": -1.0,
            "bbox_boundary_coef": -1.0,
            "have_bbox_coef": 2.0,
            "center_coef": 12.0,
            "open_coef": 8.0,
            "view_coef": 0.5,
            "view_norm_coef": -0.3,
            "success_coef": 0.0,
        },
        "policy": {
            "actor_critic_class": "ActorCritic",
            "pi_hid_sizes": [96, 96, 32],
            "vf_hid_sizes": [96, 96, 32],
            "activation": "elu",
        },
        "learn": {
            "exp_name": "PPO",
            "reset": True,
            "num_transitions_per_env": 16,
            "num_transitions_eval": 512,
            "num_learning_epochs": 8,
            "num_mini_batches": 4,
            "clip_range": 0.2,
            "gamma": 0.98,
            "lam": 0.98,
            "init_noise_std": 0.6,
            "value_loss_coef": 1.0,
            "entropy_coef": 0.0,
            "learning_rate": 1.0e-5,
            "max_grad_norm": 1.0,
            "use_clipped_value_loss": True,
            "schedule": "adaptive",
            "desired_kl": 0.016,
            "max_lr": 0.005,
            "min_lr": 0.0002,
            "sampler": "sequential",
            "log_dir": "logs/ppo_controller",
            "save_dir": "saves/ppo_controller",
            "eval_interval": 64,
            "eval_round": 16,
            "print_log": True,
            "asymmetric": False,
        },
        "load": "",
    }
    return {
        "heuristic_pose": {"name": "heuristic_pose"},
        "gt_pose": {"name": "gt_pose"},
        "homing": {"name": "homing"},
        "baseline": {"name": "baseline"},
        "rl": rl,
        "collect_pose": {
            "name": "collection",
            "target": "pose_estimator",
            "pose_estimator": {"pose_min": [-0.3, -0.3, 0.4], "pose_max": [0.3, 0.3, 1.0]},
            "learn": {"log_dir": "logs/collect", "save_dir": "saves/collect"},
        },
        "collect_baselines": {
            "name": "collection",
            "target": "baselines",
            "pose_estimator": {"pose_min": [-0.3, -0.3, 0.4], "pose_max": [0.3, 0.3, 1.0]},
            "learn": {"log_dir": "logs/collect", "save_dir": "saves/collect"},
        },
    }


def trains():
    base = {"log_dir": "./logs", "save_dir": "./saves"}
    return {
        "test": dict(base, name="test", total_round=100, train_manipulation=False, train_controller=False),
        "collect": dict(base, name="collect", total_round=4096, train_manipulation=False, train_controller=False),
        "controller": dict(base, name="train", train_manipulation=False, train_controller=True,
                           iterations_per_epoch=600, log_interval=1, save_interval=25),
        "test_baseline": dict(base, name="test_baseline", train_manipulation=False, train_controller=False,
                              task_setting_root=None, action_path=None),
    }


def main():
    groups = {
        "task": tasks(),
        "dataset": datasets(),
        "manipulation": manipulations(),
        "pose_estimator": pose_estimators(),
        "controller": controllers(),
        "train": trains(),
    }
    for group, files in groups.items():
        d = os.path.join(CFG, group)
        os.makedirs(d, exist_ok=True)
        for fname, content in files.items():
            with open(os.path.join(d, f"{fname}.yaml"), "w") as f:
                yaml.safe_dump(content, f, sort_keys=False)
    root = {
        "defaults": {
            "dataset": "cabinet_train",
            "task": "open_cabinet",
            "pose_estimator": "ground_truth",
            "manipulation": "open_cabinet",
            "controller": "heuristic_pose",
            "train": "test",
        },
        "exp_name": "test",
        "headless": True,
        "viewerless": False,
        "seed": 0,
        "device": "cuda",
    }
    with open(os.path.join(CFG, "config.yaml"), "w") as f:
        yaml.safe_dump(root, f, sort_keys=False)
    n = sum(len(v) for v in groups.values()) + 1
    print(f"wrote {n} config files under {CFG}")


if __name__ == "__main__":
    main()
