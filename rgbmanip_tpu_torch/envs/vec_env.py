"""Batched manipulation environments over the C++ simcore.

``VecManipulationEnv`` implements the reference's ``MultiVecEnv`` public
surface (step/reset/load/get_image/get_observation/hand|cam|gripper_move_to/
hand|gripper|camera_pose/robot_qpos/class_method/get_attr — reference
``env/my_vec_env.py:108-534``) but as ONE batched object: every environment
lives in the shared C++ pool, every motion command executes entire
trajectories native-side in parallel, and observations arrive as stacked
numpy arrays without any pipe serialization. Per-env semantics (randomized
scene generation, rewards, success, gt bboxes) mirror
``env/sapien_envs/base_manipulation.py`` + ``open_cabinet.py`` + ``open_pot.py``.

This is the port's copy of ``rgbmanip_tpu/envs/vec_env.py`` with every task
env (cabinet and drawer, pot and mug, and the close variants), on the
procedural objects and on URDF objects (``assets/urdf_object.py``).
"""

from __future__ import annotations

import os

import numpy as np

from ..assets import panda, procedural
from ..assets.spec import pose7
from ..sim.pool import SimPool
from ..utils.logger import PhaseTimer, get_logger
from ..utils.tools import Box, DictSpace, convert_observation_to_space
from ..utils.transform import (
    Pose, axis_angle_to_quat, frame_quat, quat_to_axis, quat_to_matrix,
)

CAMERA_W, CAMERA_H, CAMERA_FOVY = 640, 480, 1.0
VID_PART, VID_GRASP = 128, 129

# OpenCV-style camera from our x-forward/y-left/z-up convention
_CV_FROM_CAM = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def camera_intrinsic_matrix(w=CAMERA_W, h=CAMERA_H, fovy=CAMERA_FOVY) -> np.ndarray:
    fy = h / (2.0 * np.tan(fovy / 2.0))
    return np.array([[fy, 0, w / 2.0], [0, fy, h / 2.0], [0, 0, 1.0]])


def camera_extrinsic_matrix(cam_pose: Pose) -> np.ndarray:
    """4x4 world -> OpenCV-camera transform."""
    R_wc = quat_to_matrix(cam_pose.q).T         # world -> camera (x fwd)
    R = _CV_FROM_CAM @ R_wc
    t = -R @ cam_pose.p
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = t
    return out


class VecManipulationEnv:
    """Base batched env: Panda robot + one articulated object per env."""

    ACTION_DIM = 8  # 7 arm joints + 1 gripper width (reference action layout)

    def __init__(self, dataset_cfg: dict, task_cfg: dict, headless=True,
                 viewerless=False, logger=None, seed: int = 0):
        self.logger = logger or get_logger()
        self.dataset_cfg = dataset_cfg
        self.task_cfg = task_cfg
        self.num_envs = int(task_cfg["num_envs"])
        self.time_step = float(task_cfg.get("time_step", 0.005))
        self.max_step = int(task_cfg.get("max_step", 512))
        self.headless = headless
        self.viewerless = viewerless

        self._rng = np.random.default_rng(seed)
        # RGBMANIP_SIM_THREADS overrides the C++ pool's worker count
        # (default: hardware_concurrency - 2); used for production tuning
        # and the thread-scaling measurement (scripts/bench_sim_scaling.py)
        self.pool = SimPool(self.num_envs,
                            int(os.environ.get("RGBMANIP_SIM_THREADS", "0")))
        # per-phase wall-clock accounting (sim / plan / render), the
        # observability the reference lacks (SURVEY.md §5.1)
        self.timer = PhaseTimer()

        self._prepare_data(dataset_cfg, task_cfg)

        hc = task_cfg["robot_conf"]["hand_cam_pose"]
        self.hand_cam_pose = Pose(hc["xyz"], hc["rot"])

        # per-env bookkeeping
        self.robot_root_pose = [Pose() for _ in range(self.num_envs)]
        self.robot_art = [0] * self.num_envs
        self.obj_art = [1] * self.num_envs
        self.part_link = [1] * self.num_envs
        self.obj_meta = [None] * self.num_envs
        self.current_obj_config = [None] * self.num_envs
        self.current_robot_config = [None] * self.num_envs
        self.step_count = np.zeros(self.num_envs, dtype=np.int64)
        self.last_action = np.zeros((self.num_envs, self.ACTION_DIM), dtype=np.float32)
        self.total_move_distance = np.zeros(self.num_envs)
        self._last_action_pose = [None] * self.num_envs

        for e in range(self.num_envs):
            self.pool.seed(e, seed * 7919 + e)
            self._build_env(e)

        self.arm_q_lower, self.arm_q_higher = self.pool.get_qlimits(0, self.robot_art[0])

        # spaces
        obs = self.get_observation()
        self.observation_space = convert_observation_to_space(
            {k: v[0] for k, v in obs.items()})
        state = self.get_state()
        self.state_space = convert_observation_to_space(
            {k: v[0] for k, v in state.items()})
        self.action_space = Box(-1.0, 1.0, shape=(self.ACTION_DIM,))

    # ------------------------------------------------------------------
    # dataset / randomization (reference open_cabinet.py:24-127)
    # ------------------------------------------------------------------
    def _prepare_data(self, obj_cfg, task_cfg):
        self.obj_catalog = list(obj_cfg["objects"].values())
        self.dataset_root = obj_cfg.get("dataset_root", "")
        self.obj_category = obj_cfg.get("type", "object")
        rnd = task_cfg["object_conf"]["randomization"]
        self.obj_rand = {
            "rot": (rnd["rot"]["low"], rnd["rot"]["high"]),
            "pos_angle": (rnd["pos_angle"]["low"], rnd["pos_angle"]["high"]),
            "dis": (rnd["dis"]["low"], rnd["dis"]["high"]),
            "height": (rnd["height"]["low"], rnd["height"]["high"]),
            "dof": (np.asarray(rnd["dof"]["low"], float),
                    np.asarray(rnd["dof"]["high"], float)),
        }
        rr = task_cfg["robot_conf"]["randomization"]
        self.robot_rand = {
            "xyz": (np.asarray(rr["pose"]["xyz"]["low"], float),
                    np.asarray(rr["pose"]["xyz"]["high"], float)),
            "rot": (rr["rot"]["low"], rr["rot"]["high"]) if "rot" in rr else
                   (rr["pose"]["rot"]["low"], rr["pose"]["rot"]["high"]),
            "dof": (np.asarray(rr["dof"]["low"], float),
                    np.asarray(rr["dof"]["high"], float)),
        }
        self.obj_success_dof = np.asarray(task_cfg["object_conf"]["success_dof"], float)

    def _placement_offsets(self, meta) -> tuple:
        """Extra (dis, height) offsets from object extents (reference uses
        -bbox_min*0.75 — open_cabinet.py:66-69)."""
        return 0.75 * meta.half_depth, 0.75 * meta.half_height

    def _object_source(self, entry_or_cfg):
        """(spec, meta) from a dataset entry or a saved obj_config: either a
        procedural (category, seed) pair or a PartNet-style URDF entry with
        'path' (+ optional 'active_link'; default parsed from the entry name
        suffix, e.g. '44781_link_0' -> 'link_0' — the reference's convention,
        cfg/dataset/cabinet_train.yaml)."""
        if entry_or_cfg.get("path"):
            import os
            from ..assets.urdf_object import load_object_urdf
            path = entry_or_cfg["path"]
            if self.dataset_root and not os.path.isabs(path):
                path = os.path.join(self.dataset_root, path)
            active = entry_or_cfg.get("active_link")
            if not active:
                name = entry_or_cfg.get("name", "")
                if "_link_" in name:
                    active = "link_" + name.rsplit("_link_", 1)[1]
                else:
                    raise ValueError(
                        f"urdf dataset entry {name!r} needs active_link")
            return load_object_urdf(path, active, category=self.obj_category)
        return procedural.generate(entry_or_cfg["category"],
                                   entry_or_cfg["seed"])

    def _generate_object_config(self, e: int):
        entry = self.obj_catalog[self._rng.integers(len(self.obj_catalog))]
        spec, meta = self._object_source(entry)
        ang = self._rng.uniform(*self.obj_rand["pos_angle"])
        rot = self._rng.uniform(*self.obj_rand["rot"])
        d_off, h_off = self._placement_offsets(meta)
        dis = self._rng.uniform(*self.obj_rand["dis"]) + d_off
        height = self._rng.uniform(*self.obj_rand["height"]) + h_off
        # polar placement: r0 * p0 * r1 (reference open_cabinet.py:30-43)
        p1 = (Pose(q=axis_angle_to_quat([0, 0, 1], ang))
              * Pose([dis, 0, height])
              * Pose(q=axis_angle_to_quat([0, 0, 1], rot)))
        dof = self._rng.uniform(self.obj_rand["dof"][0], self.obj_rand["dof"][1])
        cfg = {
            "name": entry["name"],
            "dof": dof.tolist(),
            "pose_7d": p1.to_7d().tolist(),
        }
        if entry.get("path"):
            cfg["path"] = entry["path"]
            cfg["active_link"] = entry.get("active_link", meta.part_link)
        else:
            cfg["category"] = entry["category"]
            cfg["seed"] = int(entry["seed"])
        return cfg, spec, meta, p1, dof

    def _generate_robot_config(self, e: int):
        xyz = self._rng.uniform(self.robot_rand["xyz"][0], self.robot_rand["xyz"][1])
        rot = self._rng.uniform(*self.robot_rand["rot"])
        pose = Pose(xyz, axis_angle_to_quat([0, 0, 1], rot))
        dof = self._rng.uniform(self.robot_rand["dof"][0], self.robot_rand["dof"][1])
        return {"pose_7d": pose.to_7d().tolist(), "dof": dof.tolist()}, pose, dof

    def _build_env(self, e: int, obj_config=None, robot_config=None):
        """(Re)build the scene of env e: robot + randomized object."""
        self.pool.clear_env(e)
        self.pool.set_dt(e, self.time_step)

        if robot_config is None:
            robot_config, rpose, rdof = self._generate_robot_config(e)
        else:
            rpose = Pose.from_7d(np.asarray(robot_config["pose_7d"]))
            rdof = np.asarray(robot_config["dof"])
        rspec = panda.panda_spec()
        rart = self.pool.build_articulation(e, rspec, rpose.to_7d())
        hand = self.pool.link_index(e, rart, "panda_hand")
        self.pool.set_robot(e, rart, hand, panda.N_ARM)
        self.pool.set_qpos(e, rart, rdof)
        self.pool.set_drive_target(e, rart, rdof)
        self.robot_art[e] = rart
        self.robot_root_pose[e] = rpose
        self.current_robot_config[e] = robot_config

        if obj_config is None:
            obj_config, spec, meta, opose, odof = self._generate_object_config(e)
        else:
            spec, meta = self._object_source(obj_config)
            opose = Pose.from_7d(np.asarray(obj_config["pose_7d"]))
            odof = np.asarray(obj_config["dof"])
        oart = self.pool.build_articulation(e, spec, opose.to_7d())
        part = self.pool.link_index(e, oart, meta.part_link)
        if odof is not None:
            dof_full = np.full(self.pool.art_dof(e, oart), 0.0)
            dof_full[: len(np.atleast_1d(odof))] = np.atleast_1d(odof)
            self.pool.set_qpos(e, oart, dof_full)
        self.pool.set_grasp_config(e, oart, part, VID_GRASP)
        self.obj_art[e] = oart
        self.part_link[e] = part
        self.obj_meta[e] = meta
        self.current_obj_config[e] = obj_config

    # ------------------------------------------------------------------
    # poses (reference base_manipulation.py:605-646)
    # ------------------------------------------------------------------
    def _indices(self, indices):
        if indices is None:
            return list(range(self.num_envs))
        if isinstance(indices, (int, np.integer)):
            return [int(indices)]
        arr = np.asarray(indices)
        if arr.dtype == bool:
            return list(np.nonzero(arr)[0])
        return [int(i) for i in arr]

    def _mask_from(self, indices):
        if indices is None:
            return None
        m = np.zeros(self.num_envs, dtype=np.uint8)
        m[self._indices(indices)] = 1
        return m

    def hand_pose(self, robot_frame=False) -> np.ndarray:
        out = np.zeros((self.num_envs, 7))
        for e in range(self.num_envs):
            hp = self.pool.hand_pose(e)
            if robot_frame:
                hp = (self.robot_root_pose[e].inv() * Pose.from_7d(hp)).to_7d()
            out[e] = hp
        return out

    def gripper_pose(self, robot_frame=False) -> np.ndarray:
        hp = self.hand_pose(robot_frame)
        open_dir = quat_to_axis(hp[:, 3:], 2) * 0.105
        return np.concatenate([hp[:, :3] + open_dir, hp[:, 3:]], axis=-1)

    def camera_pose(self, robot_frame=False) -> np.ndarray:
        hp = self.hand_pose(robot_frame)
        out = np.zeros_like(hp)
        for e in range(self.num_envs):
            out[e] = (Pose.from_7d(hp[e]) * self.hand_cam_pose).to_7d()
        return out

    def robot_pose(self) -> np.ndarray:
        return np.stack([self.robot_root_pose[e].to_7d() for e in range(self.num_envs)])

    def robot_qpos(self) -> np.ndarray:
        return np.stack([self.pool.get_qpos(e, self.robot_art[e])
                         for e in range(self.num_envs)])

    def obj_dof(self) -> np.ndarray:
        return np.stack([self.pool.get_qpos(e, self.obj_art[e])
                         for e in range(self.num_envs)])

    def handle_bbox(self) -> np.ndarray:
        """GT 8-corner bbox of the graspable part, world frame, with the
        reference's corner ordering (open_cabinet.py:276-291)."""
        out = np.zeros((self.num_envs, 8, 3))
        for e in range(self.num_envs):
            mn, mx = self.pool.part_aabb(e, self.obj_art[e], self.part_link[e], VID_GRASP)
            if mn is None:
                continue
            corners = np.array([
                [mn[0], mn[1], mx[2]],
                [mn[0], mn[1], mn[2]],
                [mx[0], mn[1], mx[2]],
                [mx[0], mn[1], mn[2]],
                [mn[0], mx[1], mx[2]],
                [mn[0], mx[1], mn[2]],
                [mx[0], mx[1], mx[2]],
                [mx[0], mx[1], mn[2]],
            ])
            link7 = self.pool.link_pose(e, self.obj_art[e], self.part_link[e])
            out[e] = Pose(link7[:3], link7[3:]).transform_points(corners)
        return out

    def handle_pose(self) -> np.ndarray:
        """(N, 7) pose of the handle frame derived from the gt bbox
        (reference open_cabinet.py:146-178)."""
        bbox = self.handle_bbox()
        p = (bbox[:, 0] + bbox[:, 6]) / 2
        x = bbox[:, 1] - bbox[:, 0]
        y = bbox[:, 0] - bbox[:, 2]
        z = bbox[:, 4] - bbox[:, 0]
        def _n(v):
            return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)
        frames = np.stack([_n(x), _n(y), _n(z)], axis=1)
        qs = np.stack([frame_quat(np.eye(3), frames[e]) for e in range(self.num_envs)])
        return np.concatenate([p, qs], axis=-1)

    # ------------------------------------------------------------------
    # motion commands (reference base_manipulation.py:396-598)
    # ------------------------------------------------------------------
    def _move_to(self, poses, time, wait, planner, robot_frame, skip_move,
                 no_collision_with_front, indices=None):
        poses = np.asarray(poses, dtype=np.float64).reshape(self.num_envs, 7)
        idx = self._indices(indices)
        targets = np.zeros_like(poses)
        for e in idx:
            pw = Pose.from_7d(poses[e])
            if self._last_action_pose[e] is not None:
                self.total_move_distance[e] += np.linalg.norm(
                    self._last_action_pose[e].p - pw.p)
            self._last_action_pose[e] = pw
            targets[e] = poses[e] if robot_frame else \
                (self.robot_root_pose[e].inv() * pw).to_7d()
        run_steps = int(time / self.time_step)
        wait_steps = int(wait / self.time_step)
        mask = self._mask_from(idx)
        if planner == "ik":
            assert not skip_move, "IK cannot be skipped (reference parity)"
            with self.timer.phase("sim/ik_move"):
                succ = self.pool.exec_ik_move(targets, run_steps, wait_steps,
                                              mask=mask)
        elif planner == "path":
            with self.timer.phase("sim/path_move"):
                succ = self.pool.exec_path_move(
                    targets, use_wall=no_collision_with_front,
                    wait_steps=wait_steps, run_steps_fallback=run_steps,
                    teleport=skip_move, mask=mask)
        else:
            raise ValueError(f"planner {planner!r} not supported")
        self.step_count[idx] += run_steps + wait_steps
        return succ

    def hand_move_to(self, poses, time=2, wait=1, planner="ik", robot_frame=False,
                     skip_move=False, no_collision_with_front=True, indices=None):
        return self._move_to(poses, time, wait, planner, robot_frame, skip_move,
                             no_collision_with_front, indices)

    def cam_move_to(self, poses, time=1, wait=2, planner="ik", robot_frame=False,
                    skip_move=False, no_collision_with_front=True, indices=None):
        poses = np.asarray(poses, dtype=np.float64).reshape(self.num_envs, 7)
        hand_targets = np.zeros_like(poses)
        inv_cam = self.hand_cam_pose.inv()
        for e in range(self.num_envs):
            hand_targets[e] = (Pose.from_7d(poses[e]) * inv_cam).to_7d()
        return self._move_to(hand_targets, time, wait, planner, robot_frame,
                             skip_move, no_collision_with_front, indices)

    def gripper_move_to(self, poses, time=2, wait=1, planner="ik", robot_frame=False,
                        skip_move=False, no_collision_with_front=True, indices=None):
        poses = np.asarray(poses, dtype=np.float64).reshape(self.num_envs, 7)
        open_dir = quat_to_axis(poses[:, 3:], 2) * 0.105
        hand_targets = np.concatenate([poses[:, :3] - open_dir, poses[:, 3:]], axis=-1)
        return self._move_to(hand_targets, time, wait, planner, robot_frame,
                             skip_move, no_collision_with_front, indices)

    def toggle_gripper(self, open=True, indices=None):
        self.pool.gripper_toggle(open, steps=40, mask=self._mask_from(indices))
        idx = self._indices(indices)
        self.step_count[idx] += 40

    def _release_target(self, indices=None):
        self.pool.release_target(mask=self._mask_from(indices))

    # ------------------------------------------------------------------
    # step / reset / load
    # ------------------------------------------------------------------
    def step(self, actions, drive_mode="delta", quite=False, gt=False):
        actions = np.asarray(actions, dtype=np.float64).reshape(self.num_envs, -1)
        self.pool.step_all(actions, drive_mode=drive_mode, n_substeps=1)
        self.step_count += 1
        self.last_action = actions.astype(np.float32)
        done = self.get_done()
        if quite:
            return None, None, done, [{} for _ in range(self.num_envs)]
        obs = self.get_observation(gt=gt)
        rew = self.get_reward(actions)
        return obs, rew, done, [{} for _ in range(self.num_envs)]

    def reset(self, gt=False, indices=None):
        for e in self._indices(indices):
            self._build_env(e)
            self.step_count[e] = 0
            self.last_action[e] = 0
            self.total_move_distance[e] = 0.0
            self._last_action_pose[e] = None
        return self.get_observation(gt=gt)

    def load(self, cfgs, indices=None):
        """Restore exact robot/object configs (reference
        base_manipulation.py:841-848; used by baseline replay)."""
        idx = self._indices(indices)
        if isinstance(cfgs, dict):
            cfgs = [cfgs] * len(idx)
        for e, cfg in zip(idx, cfgs):
            self._build_env(e, obj_config=cfg["obj_config"],
                            robot_config=cfg["robot_config"])
            self.step_count[e] = 0
            self.last_action[e] = 0
            self.total_move_distance[e] = 0.0
            self._last_action_pose[e] = None
        return self.get_observation()

    def get_done(self):
        return self.step_count >= self.max_step

    def get_success(self):
        return np.zeros(self.num_envs, dtype=bool)

    def get_reward(self, actions):
        return np.zeros(self.num_envs)

    # ------------------------------------------------------------------
    # observations / images
    # ------------------------------------------------------------------
    def get_observation(self, gt=False):
        hand = self.hand_pose()
        grip = self.gripper_pose()
        handle = self.handle_pose()
        pose_diff = np.zeros((self.num_envs, 7))
        for e in range(self.num_envs):
            pose_diff[e] = (Pose.from_7d(grip[e]).inv() * Pose.from_7d(handle[e])).to_7d()
        obs = {
            "robot_qpos": self.robot_qpos().astype(np.float32),
            "hand_pose": hand.astype(np.float32),
            "gripper_pose": grip.astype(np.float32),
            "pose_difference": pose_diff.astype(np.float32),
            "last_action": self.last_action.copy(),
            "total_move_distance": self.total_move_distance.astype(np.float32),
        }
        return obs

    def get_state(self):
        state = dict(self.get_observation())
        state["obj_qpos"] = self.obj_dof().astype(np.float32)
        return state

    def get_image(self, mask="handle", indices=None):
        cams = self.camera_pose()
        with self.timer.phase("sim/render"):
            out = self.pool.render_all(cams, CAMERA_W, CAMERA_H, CAMERA_FOVY,
                                       mask=self._mask_from(indices))
        seg = out["Seg"]
        if mask == "handle":
            m = seg == VID_GRASP
        else:
            m = (seg == VID_PART) | (seg == VID_GRASP)
        K = camera_intrinsic_matrix()
        intr = np.tile(K, (self.num_envs, 1, 1))
        extr = np.stack([
            camera_extrinsic_matrix(Pose.from_7d(cams[e]))
            for e in range(self.num_envs)])
        return {"camera0": {
            "Color": out["Color"],
            "Position": out["Position"],
            "Depth": out["Depth"],
            "Norm": out["Norm"],
            "Mask": m,
            "Intrinsic": intr,
            "Extrinsic": extr,
        }}

    # ------------------------------------------------------------------
    # misc surface compat
    # ------------------------------------------------------------------
    def class_method(self, name, *args, indices=None, **kwargs):
        fn = getattr(self, name)
        try:
            return fn(*args, indices=indices, **kwargs)
        except TypeError:
            return fn(*args, **kwargs)

    def get_attr(self, name):
        return getattr(self, name)

    def set_attr(self, name, value):
        setattr(self, name, value)

    def grasped(self):
        return np.array([self.pool.grasped(e) for e in range(self.num_envs)])

    def close(self):
        self.pool = None


class OpenCabinetEnv(VecManipulationEnv):
    """Cabinet/drawer tasks (reference env/sapien_envs/open_cabinet.py)."""

    def get_success(self):
        return (self.obj_dof()[:, 0] > self.obj_success_dof[0])

    def get_observation(self, gt=False):
        obs = super().get_observation()
        if gt:
            obs["handle_bbox"] = self.handle_bbox().astype(np.float32)
        obs["success"] = self.get_success().astype(np.float32)
        obs["object_dof"] = self.obj_dof().astype(np.float32)
        return obs

    def get_reward(self, actions):
        """Dense reward: near + direction alignment + open·(dist<0.1)
        (reference open_cabinet.py:224-252)."""
        open_reward = self.obj_dof()[:, 0]
        grip = self.gripper_pose()
        bbox = self.handle_bbox()
        handle_p = (bbox[:, 0] + bbox[:, 6]) / 2
        dist = np.linalg.norm(grip[:, :3] - handle_p, axis=-1)
        near = 1.0 / (1.0 + dist ** 2) + (dist < 0.1)
        handle = self.handle_pose()
        eff_x = quat_to_axis(grip[:, 3:], 0)
        eff_z = quat_to_axis(grip[:, 3:], 2)
        h_x = quat_to_axis(handle[:, 3:], 0)
        h_z = quat_to_axis(handle[:, 3:], 2)
        dir_reward = ((eff_x * h_z).sum(-1) + (eff_z * -h_x).sum(-1)) * 0.1
        return near + dir_reward + open_reward * (dist < 0.1)

class OpenPotEnv(VecManipulationEnv):
    """Pot/mug tasks (reference env/sapien_envs/open_pot.py): flat +0.3
    placement offsets, whole lid/mug graspable, no direction reward term."""

    def _placement_offsets(self, meta):
        return 0.3, 0.3

    def get_success(self):
        return (self.obj_dof()[:, 0] > self.obj_success_dof[0])

    def get_observation(self, gt=False):
        obs = super().get_observation()
        if gt:
            obs["handle_bbox"] = self.handle_bbox().astype(np.float32)
        obs["success"] = self.get_success().astype(np.float32)
        obs["object_dof"] = self.obj_dof().astype(np.float32)
        return obs

    def get_reward(self, actions):
        open_reward = self.obj_dof()[:, 0]
        grip = self.gripper_pose()
        bbox = self.handle_bbox()
        handle_p = (bbox[:, 0] + bbox[:, 6]) / 2
        dist = np.linalg.norm(grip[:, :3] - handle_p, axis=-1)
        near = 1.0 / (1.0 + dist ** 2) + (dist < 0.1)
        return near + open_reward * (dist < 0.1)


class CloseCabinetEnv(OpenCabinetEnv):
    """Close variants: success when the dof drops below the threshold and
    reward uses -dof (reference env/sapien_envs/close_cabinet.py:23-80)."""

    def get_success(self):
        return (self.obj_dof()[:, 0] < self.obj_success_dof[0])

    def get_reward(self, actions):
        close_reward = -self.obj_dof()[:, 0]
        grip = self.gripper_pose()
        bbox = self.handle_bbox()
        handle_p = (bbox[:, 0] + bbox[:, 6]) / 2
        dist = np.linalg.norm(grip[:, :3] - handle_p, axis=-1)
        near = 1.0 / (1.0 + dist ** 2) + (dist < 0.1)
        return near + close_reward * (dist < 0.1)
