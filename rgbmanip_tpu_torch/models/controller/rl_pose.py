"""RL camera-scheduling controller (counterpart of
``rgbmanip_tpu/models/controller/rl_pose.py``; reference
models/controller/rl_pose.py).

``ControlInterface`` adapts the vec env into a gym-like env whose "actions"
are camera poses: per policy step the wrist camera plans and moves (eval) to
the commanded viewpoint, a view is appended to the multi-view queue, the
pose estimator runs on the last two valid views, and a 14-term shaped reward
scores the estimate against ground truth (rl_pose.py:225-358).
``RLPoseController`` runs the PPO actor (``algo/ppo.py``) on it and fuses
the per-step estimates with ``consensus_fuse``, or trains the actor on it
(``train_controller``: teleported camera moves, ``step(eval=False)``).

The env's ``PhaseTimer`` records the evaluation's split: ``policy`` (the
actor), ``estimate`` (the estimator, host-to-device copies included),
``skill`` (the scripted manipulation) beside the env's own ``sim/*`` phases;
training adds ``learn`` (GAE and the update).
"""

from __future__ import annotations

import os

import numpy as np

from .base_controller import BaseController
from .gt_pose import bbox_to_center_axes
from ..pose_estimator.groundtruth_estimator import GroundTruthPoseEstimator
from ...envs.vec_env import CAMERA_H, CAMERA_W
from ...utils.tools import Box
from ...utils.transform import lookat_quat, quat_to_axis


def consensus_fuse(pred_bbox, cur_step, cluster_tol=0.06, stereo_ok=None):
    """Robust temporal fusion of the per-step bbox estimates.

    Deviation from the reference (rl_pose.py:491-516), which acts on the
    LAST estimate only: the scene is static while the camera schedules
    views, so every per-step estimate predicts the SAME part bbox and the
    per-step errors differ systematically (the policy's late close-in view
    pairs are the worst — measured 3.1/4.1/8.6 cm at steps 2/3/4,
    docs/RESULTS.md). Per env: pick the medoid of the non-sentinel per-step
    centers (the estimate in best agreement with the others), then average
    the estimates within ``cluster_tol`` of it. Falls back to the last
    estimate (reference behavior) when fewer than 3 steps are usable. Uses
    no ground truth and no per-k tuning.

    ``stereo_ok`` (M, N bool, optional) marks which per-step estimates came
    from a genuine two-view pair. Estimates made while only ONE valid view
    existed (the lone view is duplicated into both stereo slots,
    ``get_estimation``) are quasi-monocular and systematically worse; at
    k=3 a quasi-mono step-1 estimate pairing with step-2 can outvote the
    better step-3 stereo estimate (measured 87.50 -> 76.92, docs/RESULTS.md
    r4). With ``stereo_ok`` given, only stereo estimates are CANDIDATES for
    the vote; if fewer than 3 remain the fallback is the last estimate.

    Cluster membership additionally requires open-direction agreement with
    the medoid (corners 0/1 define the direction the manipulation acts
    along downstream): two estimates whose centers agree but whose corner
    orderings disagree must not average into a degenerate direction.

    pred_bbox: (M, N, 8, 3) per-step estimate queue (steps 1..cur_step
    written by ``ControlInterface.add_bbox``). Returns (N, 8, 3).
    """
    pred_bbox = np.asarray(pred_bbox)
    N = pred_bbox.shape[1]
    out = pred_bbox[cur_step].copy()
    for j in range(N):
        steps, centers, dirs, voters = [], [], [], []
        for t in range(1, cur_step + 1):
            c = (pred_bbox[t, j, 0] + pred_bbox[t, j, 7]) / 2
            if np.linalg.norm(c) >= 5.0:  # sentinel bbox sits at ~+10
                continue
            d = pred_bbox[t, j, 1] - pred_bbox[t, j, 0]
            steps.append(t)
            centers.append(c)
            dirs.append(d / (np.linalg.norm(d) + 1e-9))
            voters.append(stereo_ok is None or bool(stereo_ok[t, j]))
        nv = int(np.sum(voters))
        if nv < 3:
            # Too few stereo candidates for a vote. If gating left ANY
            # usable stereo estimate, act on the LATEST one (recency, like
            # the reference, but never a gated degenerate-pair estimate —
            # falling back to the raw last estimate would act on exactly
            # the near-zero-baseline estimate the gate excluded); with no
            # usable candidate at all, keep the reference behavior (raw
            # last estimate).
            if stereo_ok is not None and nv >= 1:
                out[j] = pred_bbox[[s for s, v in zip(steps, voters) if v][-1], j]
            continue
        # medoid vote runs over STEREO candidates only (a degenerate-pair
        # estimate must not steer the vote), but gated estimates may still
        # JOIN the averaged cluster when they agree with the stereo medoid
        # — agreement with independent stereo consensus is itself evidence
        C = np.stack(centers)
        n = len(steps)
        vi = np.nonzero(voters)[0]
        D = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
        Dv = D[np.ix_(vi, vi)]
        off = ~np.eye(len(vi), dtype=bool)
        med = np.array([np.median(Dv[i][off[i]]) for i in range(len(vi))])
        best = int(vi[np.argmin(med - 1e-9 * np.arange(len(vi)))])  # tie -> later
        agree = np.stack(dirs) @ dirs[best] > 0.0
        keep = np.nonzero((D[best] <= cluster_tol) & agree)[0]
        out[j] = pred_bbox[[steps[i] for i in keep], j].mean(axis=0)
    return out


class ControlInterface:
    """(reference rl_pose.py:14-462)"""

    def __init__(self, vec_env, pose_estimator, manipulation, cfg: dict):
        self.env = vec_env
        self.estimator = pose_estimator
        self.manipulation = manipulation
        self.num_envs = vec_env.num_envs
        ctrl = cfg["controller"]["controller"] if "controller" in cfg["controller"] \
            else cfg["controller"]
        self.max_steps = int(ctrl["max_steps"]) + 1
        self.action_type = ctrl.get("action_type", "pose")
        self.pose_min = np.asarray(ctrl["pose_min"], np.float64)
        self.pose_max = np.asarray(ctrl["pose_max"], np.float64)
        self.pose_mid = (self.pose_min + self.pose_max) / 2
        self.cfg = cfg
        self.reward_cfg = cfg["controller"]["reward"]
        self.task_name = cfg.get("task", {}).get("name", "")

        self.action_space = Box(-1.5, 1.5, shape=(7 + self.max_steps,))
        self.state_space = Box(-1.5, 1.5, shape=(self.max_steps * 15,))
        self.observation_space = Box(-1.5, 1.5, shape=(self.max_steps * 12,))

        # Fusion mode for the final estimate (and the training success
        # probe, so PPO's success reward optimizes the SAME decision rule
        # applied at eval): CLI override lands at the group top level,
        # yaml nests it under the inner 'controller:' dict — CLI wins.
        self.estimate_fusion = str(
            cfg["controller"].get("estimate_fusion",
                                  ctrl.get("estimate_fusion", "consensus")))

        self.last_pose_target = None
        self.proper_pos = np.asarray([[0.0, 0.0, 0.9]])
        self.proper_ori = np.asarray([[1.0, 0.0, -0.2]])
        self.last_done = np.zeros(self.num_envs, bool)
        self.obj_saved_num = {}
        self.save_path = "saves/third_stage"
        self.save_views = False  # set True to dump eval views (ref _save_data)

        self.reset_queue()
        self.reset_robot()

    # ------------------------------------------------------------------
    def reset_queue(self):
        M, N = self.max_steps, self.num_envs
        self.image_queue = np.zeros((M, N, CAMERA_H, CAMERA_W, 3), np.float32)
        self.mask_queue = np.zeros((M, N, CAMERA_H, CAMERA_W), bool)
        self.bbox_queue = np.zeros((M, N, 4), np.float32)
        self.pose_queue = np.zeros((M, N, 7), np.float32)
        self.intrinsic_queue = np.zeros((M, N, 3, 3), np.float32)
        self.extrinsic_queue = np.zeros((M, N, 4, 4), np.float32)
        self.available = np.zeros((M, N), np.float32)
        self.pred_bbox = np.zeros((M, N, 8, 3), np.float32)
        self.gt_bbox = np.zeros((M, N, 8, 3), np.float32)
        self.available_num = np.zeros(N, np.int32)
        self.pair_dist = np.zeros((M, N), np.float32)   # view-pair baseline
        self.last_pair_dist = np.full(N, 1e3, np.float32)
        self.accumulate_steps = 0

    def reset_robot(self):
        """Initial view from a canonical pose (reference rl_pose.py:99-116)."""
        pos = np.array([self.pose_min[0], 0.0,
                        (self.pose_min[2] + self.pose_max[2]) / 2])
        ori = lookat_quat(self.proper_ori[0])
        pose = np.tile(np.concatenate([pos, ori]), (self.num_envs, 1))
        self.env.cam_move_to(pose, time=2, wait=1, planner="path",
                             robot_frame=True, skip_move=True)
        image = self.env.get_image()
        self.add_view(image, self.env.camera_pose(robot_frame=True))
        self.accumulate_steps += 1

    def add_view(self, image, cam_pose):
        """(reference rl_pose.py:118-150): store view + normalized 2-D mask bbox."""
        t = self.accumulate_steps % self.max_steps
        cam = image["camera0"]
        self.image_queue[t] = cam["Color"]
        self.mask_queue[t] = cam["Mask"]
        self.pose_queue[t] = cam_pose
        self.intrinsic_queue[t] = cam["Intrinsic"]
        self.extrinsic_queue[t] = cam["Extrinsic"]
        for i in range(self.num_envs):
            ys, xs = np.nonzero(cam["Mask"][i])
            if len(ys):
                self.available[t, i] = 1
                self.available_num[i] += 1
                self.bbox_queue[t, i] = [ys.min() / CAMERA_H, xs.min() / CAMERA_W,
                                         ys.max() / CAMERA_H, xs.max() / CAMERA_W]
            else:
                self.available[t, i] = 0
                self.bbox_queue[t, i] = [2.0, 2.0, 0.0, 0.0]

    def add_bbox(self, pred_bbox, gt_bbox):
        t = self.accumulate_steps % self.max_steps
        self.pred_bbox[t] = pred_bbox
        self.gt_bbox[t] = gt_bbox
        self.pair_dist[t] = self.last_pair_dist

    def stereo_ok(self):
        """(M, N) bool: which per-step estimates came from a REAL stereo
        pair — at least two valid views existed AND the pair's camera
        centers are separated by a usable baseline. The RL policy's final
        step often barely moves the camera (measured 1.6 cm median pair
        distance at step 4, scripts/diag_flagship.py r5): such a pair
        carries no triangulation signal and the estimate degrades to
        quasi-monocular regression (31.9 cm median error for the
        augmentation-trained estimator), so it must not be a fusion vote
        candidate. 4 cm threshold: well above the degenerate step-4 pairs
        (~1.6 cm) and far below genuine policy baselines (~40-60 cm)."""
        return (np.cumsum(self.available, axis=0) >= 2) & \
            (self.pair_dist >= 0.04)

    # ------------------------------------------------------------------
    def get_observation(self):
        """pose+bbox queues + one-hot time (reference rl_pose.py:173-187)."""
        cur = np.concatenate([self.pose_queue, self.bbox_queue], axis=-1)  # (M,N,11)
        flat = cur.transpose(1, 0, 2).reshape(self.num_envs, -1)
        onehot = np.zeros((self.num_envs, self.max_steps), np.float32)
        onehot[:, (self.accumulate_steps - 1) % self.max_steps] = 1
        return np.concatenate([flat, onehot], axis=-1).astype(np.float32)

    def get_state(self):
        """obs + gt handle centers (reference rl_pose.py:158-171)."""
        handle_pos = (self.gt_bbox[:, :, 0] + self.gt_bbox[:, :, 6]) / 2
        cur = np.concatenate([self.pose_queue, self.bbox_queue, handle_pos], axis=-1)
        flat = cur.transpose(1, 0, 2).reshape(self.num_envs, -1)
        onehot = np.zeros((self.num_envs, self.max_steps), np.float32)
        onehot[:, (self.accumulate_steps - 1) % self.max_steps] = 1
        return np.concatenate([flat, onehot], axis=-1).astype(np.float32)

    def get_estimation(self):
        """Estimate from the last two valid views (reference rl_pose.py:189-223).

        Deviation: the reference reorders mug bboxes ``[0,2,4,6,1,3,5,7]``
        (rl_pose.py:220-221) because its externally-trained mug AdaPose
        checkpoint emits a different corner convention. Our in-framework
        estimators are trained on env-convention corner labels, so their
        output already matches the ``(0, 7)`` center read downstream — no
        reorder (verified: heuristic+AdaPose mug succeeds where the
        reference heuristic row is 0/0).
        """
        if isinstance(self.estimator, GroundTruthPoseEstimator):
            return np.asarray(self.estimator.estimate())
        N = self.num_envs
        intr = np.zeros((2, N, 3, 3), np.float32)
        extr = np.zeros((2, N, 4, 4), np.float32)
        rgb = np.zeros((2, N, CAMERA_H, CAMERA_W, 3), np.float32)
        msk = np.zeros((2, N, CAMERA_H, CAMERA_W), bool)
        used = np.zeros(N, np.int32)
        for i in range(self.max_steps):
            for j in range(N):
                if self.available[i, j]:
                    s = used[j] % 2
                    intr[s, j] = self.intrinsic_queue[i, j]
                    extr[s, j] = self.extrinsic_queue[i, j]
                    rgb[s, j] = self.image_queue[i, j]
                    msk[s, j] = self.mask_queue[i, j]
                    used[j] += 1
        # A single valid view is DUPLICATED into both stereo slots — the
        # reference's first/second_view_idx both clip to the same index at
        # available_num==1 (rl_pose.py:59-60), so its estimator sees a
        # zero-baseline pair and regresses quasi-monocularly (its k=1
        # ViewNum row is 71.1%, not a sentinel failure). Pairing the lone
        # view with a zeros image instead poisons the estimate.
        for j in range(N):
            if used[j] == 1:
                intr[1, j] = intr[0, j]
                extr[1, j] = extr[0, j]
                rgb[1, j] = rgb[0, j]
                msk[1, j] = msk[0, j]
        # record the pair's stereo baseline (camera-center separation) for
        # fusion candidate gating (stereo_ok); duplicated pairs read 0
        c0 = -np.einsum("nij,ni->nj", extr[0, :, :3, :3], extr[0, :, :3, 3])
        c1 = -np.einsum("nij,ni->nj", extr[1, :, :3, :3], extr[1, :, :3, 3])
        self.last_pair_dist = np.linalg.norm(c0 - c1, axis=-1).astype(np.float32)
        return np.asarray(self.estimator.estimate(
            intr[0], rgb[0], msk[0], extr[0], rgb[1], msk[1], extr[1]))

    # ------------------------------------------------------------------
    def get_reward(self, action, move_res, view_weight, success):
        """14 coefficient-weighted terms (reference rl_pose.py:225-358)."""
        R = self.reward_cfg
        N = self.num_envs
        t = self.accumulate_steps

        view_norm = np.linalg.norm(view_weight, axis=-1, keepdims=True)
        view_norm_penalty = np.clip((view_norm[:, 0] - 1) ** 2, -1, 1)

        cam_pose = self.env.camera_pose(robot_frame=True)
        ori = quat_to_axis(cam_pose[:, 3:], 0)

        move_success, move_period_raw = move_res
        move_success = np.asarray(move_success, np.float32)

        if self.action_type == "pose":
            diff = np.clip(np.linalg.norm(cam_pose - self.last_pose_target, axis=-1), -2, 2)
        else:
            diff = np.zeros(N)
        far_diff = np.clip(np.linalg.norm(cam_pose[:, :3] - self.proper_pos, axis=-1), -2, 2)
        far_rew = far_diff.copy()

        last_bbox = self.bbox_queue[t % self.max_steps]
        bbox_dist = np.linalg.norm(
            (last_bbox[:, :2] + last_bbox[:, 2:]) / 2 - np.array([[0.5, 0.5]]), axis=-1)
        bbox_penalty = np.clip(bbox_dist * self.available[t % self.max_steps], -1, 1)
        bbox_boundary_penalty = (
            (last_bbox[:, 0] <= 1e-9).astype(np.float32)
            + (last_bbox[:, 1] <= 1e-9) + (last_bbox[:, 2] >= 1 - 1e-9)
            + (last_bbox[:, 3] >= 1 - 1e-9) > 0).astype(np.float32)
        have_bbox_rew = self.available[t % self.max_steps].copy()

        gt_center = (self.gt_bbox[t, :, 0] + self.gt_bbox[t, :, 6]) / 2
        gt_open_dir = self.gt_bbox[t, :, 0] - self.gt_bbox[t, :, 4]
        gt_open_dir /= np.linalg.norm(gt_open_dir, axis=-1, keepdims=True) + 1e-9
        pred_center = (self.pred_bbox[t, :, 0] + self.pred_bbox[t, :, 7]) / 2
        pred_open_dir = self.pred_bbox[t, :, 1] - self.pred_bbox[t, :, 0]
        pred_open_dir /= np.linalg.norm(pred_open_dir, axis=-1, keepdims=True) + 1e-9

        task_name = getattr(self.estimator, "cfg", {}).get("task_name", "")
        if task_name in ("pots", "pot"):
            center_diff_v = pred_center - gt_center
            center_diff_v = center_diff_v.copy()
            center_diff_v[:, :2] *= 3
            center_diff = np.clip(np.linalg.norm(center_diff_v, axis=-1), -20.0, 20.0)
        else:
            center_diff = np.clip(np.linalg.norm(pred_center - gt_center, axis=-1), -20.0, 20.0)
        open_diff = np.clip(np.linalg.norm(pred_open_dir - gt_open_dir, axis=-1) * 2, -20.0, 20.0)
        precision = 0.1 if task_name in ("mugs", "mug") else 0.2
        center_rew = precision ** 2 / (precision ** 2 + center_diff ** 2)
        open_rew = 1 / (1 + open_diff ** 2)

        robot_root = self.env.robot_pose()[:, :3]
        tar_ori = gt_center - (robot_root + self.pose_queue[t, :, 0:3])
        tar_ori /= np.linalg.norm(tar_ori, axis=-1, keepdims=True) + 1e-9
        ori_rew = (ori * tar_ori).sum(-1)

        if self.action_type == "pose":
            xyz_lookat = np.clip(
                (np.linalg.norm(action[:, 3:6] - action[:, :3], axis=-1) - 1) ** 2, -2, 2)
        else:
            xyz_lookat = np.zeros(N)

        last_view_dir = self.pose_queue[t - 1, :, :3] - (gt_center - robot_root)
        last_view_dir /= np.linalg.norm(last_view_dir, axis=-1, keepdims=True) + 1e-9
        this_view_dir = self.pose_queue[t, :, :3] - (gt_center - robot_root)
        this_view_dir /= np.linalg.norm(this_view_dir, axis=-1, keepdims=True) + 1e-9
        move_period = np.linalg.norm(
            self.pose_queue[t - 1, :, :3] - self.pose_queue[t, :, :3], axis=-1)

        view_rew = np.zeros(N)
        if t > 0:
            ang = np.arccos(np.clip((last_view_dir * this_view_dir).sum(-1), -1, 1))
            view_rew = np.where(ang > 0.3, 1.0, 0.0)
        else:
            center_rew *= 0
            open_rew *= 0

        terms = {
            "diff": diff * R["diff_coef"],
            "move_success": move_success * R["move_success_coef"],
            "move_period": move_period * R["move_period_coef"],
            "far": far_rew * R["far_coef"],
            "ori_rew": ori_rew * R["ori_coef"],
            "xyz_lookat": xyz_lookat * R["xyz_lookat_coef"],
            "bbox_penalty": bbox_penalty * R["bbox_coef"],
            "bbox_boundary_penalty": bbox_boundary_penalty * R["bbox_boundary_coef"],
            "have_bbox": have_bbox_rew * R["have_bbox_coef"],
            "center_rew": center_rew * R["center_coef"],
            "open_rew": open_rew * R["open_coef"],
            "view_rew": view_rew * R["view_coef"],
            "view_norm_penalty": view_norm_penalty * R["view_norm_coef"],
            "success": success * R["success_coef"],
        }
        reward = sum(terms.values())
        info = {f"REW:{k}": v for k, v in terms.items()}
        info["LOSS:center_diff"] = center_diff
        info["LOSS:open_diff"] = open_diff
        info["LOSS:far"] = far_diff
        return reward.astype(np.float32), info

    def get_done(self):
        return np.full(self.num_envs, self.max_steps <= self.accumulate_steps, bool)

    def get_success(self):
        return self.env.get_success()

    def call_manipulation(self, estimation, eval=False):
        center, direction = bbox_to_center_axes(np.asarray(estimation), (0, 7))
        with self.env.timer.phase("skill"):
            self.manipulation.plan_pathway(center, direction, eval)

    # ------------------------------------------------------------------
    def step(self, action, eval=False):
        """(reference rl_pose.py:380-453)"""
        if self.last_done.any():
            self.reset()
        action = np.asarray(action, np.float64)
        weight = action[:, 6:6 + self.max_steps]

        xyz = action[:, :3]
        dy, dz = action[:, 3], action[:, 4]
        heading = np.zeros((self.num_envs, 3))
        heading[:, 0] = 1
        z_ = np.zeros((self.num_envs, 3))
        z_[:, 2] = 1
        lookat_y = np.cross(z_, heading)
        ori = lookat_quat(heading + lookat_y * dy[:, None] + z_ * dz[:, None])
        xyz = np.clip(xyz + self.pose_mid, self.pose_min, self.pose_max)
        env_action = np.concatenate([xyz, ori], axis=1)
        self.last_pose_target = env_action
        no_collision = self.task_name in ("cabinet", "drawer")
        move_success = self.env.cam_move_to(
            env_action, time=2, wait=0.5, planner="path", robot_frame=True,
            skip_move=not eval, no_collision_with_front=no_collision)
        move_res = (move_success, np.ones(self.num_envs))

        image = self.env.get_image()
        self.add_view(image, self.env.camera_pose(robot_frame=True))

        with self.env.timer.phase("estimate"):
            pred_bbox = self.get_estimation()
        gt_bbox = self.env.get_observation(gt=True)["handle_bbox"]
        self.add_bbox(pred_bbox, gt_bbox)
        obs = self.get_observation()

        success = np.zeros(self.num_envs)
        if (self.accumulate_steps == self.max_steps - 1
                and self.reward_cfg["success_coef"] > 1e-9 and not eval):
            # Act on the same fused estimate eval acts on (stereo-only
            # candidates), so the success reward scores the deployed
            # decision rule rather than the raw last estimate.
            probe_est = pred_bbox
            if self.estimate_fusion == "consensus":
                probe_est = consensus_fuse(
                    self.pred_bbox, self.accumulate_steps,
                    stereo_ok=self.stereo_ok())
            self.call_manipulation(probe_est, eval=True)
            success = np.asarray(self.env.get_observation(gt=True)["success"]).reshape(-1)

        reward, info = self.get_reward(action, move_res, weight, success)
        self.accumulate_steps += 1
        if self.accumulate_steps == self.max_steps - 1 and eval and self.save_views:
            self._save_data()
        done = self.get_done()
        self.last_done = done
        return obs, reward, done, info

    def reset(self, indices=None, reset_env=True):
        if reset_env:
            self.env.reset(indices=indices)
        self.reset_queue()
        self.reset_robot()
        self.last_done = np.zeros(self.num_envs, bool)
        return self.get_observation()

    def _save_data(self):
        """Dump eval multi-view data (reference rl_pose.py:56-83)."""
        os.makedirs(self.save_path, exist_ok=True)
        configs = self.env.get_attr("current_obj_config")
        id1 = np.clip(self.available_num - 1, 0, None)
        id2 = np.clip(self.available_num - 2, 0, None)
        for i, obj_cfg in enumerate(configs):
            obj = obj_cfg["name"]
            self.obj_saved_num[obj] = self.obj_saved_num.get(obj, 0) + 1
            root = os.path.join(self.save_path, obj, str(self.obj_saved_num[obj]))
            os.makedirs(root, exist_ok=True)
            np.savez_compressed(os.path.join(root, "views.npz"),
                                intrinsic=self.intrinsic_queue[id1[i], i],
                                rgb1=self.image_queue[id1[i], i],
                                rgb2=self.image_queue[id2[i], i],
                                mask1=self.mask_queue[id1[i], i],
                                mask2=self.mask_queue[id2[i], i],
                                extrinsic1=self.extrinsic_queue[id1[i], i],
                                extrinsic2=self.extrinsic_queue[id2[i], i],
                                gt_bbox=self.gt_bbox[-1, i])


class RLPoseController(BaseController):
    """(reference rl_pose.py:464-516) The camera-scheduling policy and its
    PPO trainer (``algo/ppo.py``) on ``device`` (the card unless the caller
    asks for the CPU): a fresh policy drawn from ``cfg.seed``, or the one in
    ``controller.load``. ``run`` evaluates (the actor's mean action per
    step, then the fused estimate to the skill); ``train_controller`` trains
    on the control interface."""

    def __init__(self, env, pose_estimator, manipulation, ctrl_cfg, cfg, logger,
                 writer=None, device=None):
        super().__init__(env, pose_estimator, manipulation, ctrl_cfg, logger)
        from ...algo.ppo import PPO
        iface_cfg = {"controller": ctrl_cfg, "task": cfg.get("task", {})}
        self.control_interface = ControlInterface(env, pose_estimator, manipulation,
                                                  iface_cfg)
        self.controller = PPO(self.control_interface, ctrl_cfg, writer=writer,
                              seed=cfg.get("seed", 0), device=device)
        if ctrl_cfg.get("load"):
            self.controller.load(ctrl_cfg["load"])

    def train_controller(self, steps, log_interval=1, save_interval=None):
        self.logger.info("Training controller model...")
        self.controller.run(steps, log_interval, save_interval)

    def learn(self, steps, *args, **kwargs):
        return self.train_controller(steps)

    def save(self, path):
        self.controller.save(path)

    def load(self, path):
        self.controller.load(path)

    def run(self, eval=False):
        iface = self.control_interface
        current_obs = iface.reset(reset_env=False)
        cur_step = 0
        # self.cfg IS the controller group dict (BaseController stores
        # ctrl_cfg); the reference reads cfg['controller']['early_stop']
        # from the root cfg (rl_pose.py:491). The shipped yaml nests the
        # knob under the group's inner 'controller:' dict while the CLI
        # override 'controller.early_stop=k' lands at the group top level
        # — honor both, CLI winning.
        ctrl = self.cfg["controller"] if isinstance(self.cfg.get("controller"), dict) \
            else self.cfg
        max_step = int(self.cfg.get("early_stop", ctrl.get("early_stop", 4)))
        while True:
            cur_step += 1
            with self.env.timer.phase("policy"):
                actions = self.controller.act_inference(current_obs)
            next_obs, rews, dones, infos = iface.step(actions, eval=True)
            current_obs = next_obs
            if dones.any() or cur_step >= max_step:
                break
        fusion = str(self.cfg.get("estimate_fusion",
                                  ctrl.get("estimate_fusion", "consensus")))
        if fusion == "consensus":
            estimation = consensus_fuse(iface.pred_bbox, cur_step,
                                        stereo_ok=iface.stereo_ok())
        else:  # "last" = reference behavior (rl_pose.py:491-516)
            estimation = iface.pred_bbox[cur_step]
        iface.call_manipulation(estimation, eval)
