"""SimPool: batched Python facade over the C++ simcore.

One pool owns N environments stepped/planned/rendered in parallel by the C++
thread pool. This (plus ``envs.vec_env``) replaces the reference's
process-per-env ``MultiVecEnv`` pipe-RPC runtime (``env/my_vec_env.py``):
instead of pickling images through pipes, observations land in numpy buffers
shared with C++, and whole trajectories execute native-side per call.
"""

from __future__ import annotations

import ctypes as C
from typing import Dict, List, Optional

import numpy as np

from .bindings import dptr, fptr, get_lib, i32ptr, u8ptr
from ..assets.spec import ArticulationSpec


def _d(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


class SimPool:
    def __init__(self, n_envs: int, n_threads: int = 0):
        self.lib = get_lib()
        self.n_envs = n_envs
        self.handle = self.lib.sc_pool_create(n_envs, n_threads)
        self._link_names: List[Dict[int, Dict[str, int]]] = [dict() for _ in range(n_envs)]

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.sc_pool_destroy(self.handle)
                self.handle = None
        except Exception:
            pass

    # --- building ---
    def clear_env(self, env: int):
        self.lib.sc_env_clear(self.handle, env)
        self._link_names[env] = {}

    def seed(self, env: int, seed: int):
        self.lib.sc_env_seed(self.handle, env, C.c_uint64(seed))

    def set_dt(self, env: int, dt: float):
        self.lib.sc_env_set_dt(self.handle, env, dt)

    def build_articulation(self, env: int, spec: ArticulationSpec, root7) -> int:
        art = self.lib.sc_art_create(self.handle, env, dptr(_d(root7)))
        names: Dict[str, int] = {}
        for i, l in enumerate(spec.links):
            idx = self.lib.sc_art_add_link(
                self.handle, env, art, l.parent, l.joint_type,
                dptr(_d(l.origin)), dptr(_d(l.axis)),
                l.lo, l.hi, l.stiffness, l.damping, l.friction, l.armature)
            assert idx == i
            names[l.name] = idx
            for s in l.shapes:
                if getattr(s, "mesh", -1) >= 0:
                    self.lib.sc_link_add_mesh(
                        self.handle, env, art, idx, s.mesh,
                        dptr(_d(s.local)), dptr(_d(s.color)), s.visual_id,
                        1 if s.collide else 0)
                else:
                    self.lib.sc_link_add_shape(
                        self.handle, env, art, idx, s.kind, dptr(_d(s.params)),
                        dptr(_d(s.local)), dptr(_d(s.color)), s.visual_id,
                        1 if s.collide else 0)
        self.lib.sc_art_finish(self.handle, env, art)
        self._link_names[env][art] = names
        return art

    def link_index(self, env: int, art: int, name: str) -> int:
        return self._link_names[env][art][name]

    def set_robot(self, env: int, art: int, ee_link: int, n_arm: int = 7):
        self.lib.sc_set_robot(self.handle, env, art, ee_link, n_arm)

    def set_grasp_config(self, env: int, obj_art: int, part_link: int,
                         grasp_vid: int = 129, max_aperture: float = -1,
                         slip_dist: float = -1, slip_steps: int = -1):
        self.lib.sc_set_grasp_config(self.handle, env, obj_art, part_link,
                                     grasp_vid, max_aperture, slip_dist, slip_steps)

    # --- per-env state ---
    def art_dof(self, env: int, art: int) -> int:
        return self.lib.sc_art_dof(self.handle, env, art)

    def get_qpos(self, env: int, art: int) -> np.ndarray:
        out = np.zeros(self.art_dof(env, art))
        self.lib.sc_art_get_qpos(self.handle, env, art, dptr(out))
        return out

    def set_qpos(self, env: int, art: int, q):
        self.lib.sc_art_set_qpos(self.handle, env, art, dptr(_d(q)))

    def get_qvel(self, env: int, art: int) -> np.ndarray:
        out = np.zeros(self.art_dof(env, art))
        self.lib.sc_art_get_qvel(self.handle, env, art, dptr(out))
        return out

    def get_qlimits(self, env: int, art: int):
        n = self.art_dof(env, art)
        lo, hi = np.zeros(n), np.zeros(n)
        self.lib.sc_art_get_qlimits(self.handle, env, art, dptr(lo), dptr(hi))
        return lo, hi

    def set_root(self, env: int, art: int, root7):
        self.lib.sc_art_set_root(self.handle, env, art, dptr(_d(root7)))

    def set_drive_target(self, env: int, art: int, t):
        self.lib.sc_art_set_drive_target(self.handle, env, art, dptr(_d(t)))

    def get_drive_target(self, env: int, art: int) -> np.ndarray:
        out = np.zeros(self.art_dof(env, art))
        self.lib.sc_art_get_drive_target(self.handle, env, art, dptr(out))
        return out

    def link_pose(self, env: int, art: int, link: int) -> np.ndarray:
        out = np.zeros(7)
        self.lib.sc_art_get_link_pose(self.handle, env, art, link, dptr(out))
        return out

    def link_jacobian(self, env: int, art: int, link: int) -> np.ndarray:
        """Geometric Jacobian (6, dof) of the link frame origin — rows are
        (vx, vy, vz, wx, wy, wz); the Pinocchio get_link_jacobian
        replacement (reference impedance_control.py:28)."""
        dof = self.art_dof(env, art)
        out = np.zeros(6 * dof)
        self.lib.sc_link_jacobian(self.handle, env, art, link, dptr(out))
        return out.reshape(6, dof)

    def hand_pose(self, env: int) -> np.ndarray:
        out = np.zeros(7)
        self.lib.sc_get_hand_pose(self.handle, env, dptr(out))
        return out

    def part_aabb(self, env: int, art: int, link: int, vid: int = -1):
        mn, mx = np.zeros(3), np.zeros(3)
        ok = self.lib.sc_get_part_aabb(self.handle, env, art, link, vid, dptr(mn), dptr(mx))
        return (mn, mx) if ok else (None, None)

    def grasped(self, env: int) -> bool:
        return bool(self.lib.sc_get_grasped(self.handle, env))

    def release_grasp(self, env: int):
        self.lib.sc_release_grasp(self.handle, env)

    # --- batched ops (parallel in C++) ---
    def _mask(self, mask: Optional[np.ndarray]):
        if mask is None:
            return None, None
        m = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
        return m, u8ptr(m)

    def step_all(self, actions: np.ndarray, drive_mode: str = "delta",
                 n_substeps: int = 1, mask=None):
        a = _d(actions)
        assert a.shape[0] == self.n_envs
        _m, mp = self._mask(mask)
        self.lib.sc_step_all(self.handle, mp, dptr(a), a.shape[1],
                             0 if drive_mode == "delta" else 1, n_substeps)

    def exec_ik_move(self, targets7: np.ndarray, run_steps: int, wait_steps: int,
                     mask=None) -> np.ndarray:
        t = _d(targets7)
        succ = np.zeros(self.n_envs, dtype=np.uint8)
        _m, mp = self._mask(mask)
        self.lib.sc_exec_ik_move(self.handle, mp, dptr(t), run_steps, wait_steps,
                                 u8ptr(succ))
        return succ.astype(bool)

    def exec_path_move(self, targets7: np.ndarray, use_wall: bool, wait_steps: int,
                       run_steps_fallback: int, teleport: bool = False,
                       mask=None) -> np.ndarray:
        t = _d(targets7)
        succ = np.zeros(self.n_envs, dtype=np.uint8)
        _m, mp = self._mask(mask)
        self.lib.sc_exec_path_move(self.handle, mp, dptr(t), 1 if use_wall else 0,
                                   wait_steps, run_steps_fallback,
                                   1 if teleport else 0, u8ptr(succ))
        return succ.astype(bool)

    def gripper_toggle(self, open_: bool, steps: int = 40, mask=None):
        _m, mp = self._mask(mask)
        self.lib.sc_gripper_toggle(self.handle, mp, 1 if open_ else 0, steps)

    def release_target(self, mask=None):
        _m, mp = self._mask(mask)
        self.lib.sc_release_target(self.handle, mp)

    def ik(self, env: int, target7_robot_frame, q_init=None, max_iters: int = 200,
           damping: float = 0.08):
        q_out = np.zeros(7)
        qi = dptr(_d(q_init)) if q_init is not None else None
        ok = self.lib.sc_ik(self.handle, env, dptr(_d(target7_robot_frame)), qi,
                            dptr(q_out), max_iters, damping)
        return bool(ok), q_out

    def render_all(self, cam_poses7: np.ndarray, W: int, H: int, fovy: float = 1.0,
                   mask=None):
        n = self.n_envs
        rgb = np.zeros((n, H, W, 3), dtype=np.float32)
        depth = np.zeros((n, H, W), dtype=np.float32)
        pos = np.zeros((n, H, W, 3), dtype=np.float32)
        normal = np.zeros((n, H, W, 3), dtype=np.float32)
        seg = np.zeros((n, H, W), dtype=np.int32)
        _m, mp = self._mask(mask)
        self.lib.sc_render_all(self.handle, mp, dptr(_d(cam_poses7)), W, H, fovy,
                               fptr(rgb), fptr(depth), fptr(pos), fptr(normal),
                               i32ptr(seg))
        return {"Color": rgb, "Depth": depth, "Position": pos, "Norm": normal,
                "Seg": seg}
