"""Cartesian impedance torque controller (reference
env/sapien_envs/impedance_control.py:25-54).

Computes joint torques that pull the end-effector toward a target pose with
task-space stiffness/damping plus a nullspace term toward a rest
configuration:

    tau = J^T (-Kp_cart * e - Kd_cart * J dq)
        + (I - J^T pinv(J)^T) (Kp_null (q_rest - q) - 2 sqrt(Kp_null) dq)

The reference uses Pinocchio's link Jacobian; here the Jacobian comes from
the C++ simcore (``SimPool.link_jacobian``). Like the reference it is not in
the live manipulation path (the PD joint drives are, reference
base_manipulation.py:202-208 keeps it commented out) — it is provided for
real-robot torque control and API parity.
"""

from __future__ import annotations

import numpy as np


def quat_error_vec(q_cur, q_tgt):
    """Imaginary part of q_cur^-1 * q_tgt (wxyz) — the reference's
    (commented) orientation error term, sign-fixed to the shortest path."""
    w1, x1, y1, z1 = q_cur
    # conjugate of current
    w1, x1, y1, z1 = w1, -x1, -y1, -z1
    w2, x2, y2, z2 = q_tgt
    e = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return e if w >= 0 else -e


class ImpedanceController:
    """Reference-parity impedance law over the simcore kinematics.

    Args mirror the reference constructor: per-axis (or scalar) cartesian
    stiffness/damping, nullspace stiffness, pseudo-inverse damping, and a
    qmask selecting the arm dofs (fingers excluded).
    """

    def __init__(self, pool, env: int, robot_art: int, eff_link: int,
                 cartesian_stiffness=200.0, cartesian_damping=30.0,
                 nullspace_stiffness=10.0, damping=0.05,
                 qmask=None, use_orientation: bool = False):
        self.pool = pool
        self.env = env
        self.art = robot_art
        self.link = eff_link
        self.kp = np.asarray(cartesian_stiffness, dtype=np.float64)
        self.kd = np.asarray(cartesian_damping, dtype=np.float64)
        self.kn = float(nullspace_stiffness)
        self.damping = float(damping)
        dof = pool.art_dof(env, robot_art)
        self.qmask = (np.asarray(qmask, bool) if qmask is not None
                      else np.arange(dof) < 7)
        self.maskid = np.nonzero(self.qmask)[0]
        self.use_orientation = use_orientation

    def control_ik(self, target_pose7, start_dof_pos, dof_pos, dof_vel):
        """target_pose7: (7,) world pose (xyz + wxyz quat) of the effector;
        start_dof_pos: rest configuration for the nullspace term.
        Returns torques for the masked (arm) dofs, shape (n_arm,)."""
        n = len(self.maskid)
        J_full = self.pool.link_jacobian(self.env, self.art, self.link)
        J = J_full[:, self.maskid]                     # (6, n)
        cur = self.pool.link_pose(self.env, self.art, self.link)

        q = np.asarray(dof_pos, np.float64)[self.maskid]
        q_rest = np.asarray(start_dof_pos, np.float64)[self.maskid]
        dq = np.asarray(dof_vel, np.float64)[self.maskid]

        err = np.zeros(6)
        err[:3] = cur[:3] - np.asarray(target_pose7[:3])  # reference sign:
        # current - target, pushed through -Kp below (impedance_control.py:37)
        if self.use_orientation:
            err[3:] = -quat_error_vec(cur[3:], np.asarray(target_pose7[3:]))

        kp6 = np.broadcast_to(self.kp, (6,)) if self.kp.ndim == 0 else self.kp
        kd6 = np.broadcast_to(self.kd, (6,)) if self.kd.ndim == 0 else self.kd

        # damped pseudo-inverse (reference impedance_control.py:42-45)
        lam = np.eye(6) * self.damping ** 2
        pinv = np.linalg.inv(J @ J.T + lam) @ J        # (6, n)

        tau_task = J.T @ (-kp6 * err - kd6 * (J @ dq))
        tau_null = (np.eye(n) - J.T @ pinv) @ (
            self.kn * (q_rest - q) - 2.0 * np.sqrt(self.kn) * dq)
        return tau_task + tau_null
