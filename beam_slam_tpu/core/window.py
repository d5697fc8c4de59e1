"""Fixed-shape sliding-window state — the static-shape replacement for the
fuse variable store (``fuse_core::Graph`` / ``fuse_graphs::HashGraph``) and the
custom variables in bs_variables (see SURVEY.md §1 L1/§2.2).

Instead of UUID-addressed heap variables, state lives in capacity-``K``
structure-of-arrays with an ``active`` mask; the host keeps a stamp→slot map
(see :mod:`beam_slam_tpu.solver.smoother`). The tangent (local-parameterization)
layout per IMU state is 15-dof in the reference's error-state order
(bs_common/include/bs_common/preintegrator.h:13-20 — ES_Q, ES_P, ES_V, ES_BG,
ES_BA):

    [dθ(3), dp(3), dv(3), dbg(3), dba(3)]

Orientation retraction is right-multiplicative: ``q ⊞ dθ = q ⊗ exp(dθ)``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from beam_slam_tpu.core import struct

from beam_slam_tpu.core import lie

IMU_DOF = 15
POSE_DOF = 6
LANDMARK_DOF = 3
MOTION_DOF = 6


@struct.dataclass
class ImuStates:
    """Capacity-K SoA of stamped IMU states (q, p, v, bg, ba).

    Replaces ``bs_common::ImuState`` (bs_common/include/bs_common/imu_state.h:15)
    bundles of five fuse variables.
    """

    q: jnp.ndarray   # [K, 4] world-from-baselink orientation, wxyz
    p: jnp.ndarray   # [K, 3] position in world
    v: jnp.ndarray   # [K, 3] linear velocity in world
    bg: jnp.ndarray  # [K, 3] gyro bias
    ba: jnp.ndarray  # [K, 3] accel bias
    active: jnp.ndarray  # [K] bool — slot holds a live state
    held: jnp.ndarray    # [K] bool — fuse ``holdVariable``: frozen in the solve

    @property
    def capacity(self) -> int:
        return self.q.shape[0]

    @staticmethod
    def zeros(K: int, dtype=jnp.float32) -> "ImuStates":
        return ImuStates(
            q=lie.quat_identity((K,), dtype),
            p=jnp.zeros((K, 3), dtype),
            v=jnp.zeros((K, 3), dtype),
            bg=jnp.zeros((K, 3), dtype),
            ba=jnp.zeros((K, 3), dtype),
            active=jnp.zeros((K,), bool),
            held=jnp.zeros((K,), bool),
        )

    def retract(self, delta: jnp.ndarray) -> "ImuStates":
        """Apply tangent update. delta: [K, 15] in ES order."""
        dth, dp, dv, dbg, dba = (
            delta[..., 0:3], delta[..., 3:6], delta[..., 6:9],
            delta[..., 9:12], delta[..., 12:15],
        )
        return self.replace(
            q=lie.quat_normalize(lie.quat_mul(self.q, lie.so3_exp_quat(dth))),
            p=self.p + dp,
            v=self.v + dv,
            bg=self.bg + dbg,
            ba=self.ba + dba,
        )


@struct.dataclass
class Poses:
    """Capacity-N SoA of 6-dof poses (extrinsics — bs_variables
    Position3D/Orientation3D (position_3d.h, orientation_3d.h:25) — or submap
    poses in the global mapper). Tangent: [dθ(3), dp(3)]."""

    q: jnp.ndarray  # [N, 4]
    p: jnp.ndarray  # [N, 3]
    active: jnp.ndarray  # [N]
    held: jnp.ndarray    # [N]

    @property
    def capacity(self) -> int:
        return self.q.shape[0]

    @staticmethod
    def zeros(N: int, dtype=jnp.float32) -> "Poses":
        return Poses(
            q=lie.quat_identity((N,), dtype),
            p=jnp.zeros((N, 3), dtype),
            active=jnp.zeros((N,), bool),
            held=jnp.zeros((N,), bool),
        )

    def retract(self, delta: jnp.ndarray) -> "Poses":
        dth, dp = delta[..., 0:3], delta[..., 3:6]
        return self.replace(
            q=lie.quat_normalize(lie.quat_mul(self.q, lie.so3_exp_quat(dth))),
            p=self.p + dp,
        )


@struct.dataclass
class Landmarks:
    """Capacity-L Euclidean visual landmarks (bs_variables
    point_3d_landmark.h). Tangent: [dx, dy, dz]."""

    pt: jnp.ndarray      # [L, 3] world position
    active: jnp.ndarray  # [L]
    held: jnp.ndarray    # [L]

    @property
    def capacity(self) -> int:
        return self.pt.shape[0]

    @staticmethod
    def zeros(L: int, dtype=jnp.float32) -> "Landmarks":
        return Landmarks(
            pt=jnp.zeros((L, 3), dtype),
            active=jnp.zeros((L,), bool),
            held=jnp.zeros((L,), bool),
        )

    def retract(self, delta: jnp.ndarray) -> "Landmarks":
        return self.replace(pt=self.pt + delta)


@struct.dataclass
class MotionStates:
    """Capacity-M SoA of kinematic auxiliary states for the full Unicycle3D
    motion model: body-frame angular velocity ω and linear acceleration a.

    The reference's unicycle carries these as separate fuse variables
    (VelocityAngular3DStamped / AccelerationLinear3DStamped — 5 blocks per
    pose, bs_constraints/motion/unicycle_3d_state_cost_functor.h). Our IMU
    states hold neither, so the full-state kinematic factor references one
    MotionStates slot per pose. Tangent: [dω(3), da(3)] (plain addition)."""

    w: jnp.ndarray   # [M, 3] angular velocity, body frame
    a: jnp.ndarray   # [M, 3] linear acceleration, body frame
    active: jnp.ndarray  # [M]
    held: jnp.ndarray    # [M]

    @property
    def capacity(self) -> int:
        return self.w.shape[0]

    @staticmethod
    def zeros(M: int, dtype=jnp.float32) -> "MotionStates":
        return MotionStates(
            w=jnp.zeros((M, 3), dtype),
            a=jnp.zeros((M, 3), dtype),
            active=jnp.zeros((M,), bool),
            held=jnp.zeros((M,), bool),
        )

    def retract(self, delta: jnp.ndarray) -> "MotionStates":
        return self.replace(w=self.w + delta[..., 0:3],
                            a=self.a + delta[..., 3:6])


@struct.dataclass
class WindowState:
    """Full optimizable state of one fixed-lag window: IMU states +
    extrinsics + kinematic aux states (+ landmarks, Schur-eliminated in the
    solver). Dense dof layout: [imu K·15 | extrinsics E·6 | motion M·6]."""

    imu: ImuStates
    extrinsics: Poses
    landmarks: Landmarks
    motion: MotionStates

    @staticmethod
    def zeros(K: int, E: int = 1, L: int = 0, M: int = 1,
              dtype=jnp.float32) -> "WindowState":
        return WindowState(
            imu=ImuStates.zeros(K, dtype),
            extrinsics=Poses.zeros(E, dtype),
            landmarks=Landmarks.zeros(max(L, 1), dtype),
            motion=MotionStates.zeros(max(M, 1), dtype),
        )

    # ---- dense dof layout (landmarks excluded: Schur-eliminated) ----
    @property
    def num_dense_dof(self) -> int:
        return (self.imu.capacity * IMU_DOF
                + self.extrinsics.capacity * POSE_DOF
                + self.motion.capacity * MOTION_DOF)

    def imu_dof_offset(self) -> int:
        return 0

    def extrinsic_dof_offset(self) -> int:
        return self.imu.capacity * IMU_DOF

    def motion_dof_offset(self) -> int:
        return (self.imu.capacity * IMU_DOF
                + self.extrinsics.capacity * POSE_DOF)

    def retract_dense(self, delta: jnp.ndarray) -> "WindowState":
        """delta: [num_dense_dof] → updated window (landmarks untouched)."""
        K, E = self.imu.capacity, self.extrinsics.capacity
        M = self.motion.capacity
        o_ext = K * IMU_DOF
        o_mot = o_ext + E * POSE_DOF
        d_imu = delta[:o_ext].reshape(K, IMU_DOF)
        d_ext = delta[o_ext:o_mot].reshape(E, POSE_DOF)
        d_mot = delta[o_mot:o_mot + M * MOTION_DOF].reshape(M, MOTION_DOF)
        return self.replace(
            imu=self.imu.retract(d_imu),
            extrinsics=self.extrinsics.retract(d_ext),
            motion=self.motion.retract(d_mot),
        )

    def dense_free_mask(self) -> jnp.ndarray:
        """[num_dense_dof] bool — dof that are free to move (active & !held)."""
        imu_free = jnp.repeat(self.imu.active & ~self.imu.held, IMU_DOF)
        ext_free = jnp.repeat(self.extrinsics.active & ~self.extrinsics.held, POSE_DOF)
        mot_free = jnp.repeat(self.motion.active & ~self.motion.held, MOTION_DOF)
        return jnp.concatenate([imu_free, ext_free, mot_free])


def gather_imu(states: ImuStates, idx: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """Gather (q,p,v,bg,ba) rows at ``idx``; idx may be any shape."""
    return (states.q[idx], states.p[idx], states.v[idx],
            states.bg[idx], states.ba[idx])
