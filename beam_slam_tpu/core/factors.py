"""Batched factor families — the batched replacement for bs_constraints
(Ceres cost functors, SURVEY.md §2.3) and ``fuse_core::Constraint``.

Each family is a fixed-capacity structure-of-arrays pytree: ``F`` factor slots
with per-factor parameters, int32 block-slot indices into the window state, and
an ``active`` mask. Linearization is generic: each family defines a pure
per-factor residual over *retracted* block states; the whitened Jacobian is
obtained with ``jax.jacfwd`` w.r.t. the stacked tangent perturbation and
``vmap``-ed over the factor axis. This matches the reference's pattern of
autodiff Ceres functors (e.g. normal_delta_imu_state_3d_cost_functor.h:18-141)
while producing batched dense blocks ready for scatter-assembly into the
normal equations (see :mod:`beam_slam_tpu.solver.gauss_newton`).

Residual whitening (sqrt-information) is applied *inside* the residual, exactly
as the reference applies ``A_`` inside each functor.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
from beam_slam_tpu.core import struct

from beam_slam_tpu.core import lie
from beam_slam_tpu.ops import smallmat as sm
from beam_slam_tpu.core.window import (IMU_DOF, LANDMARK_DOF, MOTION_DOF,
                                       POSE_DOF, WindowState)

# Gravity in the world frame, matching bs_common/include/bs_common/utils.h:20-24
# (GRAVITY_WORLD = [0, 0, -9.80665]).
GRAVITY_NOMINAL = 9.80665
GRAVITY_WORLD = jnp.asarray([0.0, 0.0, -GRAVITY_NOMINAL])

# Block kinds a factor can reference.
BLOCK_IMU = "imu"            # 15-dof ImuStates slot
BLOCK_EXTRINSIC = "extrinsic"  # 6-dof Poses slot
BLOCK_LANDMARK = "landmark"    # 3-dof Landmarks slot
BLOCK_MOTION = "motion"        # 6-dof MotionStates slot (ω, a)

_BLOCK_DOF = {BLOCK_IMU: IMU_DOF, BLOCK_EXTRINSIC: POSE_DOF,
              BLOCK_LANDMARK: LANDMARK_DOF, BLOCK_MOTION: MOTION_DOF}


def block_dof(kind: str) -> int:
    return _BLOCK_DOF[kind]


def analytic_jacobians_enabled() -> bool:
    """Analytic (closed-form) Jacobians for the hot visual families. On by
    default; BEAM_SLAM_ANALYTIC_JAC=0 falls back to jacfwd everywhere (the
    oracle path the tests compare against). Read at trace time."""
    import os
    return os.environ.get("BEAM_SLAM_ANALYTIC_JAC", "1") != "0"


def _gather_block(window: WindowState, kind: str, idx: jnp.ndarray):
    if kind == BLOCK_IMU:
        s = window.imu
        return (s.q[idx], s.p[idx], s.v[idx], s.bg[idx], s.ba[idx])
    if kind == BLOCK_EXTRINSIC:
        s = window.extrinsics
        return (s.q[idx], s.p[idx])
    if kind == BLOCK_LANDMARK:
        return (window.landmarks.pt[idx],)
    if kind == BLOCK_MOTION:
        s = window.motion
        return (s.w[idx], s.a[idx])
    raise ValueError(kind)


def _block_active(window: WindowState, kind: str, idx: jnp.ndarray):
    if kind == BLOCK_IMU:
        return window.imu.active[idx]
    if kind == BLOCK_EXTRINSIC:
        return window.extrinsics.active[idx]
    if kind == BLOCK_LANDMARK:
        return window.landmarks.active[idx]
    if kind == BLOCK_MOTION:
        return window.motion.active[idx]
    raise ValueError(kind)


def _retract_block(kind: str, state, d):
    if kind == BLOCK_IMU:
        q, p, v, bg, ba = state
        return (lie.quat_mul(q, lie.so3_exp_quat(d[0:3])), p + d[3:6],
                v + d[6:9], bg + d[9:12], ba + d[12:15])
    if kind == BLOCK_EXTRINSIC:
        q, p = state
        return (lie.quat_mul(q, lie.so3_exp_quat(d[0:3])), p + d[3:6])
    if kind == BLOCK_LANDMARK:
        return (state[0] + d,)
    if kind == BLOCK_MOTION:
        w, a = state
        return (w + d[0:3], a + d[3:6])
    raise ValueError(kind)


class FactorBatch(struct.PyTreeNode):
    """Base class: subclasses set class attrs BLOCKS (tuple of kinds) and
    RESIDUAL_DIM, carry ``slots`` [F, len(BLOCKS)] int32 and ``active`` [F]
    bool, and implement ``residual(block_states, params) -> [RESIDUAL_DIM]``
    for a single factor."""

    slots: jnp.ndarray
    active: jnp.ndarray

    # Plain class attributes (NOT annotated — annotations would turn them into
    # dataclass fields under core.struct's dataclass transform).
    BLOCKS = ()  # type: Tuple[str, ...]
    RESIDUAL_DIM = 0
    # Local tangent columns the residual can actually depend on (None = all).
    # Families whose residual reads only part of a block's state (e.g.
    # reprojection touches the pose 6-dof of a 15-dof IMU block, never
    # v/bg/ba) declare the live columns so jacfwd pushes only those tangents;
    # the remaining Jacobian columns are structural zeros and are re-expanded
    # with one tiny constant matmul after differentiation. Cuts the
    # forward-mode tangent fan-out of the hot visual families by ~40-50%
    # (the per-factor residual math is small elementwise work, a large
    # share of each linearization).
    USED_COLS = None  # type: Optional[Tuple[int, ...]]
    # Subclasses with a closed-form Jacobian set this and implement
    # ``residual_and_jacobian_used`` (residual + Jacobian over USED_COLS).
    HAS_ANALYTIC = False

    @property
    def capacity(self) -> int:
        return self.slots.shape[0]

    # -- subclass API ------------------------------------------------------
    def params(self) -> Any:
        """Pytree of per-factor parameter arrays (leading dim F)."""
        raise NotImplementedError

    def residual(self, block_states: Sequence[Tuple[jnp.ndarray, ...]],
                 params_one: Any) -> jnp.ndarray:
        raise NotImplementedError

    def residual_and_jacobian_used(self, block_states, params_one):
        """Closed-form (residual [R], Jacobian [R, len(USED_COLS)]) for one
        factor. Only called when HAS_ANALYTIC is True."""
        raise NotImplementedError

    # -- generic machinery -------------------------------------------------
    def local_dof(self) -> int:
        return sum(block_dof(k) for k in type(self).BLOCKS)

    def _split_delta(self, delta: jnp.ndarray):
        out, o = [], 0
        for k in type(self).BLOCKS:
            d = block_dof(k)
            out.append(delta[o:o + d])
            o += d
        return out

    def residual_only(self, window: WindowState) -> jnp.ndarray:
        """Masked whitened residuals [F, R] without Jacobians (for LM trial
        cost evaluation)."""
        cls = type(self)
        gathered = tuple(
            _gather_block(window, k, self.slots[:, b])
            for b, k in enumerate(cls.BLOCKS)
        )
        r = jax.vmap(self.residual)(gathered, self.params())
        mask = self.active
        for b, k in enumerate(cls.BLOCKS):
            mask = mask & _block_active(window, k, self.slots[:, b])
        return r * mask.astype(r.dtype)[:, None]

    def has_landmark(self) -> bool:
        """True if this family touches a landmark block. Convention: at most
        ONE landmark block per family, and it must be the LAST block (all
        reprojection-style factors satisfy this) — it is Schur-eliminated by
        the solver, never part of the dense system."""
        blocks = type(self).BLOCKS
        assert BLOCK_LANDMARK not in blocks[:-1], \
            "landmark block must be last"
        return bool(blocks) and blocks[-1] == BLOCK_LANDMARK

    def linearize(self, window: WindowState):
        """Returns (r [F,R], J [F,R,Dd], col_idx [F,Dd], mask [F],
        lm_slot [F] | None, J_lm [F,R,3] | None).

        r and J are whitened and pre-masked (zeroed for inactive factors /
        blocks), so scatter-adds of masked entries are no-ops. col_idx maps
        the *dense* local tangent columns (IMU/extrinsic blocks) to global
        dense dof; the landmark block's Jacobian (if any) is returned
        separately for Schur elimination.
        """
        cls = type(self)
        blocks = cls.BLOCKS
        F = self.capacity
        Dl = self.local_dof()
        dtype = window.imu.q.dtype
        with_lm = self.has_landmark()

        gathered = tuple(
            _gather_block(window, k, self.slots[:, b])
            for b, k in enumerate(blocks)
        )

        used = cls.USED_COLS
        if used is not None:
            import numpy as np
            expand_np = np.zeros((len(used), Dl), np.float64)
            expand_np[np.arange(len(used)), list(used)] = 1.0
            expand = jnp.asarray(expand_np, dtype)  # [Du, Dl] constant
        else:
            expand = None

        params = self.params()
        if cls.HAS_ANALYTIC and analytic_jacobians_enabled():
            # Closed-form chain-rule Jacobian over the used columns: one
            # residual evaluation + a handful of 2x3/3x3 products instead of
            # len(used) forward tangents pushed through the quaternion math.
            # Equivalence vs jacfwd is asserted in
            # tests/test_solver.py::test_analytic_jacobians_match_autodiff.
            r, J = jax.vmap(self.residual_and_jacobian_used)(gathered, params)
        else:
            def res_one(delta, gathered_one, params_one):
                if expand is not None:
                    delta = delta @ expand
                deltas = self._split_delta(delta)
                retr = [
                    _retract_block(k, g, d)
                    for k, g, d in zip(blocks, gathered_one, deltas)
                ]
                return self.residual(retr, params_one)

            zeros = jnp.zeros(
                (F, len(used) if used is not None else Dl), dtype)
            r = jax.vmap(res_one)(zeros, gathered, params)
            J = jax.vmap(jax.jacfwd(res_one, argnums=0))(
                zeros, gathered, params)
        if expand is not None:
            # re-expand the reduced Jacobian to the full local width; the
            # dropped columns are exact (structural) zeros
            J = jnp.einsum("fru,ud->frd", J, expand)

        mask = self.active
        for b, k in enumerate(blocks):
            mask = mask & _block_active(window, k, self.slots[:, b])
        m = mask.astype(dtype)
        r = r * m[:, None]
        J = J * m[:, None, None]

        # Split off the landmark block columns (always the trailing 3).
        if with_lm:
            J_lm = J[:, :, Dl - LANDMARK_DOF:]
            J = J[:, :, : Dl - LANDMARK_DOF]
            lm_slot = self.slots[:, len(blocks) - 1]
            dense_blocks = blocks[:-1]
        else:
            J_lm, lm_slot = None, None
            dense_blocks = blocks

        # Global dense column indices for the dense blocks.
        cols = []
        K_imu = window.imu.capacity
        E_ext = window.extrinsics.capacity
        for b, k in enumerate(dense_blocks):
            d = block_dof(k)
            if k == BLOCK_IMU:
                base = self.slots[:, b] * IMU_DOF
            elif k == BLOCK_MOTION:
                base = (K_imu * IMU_DOF + E_ext * POSE_DOF
                        + self.slots[:, b] * MOTION_DOF)
            else:  # BLOCK_EXTRINSIC
                base = K_imu * IMU_DOF + self.slots[:, b] * POSE_DOF
            cols.append(base[:, None] + jnp.arange(d, dtype=jnp.int32)[None, :])
        col_idx = jnp.concatenate(cols, axis=1) if cols else \
            jnp.zeros((F, 0), jnp.int32)
        return r, J, col_idx, mask, lm_slot, J_lm


# ---------------------------------------------------------------------------
# IMU factors
# ---------------------------------------------------------------------------


class ImuRelativeFactors(FactorBatch):
    """15-dof preintegrated IMU factor between states i and j.

    Residual math mirrors bs_constraints/inertial/
    normal_delta_imu_state_3d_cost_functor.h:97-138 (RSS'15 / VINS-style with
    first-order bias correction through the stored preintegration Jacobians;
    residual order q,p,v,bg,ba; whitened by info_weight * sqrt_inv_cov).
    """

    dt: jnp.ndarray        # [F]
    dq: jnp.ndarray        # [F, 4] preintegrated orientation delta
    dp: jnp.ndarray        # [F, 3]
    dv: jnp.ndarray        # [F, 3]
    bg_lin: jnp.ndarray    # [F, 3] gyro bias linearization point (state i)
    ba_lin: jnp.ndarray    # [F, 3]
    dq_dbg: jnp.ndarray    # [F, 3, 3]
    dp_dbg: jnp.ndarray    # [F, 3, 3]
    dp_dba: jnp.ndarray    # [F, 3, 3]
    dv_dbg: jnp.ndarray    # [F, 3, 3]
    dv_dba: jnp.ndarray    # [F, 3, 3]
    sqrt_info: jnp.ndarray  # [F, 15, 15] info_weight * sqrt_inv_cov

    BLOCKS = (BLOCK_IMU, BLOCK_IMU)
    RESIDUAL_DIM = 15

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "ImuRelativeFactors":
        return ImuRelativeFactors(
            slots=jnp.zeros((F, 2), jnp.int32),
            active=jnp.zeros((F,), bool),
            dt=jnp.zeros((F,), dtype),
            dq=lie.quat_identity((F,), dtype),
            dp=jnp.zeros((F, 3), dtype),
            dv=jnp.zeros((F, 3), dtype),
            bg_lin=jnp.zeros((F, 3), dtype),
            ba_lin=jnp.zeros((F, 3), dtype),
            dq_dbg=jnp.zeros((F, 3, 3), dtype),
            dp_dbg=jnp.zeros((F, 3, 3), dtype),
            dp_dba=jnp.zeros((F, 3, 3), dtype),
            dv_dbg=jnp.zeros((F, 3, 3), dtype),
            dv_dba=jnp.zeros((F, 3, 3), dtype),
            sqrt_info=jnp.zeros((F, 15, 15), dtype),
        )

    def params(self):
        return (self.dt, self.dq, self.dp, self.dv, self.bg_lin, self.ba_lin,
                self.dq_dbg, self.dp_dbg, self.dp_dba, self.dv_dbg,
                self.dv_dba, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q_i, p_i, v_i, bg_i, ba_i), (q_j, p_j, v_j, bg_j, ba_j) = block_states
        (dt, dq, dp, dv, bg_lin, ba_lin, dq_dbg, dp_dbg, dp_dba, dv_dbg,
         dv_dba, A) = params_one
        G = GRAVITY_WORLD.astype(q_i.dtype)

        dbg = bg_i - bg_lin
        dba = ba_i - ba_lin
        q_corr = lie.quat_mul(dq, lie.delta_q(dq_dbg @ dbg))
        p_corr = dp + dp_dbg @ dbg + dp_dba @ dba
        v_corr = dv + dv_dbg @ dbg + dv_dba @ dba

        q_ij = lie.quat_mul(lie.quat_conj(q_i), q_j)
        res_q = 2.0 * lie.quat_mul(lie.quat_conj(q_corr), q_ij)[1:4]
        res_p = lie.quat_rotate(
            lie.quat_conj(q_i), p_j - p_i - dt * v_i - 0.5 * dt * dt * G
        ) - p_corr
        res_v = lie.quat_rotate(lie.quat_conj(q_i), v_j - v_i - dt * G) - v_corr
        res = jnp.concatenate([res_q, res_p, res_v, bg_j - bg_i, ba_j - ba_i])
        return A @ res


class ImuPriorFactors(FactorBatch):
    """15-dof prior on a full IMU state. Mirrors bs_constraints/inertial/
    normal_prior_imu_state_3d_cost_functor.h:60-95 (orientation residual is
    the SO(3) log of b_q⁻¹ ⊗ q; the rest are plain differences; whitened)."""

    q0: jnp.ndarray   # [F, 4]
    p0: jnp.ndarray   # [F, 3]
    v0: jnp.ndarray   # [F, 3]
    bg0: jnp.ndarray  # [F, 3]
    ba0: jnp.ndarray  # [F, 3]
    sqrt_info: jnp.ndarray  # [F, 15, 15]

    BLOCKS = (BLOCK_IMU,)
    RESIDUAL_DIM = 15

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "ImuPriorFactors":
        return ImuPriorFactors(
            slots=jnp.zeros((F, 1), jnp.int32),
            active=jnp.zeros((F,), bool),
            q0=lie.quat_identity((F,), dtype),
            p0=jnp.zeros((F, 3), dtype),
            v0=jnp.zeros((F, 3), dtype),
            bg0=jnp.zeros((F, 3), dtype),
            ba0=jnp.zeros((F, 3), dtype),
            sqrt_info=jnp.zeros((F, 15, 15), dtype),
        )

    def params(self):
        return (self.q0, self.p0, self.v0, self.bg0, self.ba0, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q, p, v, bg, ba), = block_states
        q0, p0, v0, bg0, ba0, A = params_one
        res_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
        res = jnp.concatenate([res_q, p - p0, v - v0, bg - bg0, ba - ba0])
        return A @ res


# ---------------------------------------------------------------------------
# Pose factors
# ---------------------------------------------------------------------------


class RelativePoseFactors(FactorBatch):
    """6-dof relative-pose factor between baselink states i and j, with the
    measurement expressed in a (shared, optimizable) sensor frame via an
    extrinsic block — the batched equivalent of bs_constraints/relative_pose/
    delta_pose_3d_with_extrinsics_cost_functor.h:19-109 (used by lidar
    odometry and submap refinement).

    Predicted sensor-frame delta: T_S1_S2 = (T_W_B1 · T_B_S)⁻¹ (T_W_B2 · T_B_S).
    Residual: [log(q_meas⁻¹ ⊗ q_pred), p_pred - p_meas], whitened.
    """

    dq: jnp.ndarray        # [F, 4] measured delta orientation (sensor frame)
    dp: jnp.ndarray        # [F, 3] measured delta translation
    sqrt_info: jnp.ndarray  # [F, 6, 6]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU, BLOCK_EXTRINSIC)
    RESIDUAL_DIM = 6
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20, 30, 31, 32, 33, 34, 35)

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "RelativePoseFactors":
        return RelativePoseFactors(
            slots=jnp.zeros((F, 3), jnp.int32),
            active=jnp.zeros((F,), bool),
            dq=lie.quat_identity((F,), dtype),
            dp=jnp.zeros((F, 3), dtype),
            sqrt_info=jnp.zeros((F, 6, 6), dtype),
        )

    def params(self):
        return (self.dq, self.dp, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q_i, p_i, *_), (q_j, p_j, *_), (q_e, p_e) = block_states
        dq, dp, A = params_one
        # T_S1_S2 = (T_WB1 T_BS)^-1 (T_WB2 T_BS)
        q_ws1 = lie.quat_mul(q_i, q_e)
        q_ws2 = lie.quat_mul(q_j, q_e)
        p_ws1 = p_i + lie.quat_rotate(q_i, p_e)
        p_ws2 = p_j + lie.quat_rotate(q_j, p_e)
        q_pred = lie.quat_mul(lie.quat_conj(q_ws1), q_ws2)
        p_pred = lie.quat_rotate(lie.quat_conj(q_ws1), p_ws2 - p_ws1)
        res_q = lie.so3_log(lie.quat_mul(lie.quat_conj(dq), q_pred))
        return A @ jnp.concatenate([res_q, p_pred - dp])


class AbsolutePoseFactors(FactorBatch):
    """6-dof prior on the pose part of an IMU state (fuse
    AbsolutePose3DStampedConstraint equivalent; also the per-scan prior of
    scan_registration_base and the window-start pose prior)."""

    q0: jnp.ndarray  # [F, 4]
    p0: jnp.ndarray  # [F, 3]
    sqrt_info: jnp.ndarray  # [F, 6, 6]

    BLOCKS = (BLOCK_IMU,)
    RESIDUAL_DIM = 6
    USED_COLS = (0, 1, 2, 3, 4, 5)

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "AbsolutePoseFactors":
        return AbsolutePoseFactors(
            slots=jnp.zeros((F, 1), jnp.int32),
            active=jnp.zeros((F,), bool),
            q0=lie.quat_identity((F,), dtype),
            p0=jnp.zeros((F, 3), dtype),
            sqrt_info=jnp.zeros((F, 6, 6), dtype),
        )

    def params(self):
        return (self.q0, self.p0, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q, p, *_), = block_states
        q0, p0, A = params_one
        res_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
        return A @ jnp.concatenate([res_q, p - p0])


MARGINAL_MAX_BLOCKS = 8


class MarginalPriorFactors(FactorBatch):
    """Dense linear marginal factor over up to MARGINAL_MAX_BLOCKS IMU
    states — the product of *exact* marginalization
    (fuse_constraints::marginalizeVariables, used by the reference smoother
    when pseudo_marginalization is off, fixed_lag_smoother.cpp:269-272).
    Eight blocks cover the connectivity produced by marginalizing a window
    step (stale states + the fresh frames coupled through their eliminated
    landmarks); wider connectivity falls back to pseudo-marginalization.

    Residual: r(x) = A · d(x) + b, where d stacks the 15-dof tangents of each
    block at its stored linearization point:
        d_i = [log(q̄ᵢ⁻¹ qᵢ), pᵢ − p̄ᵢ, vᵢ − v̄ᵢ, bgᵢ − b̄gᵢ, baᵢ − b̄aᵢ].
    Unused trailing blocks are inert (their A columns are zero and their slot
    points at block 0).
    """

    q_lin: jnp.ndarray   # [F, M, 4]
    p_lin: jnp.ndarray   # [F, M, 3]
    v_lin: jnp.ndarray   # [F, M, 3]
    bg_lin: jnp.ndarray  # [F, M, 3]
    ba_lin: jnp.ndarray  # [F, M, 3]
    A: jnp.ndarray       # [F, M*15, M*15]
    b: jnp.ndarray       # [F, M*15]

    BLOCKS = (BLOCK_IMU,) * MARGINAL_MAX_BLOCKS
    RESIDUAL_DIM = MARGINAL_MAX_BLOCKS * 15

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "MarginalPriorFactors":
        M = MARGINAL_MAX_BLOCKS
        return MarginalPriorFactors(
            slots=jnp.zeros((F, M), jnp.int32),
            active=jnp.zeros((F,), bool),
            q_lin=jnp.tile(lie.quat_identity((), dtype), (F, M, 1)),
            p_lin=jnp.zeros((F, M, 3), dtype),
            v_lin=jnp.zeros((F, M, 3), dtype),
            bg_lin=jnp.zeros((F, M, 3), dtype),
            ba_lin=jnp.zeros((F, M, 3), dtype),
            A=jnp.zeros((F, M * 15, M * 15), dtype),
            b=jnp.zeros((F, M * 15), dtype),
        )

    def params(self):
        return (self.q_lin, self.p_lin, self.v_lin, self.bg_lin, self.ba_lin,
                self.A, self.b)

    def residual(self, block_states, params_one):
        q_lin, p_lin, v_lin, bg_lin, ba_lin, A, b = params_one
        ds = []
        for m, (q, p, v, bg, ba) in enumerate(block_states):
            dq = lie.so3_log(lie.quat_mul(lie.quat_conj(q_lin[m]), q))
            ds.append(jnp.concatenate([dq, p - p_lin[m], v - v_lin[m],
                                       bg - bg_lin[m], ba - ba_lin[m]]))
        return A @ jnp.concatenate(ds) + b


class ConstantVelocityFactors(FactorBatch):
    """9-dof constant-velocity kinematic factor between consecutive states —
    the batched counterpart of the Unicycle3D motion model's kinematic constraint
    (bs_constraints/motion/unicycle_3d_state_cost_functor.h:127 /
    unicycle_3d_predict.h). The reference predicts with separate angular-
    velocity and linear-acceleration states; our 15-dof IMU states carry
    neither, so the factor penalizes orientation change, constant-velocity
    position prediction, and velocity change:

        r = A · [ log(q_i⁻¹ q_j),  p_j − (p_i + v_i·dt),  v_j − v_i ]
    """

    dt: jnp.ndarray         # [F]
    sqrt_info: jnp.ndarray  # [F, 9, 9]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU)
    RESIDUAL_DIM = 9
    USED_COLS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 17, 18, 19, 20, 21, 22, 23)

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "ConstantVelocityFactors":
        return ConstantVelocityFactors(
            slots=jnp.zeros((F, 2), jnp.int32),
            active=jnp.zeros((F,), bool),
            dt=jnp.zeros((F,), dtype),
            sqrt_info=jnp.zeros((F, 9, 9), dtype),
        )

    def params(self):
        return (self.dt, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q_i, p_i, v_i, *_), (q_j, p_j, v_j, *_) = block_states
        dt, A = params_one
        r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q_i), q_j))
        r_p = p_j - (p_i + dt * v_i)
        r_v = v_j - v_i
        return A @ jnp.concatenate([r_q, r_p, r_v])


class Unicycle3DFactors(FactorBatch):
    """Full-state Unicycle3D kinematic factor — the faithful counterpart of
    the reference's 5-blocks-per-pose motion constraint
    (bs_constraints/motion/unicycle_3d_state_cost_functor.h:70-141 +
    unicycle_3d_predict.h:49-147). The reference carries separate
    VelocityAngular3DStamped / AccelerationLinear3DStamped fuse variables;
    here those live in the window's :class:`MotionStates` block (ω, a in the
    body frame), one slot per pose.

    Kinematics (reference predict(), re-derived on SO(3) instead of
    Euler-rate integration — the residual vanishes on the same
    constant-twist motions):

        q_pred = q_i ⊗ Exp(ω_i·dt)
        p_pred = p_i + v_i·dt + ½·R(q_i)·a_i·dt²
        v_pred = v_i + R(q_i)·a_i·dt          (v world-frame, a body-frame)
        ω_pred = ω_i,  a_pred = a_i

    15-dof whitened residual, ordered [rot(3), pos(3), vel(3), ω(3), a(3)]
    (the reference orders [pos, rpy, vel, ω, a]; A must be given in our
    order):

        r = A · [ Log(q_pred⁻¹ q_j), p_j − p_pred, v_j − v_pred,
                  ω_j − ω_i, a_j − a_i ]
    """

    dt: jnp.ndarray         # [F]
    sqrt_info: jnp.ndarray  # [F, 15, 15]

    BLOCKS = (BLOCK_IMU, BLOCK_MOTION, BLOCK_IMU, BLOCK_MOTION)
    RESIDUAL_DIM = 15
    USED_COLS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 36, 37, 38, 39, 40, 41)

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "Unicycle3DFactors":
        return Unicycle3DFactors(
            slots=jnp.zeros((F, 4), jnp.int32),
            active=jnp.zeros((F,), bool),
            dt=jnp.zeros((F,), dtype),
            sqrt_info=jnp.zeros((F, 15, 15), dtype),
        )

    def params(self):
        return (self.dt, self.sqrt_info)

    def residual(self, block_states, params_one):
        ((q_i, p_i, v_i, *_), (w_i, a_i),
         (q_j, p_j, v_j, *_), (w_j, a_j)) = block_states
        dt, A = params_one
        a_world = lie.quat_rotate(q_i, a_i)
        q_pred = lie.quat_mul(q_i, lie.so3_exp_quat(w_i * dt))
        r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q_pred), q_j))
        r_p = p_j - (p_i + v_i * dt + 0.5 * a_world * dt * dt)
        r_v = v_j - (v_i + a_world * dt)
        r_w = w_j - w_i
        r_a = a_j - a_i
        return A @ jnp.concatenate([r_q, r_p, r_v, r_w, r_a])


def _pinhole_project(X_c, intr, pixel, A):
    """Clamped pinhole projection shared by the reprojection families.
    Returns (whitened residual [2], A·∂π/∂X_c [2,3]). The z-clamp gradient
    matches jnp.maximum's JVP convention (zero once clamped).

    All products go through ops.smallmat (elementwise broadcast-mul-reduce):
    a per-factor [2,2]@[2,3] under vmap is a batched dot of tiny tiles;
    elementwise math fuses with the surrounding factor code instead."""
    z_raw = X_c[2]
    z = jnp.maximum(z_raw, 1e-3)
    u = intr[0] * X_c[0] / z + intr[2]
    v = intr[1] * X_c[1] / z + intr[3]
    r = sm.mv(A, jnp.stack([u, v]) - pixel)
    invz = 1.0 / z
    live = (z_raw > 1e-3).astype(X_c.dtype)
    zero = jnp.zeros_like(z)
    J_pi = jnp.stack([
        jnp.stack([intr[0] * invz, zero,
                   -intr[0] * X_c[0] * invz * invz * live]),
        jnp.stack([zero, intr[1] * invz,
                   -intr[1] * X_c[1] * invz * invz * live]),
    ])
    return r, sm.mm(A, J_pi)


class ReprojectionFactors(FactorBatch):
    """2-dof Euclidean-landmark pixel reprojection — the hot visual residual.

    Mirrors bs_constraints/visual/euclidean_reprojection_function.h:28-179
    (world → baselink → camera → K·hnormalized, whitened) and its
    online-calib functor variant (extrinsic block optimizable:
    euclidean_reprojection_functor_online_calib.h). Holding the extrinsic
    slot (Poses.held) reproduces the fixed-calibration functor.

    Pixels are *undistorted* measurements (the reference undistorts via the
    camera model before building constraints); intrinsics are the per-factor
    pinhole [fx, fy, cx, cy].
    """

    pixel: jnp.ndarray      # [F, 2]
    intr: jnp.ndarray       # [F, 4] fx, fy, cx, cy
    sqrt_info: jnp.ndarray  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU, BLOCK_EXTRINSIC, BLOCK_LANDMARK)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20, 21, 22, 23)
    HAS_ANALYTIC = True

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "ReprojectionFactors":
        return ReprojectionFactors(
            slots=jnp.zeros((F, 3), jnp.int32),
            active=jnp.zeros((F,), bool),
            pixel=jnp.zeros((F, 2), dtype),
            intr=jnp.tile(jnp.asarray([1.0, 1.0, 0.0, 0.0], dtype), (F, 1)),
            sqrt_info=jnp.zeros((F, 2, 2), dtype),
        )

    def params(self):
        return (self.pixel, self.intr, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q_wb, p_wb, *_), (q_bc, p_bc), (X_w,) = block_states
        pixel, intr, A = params_one
        # camera pose: T_WORLD_CAM = T_WORLD_BASELINK · T_BASELINK_CAM
        q_wc = lie.quat_mul(q_wb, q_bc)
        p_wc = p_wb + lie.quat_rotate(q_wb, p_bc)
        # X in camera frame
        X_c = lie.quat_rotate(lie.quat_conj(q_wc), X_w - p_wc)
        z = jnp.maximum(X_c[2], 1e-3)  # clamp behind-camera points
        u = intr[0] * X_c[0] / z + intr[2]
        v = intr[1] * X_c[1] / z + intr[3]
        return sm.mv(A, jnp.stack([u, v]) - pixel)

    def residual_and_jacobian_used(self, block_states, params_one):
        """Closed-form Jacobian of the residual above. Right perturbation
        q←q·Exp(δθ), additive p/landmark (matching _retract_block); the
        analytic blocks are the textbook reprojection chain the reference
        hand-writes in euclidean_reprojection_function.h:66-172."""
        (q_wb, p_wb, *_), (q_bc, p_bc), (X_w,) = block_states
        pixel, intr, A = params_one
        R_wb = lie.quat_to_matrix(q_wb)
        R_bc = lie.quat_to_matrix(q_bc)
        Y = sm.mv(R_wb.T, X_w - p_wb)      # point in baselink frame
        X_c = sm.mv(R_bc.T, Y - p_bc)
        r, AJ = _pinhole_project(X_c, intr, pixel, A)
        AJe = sm.mm(AJ, R_bc.T)            # ∂r/∂Y
        J_lm = sm.mm(AJe, R_wb.T)          # ∂r/∂X_w (landmark)
        J = jnp.concatenate([
            sm.mm(AJe, lie.skew(Y)),       # ∂r/∂δθ_wb
            -J_lm,                         # ∂r/∂δp_wb
            sm.mm(AJ, lie.skew(X_c)),      # ∂r/∂δθ_bc
            -AJe,                          # ∂r/∂δp_bc
            J_lm,
        ], axis=1)
        return r, J


class InverseDepthReprojectionFactors(FactorBatch):
    """2-dof reprojection of an inverse-depth landmark (binary variant).

    Mirrors bs_constraints/visual/inversedepth_reprojection_functor.h:15-136
    and bs_variables/inverse_depth_landmark.h:22: the landmark is a fixed
    bearing (mx, my, 1) in its *anchor* keyframe's camera frame plus a 1-dof
    inverse depth ρ. The residual projects the anchor-frame point m̄/ρ into
    the measurement keyframe via the relative camera pose and compares to the
    measured pixel.

    Storage: ρ lives in component 0 of a standard 3-dof landmark slot; the
    other two components have identically-zero Jacobians, so the Schur
    elimination treats the block as rank-1 (exactly a 1-dof landmark — the
    damping floor keeps the 3×3 inverse finite and their updates are exactly
    zero).
    """

    bearing: jnp.ndarray    # [F, 2] (mx, my) in the anchor camera frame
    pixel: jnp.ndarray      # [F, 2] measured (undistorted) pixel
    intr: jnp.ndarray       # [F, 4] fx, fy, cx, cy
    sqrt_info: jnp.ndarray  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU, BLOCK_IMU, BLOCK_EXTRINSIC, BLOCK_LANDMARK)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20, 30, 31, 32, 33, 34, 35, 36)
    HAS_ANALYTIC = True

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "InverseDepthReprojectionFactors":
        return InverseDepthReprojectionFactors(
            slots=jnp.zeros((F, 4), jnp.int32),
            active=jnp.zeros((F,), bool),
            bearing=jnp.zeros((F, 2), dtype),
            pixel=jnp.zeros((F, 2), dtype),
            intr=jnp.tile(jnp.asarray([1.0, 1.0, 0.0, 0.0], dtype), (F, 1)),
            sqrt_info=jnp.zeros((F, 2, 2), dtype),
        )

    def params(self):
        return (self.bearing, self.pixel, self.intr, self.sqrt_info)

    def residual(self, block_states, params_one):
        ((q_a, p_a, *_), (q_m, p_m, *_), (q_bc, p_bc),
         (lm,)) = block_states
        bearing, pixel, intr, A = params_one
        rho = jnp.maximum(lm[0], 1e-4)
        # anchor camera pose
        q_wca = lie.quat_mul(q_a, q_bc)
        p_wca = p_a + lie.quat_rotate(q_a, p_bc)
        # measurement camera pose
        q_wcm = lie.quat_mul(q_m, q_bc)
        p_wcm = p_m + lie.quat_rotate(q_m, p_bc)
        # anchor-frame point → world → measurement frame
        X_a = jnp.concatenate([bearing, jnp.ones(1, bearing.dtype)]) / rho
        X_w = lie.quat_rotate(q_wca, X_a) + p_wca
        X_m = lie.quat_rotate(lie.quat_conj(q_wcm), X_w - p_wcm)
        z = jnp.maximum(X_m[2], 1e-3)
        u = intr[0] * X_m[0] / z + intr[2]
        v = intr[1] * X_m[1] / z + intr[3]
        return sm.mv(A, jnp.stack([u, v]) - pixel)

    def residual_and_jacobian_used(self, block_states, params_one):
        """Closed-form Jacobian: anchor pose, measurement pose, shared
        extrinsic (appears in both camera chains) and ρ (rank-1 landmark
        column; the ρ-clamp gradient zeroes once floored)."""
        ((q_a, p_a, *_), (q_m, p_m, *_), (q_bc, p_bc),
         (lm,)) = block_states
        bearing, pixel, intr, A = params_one
        rho_raw = lm[0]
        rho = jnp.maximum(rho_raw, 1e-4)
        R_a = lie.quat_to_matrix(q_a)
        R_m = lie.quat_to_matrix(q_m)
        R_e = lie.quat_to_matrix(q_bc)
        X_a = jnp.concatenate([bearing, jnp.ones(1, bearing.dtype)]) / rho
        v_a = sm.mv(R_e, X_a) + p_bc       # anchor-baselink-frame point
        X_w = sm.mv(R_a, v_a) + p_a
        Y_m = sm.mv(R_m.T, X_w - p_m)      # measurement-baselink frame
        X_m = sm.mv(R_e.T, Y_m - p_bc)
        r, AJ = _pinhole_project(X_m, intr, pixel, A)
        B = sm.mm(R_e.T, R_m.T)            # ∂X_m/∂δp_a
        C = sm.mm(B, R_a)                  # anchor-baselink → meas camera
        AJB = sm.mm(AJ, B)
        AJC = sm.mm(AJ, C)
        CRe = sm.mm(C, R_e)
        live_rho = (rho_raw > 1e-4).astype(X_m.dtype)
        J_rho = sm.mv(AJ, sm.mv(CRe, -X_a / rho))[:, None] * live_rho
        AJRe = sm.mm(AJ, R_e.T)
        J = jnp.concatenate([
            -sm.mm(AJC, lie.skew(v_a)),    # anchor δθ
            AJB,                           # anchor δp
            sm.mm(AJRe, lie.skew(Y_m)),    # measurement δθ
            -AJB,                          # measurement δp
            sm.mm(AJ, lie.skew(X_m))
            - sm.mm(sm.mm(AJC, R_e), lie.skew(X_a)),  # extrinsic δθ
            AJC - AJRe,                    # extrinsic δp
            J_rho,
        ], axis=1)
        return r, J


class InverseDepthUnaryReprojectionFactors(FactorBatch):
    """Unary inverse-depth reprojection: the ANCHOR camera pose is a fixed
    per-factor parameter (the anchor keyframe has been marginalized out of
    the window), so only the measurement state, the extrinsic, and ρ are
    optimized — bs_constraints/visual/inversedepth_reprojection_functor.h's
    unary variant (completing component #19's binary+unary pair)."""

    q_anchor: jnp.ndarray   # [F, 4] fixed T_WORLD_CAMERA_anchor rotation
    p_anchor: jnp.ndarray   # [F, 3]
    bearing: jnp.ndarray    # [F, 2]
    pixel: jnp.ndarray      # [F, 2]
    intr: jnp.ndarray       # [F, 4]
    sqrt_info: jnp.ndarray  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU, BLOCK_EXTRINSIC, BLOCK_LANDMARK)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2, 3, 4, 5, 15, 16, 17, 18, 19, 20, 21)
    HAS_ANALYTIC = True

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> \
            "InverseDepthUnaryReprojectionFactors":
        return InverseDepthUnaryReprojectionFactors(
            slots=jnp.zeros((F, 3), jnp.int32),
            active=jnp.zeros((F,), bool),
            q_anchor=lie.quat_identity((F,), dtype),
            p_anchor=jnp.zeros((F, 3), dtype),
            bearing=jnp.zeros((F, 2), dtype),
            pixel=jnp.zeros((F, 2), dtype),
            intr=jnp.tile(jnp.asarray([1.0, 1.0, 0.0, 0.0], dtype), (F, 1)),
            sqrt_info=jnp.zeros((F, 2, 2), dtype))

    def params(self):
        return (self.q_anchor, self.p_anchor, self.bearing, self.pixel,
                self.intr, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q_m, p_m, *_), (q_bc, p_bc), (lm,) = block_states
        q_wca, p_wca, bearing, pixel, intr, A = params_one
        rho = jnp.maximum(lm[0], 1e-4)
        q_wcm = lie.quat_mul(q_m, q_bc)
        p_wcm = p_m + lie.quat_rotate(q_m, p_bc)
        X_a = jnp.concatenate([bearing, jnp.ones(1, bearing.dtype)]) / rho
        X_w = lie.quat_rotate(q_wca, X_a) + p_wca
        X_m = lie.quat_rotate(lie.quat_conj(q_wcm), X_w - p_wcm)
        z = jnp.maximum(X_m[2], 1e-3)
        u = intr[0] * X_m[0] / z + intr[2]
        v = intr[1] * X_m[1] / z + intr[3]
        return sm.mv(A, jnp.stack([u, v]) - pixel)

    def residual_and_jacobian_used(self, block_states, params_one):
        """Closed-form Jacobian: the anchor camera pose is a fixed
        parameter, so only the measurement chain differentiates (the
        extrinsic enters once, unlike the binary variant)."""
        (q_m, p_m, *_), (q_bc, p_bc), (lm,) = block_states
        q_wca, p_wca, bearing, pixel, intr, A = params_one
        rho_raw = lm[0]
        rho = jnp.maximum(rho_raw, 1e-4)
        R_m = lie.quat_to_matrix(q_m)
        R_e = lie.quat_to_matrix(q_bc)
        R_wca = lie.quat_to_matrix(q_wca)
        X_a = jnp.concatenate([bearing, jnp.ones(1, bearing.dtype)]) / rho
        X_w = sm.mv(R_wca, X_a) + p_wca
        Y_m = sm.mv(R_m.T, X_w - p_m)
        X_m = sm.mv(R_e.T, Y_m - p_bc)
        r, AJ = _pinhole_project(X_m, intr, pixel, A)
        AJe = sm.mm(AJ, R_e.T)
        B = sm.mm(AJe, R_m.T)              # ∂r/∂X_w
        live_rho = (rho_raw > 1e-4).astype(X_m.dtype)
        J_rho = sm.mv(B, sm.mv(R_wca, -X_a / rho))[:, None] * live_rho
        J = jnp.concatenate([
            sm.mm(AJe, lie.skew(Y_m)),     # measurement δθ
            -B,                            # measurement δp
            sm.mm(AJ, lie.skew(X_m)),      # extrinsic δθ
            -AJe,                          # extrinsic δp
            J_rho,
        ], axis=1)
        return r, J


class GravityAlignmentFactors(FactorBatch):
    """2-dof roll/pitch alignment factor: xy components of R_WB⁻¹... mirrors
    bs_constraints/global/gravity_alignment_cost_functor.h:32-82 — the
    residual is the xy part of (R_WB · ĝ_B) + ĝ_W scaled by the measurement
    (gravity direction measured by the accelerometer in the body frame)."""

    g_body: jnp.ndarray     # [F, 3] unit gravity direction in body frame
    sqrt_info: jnp.ndarray  # [F, 2, 2]

    BLOCKS = (BLOCK_IMU,)
    RESIDUAL_DIM = 2
    USED_COLS = (0, 1, 2)

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "GravityAlignmentFactors":
        return GravityAlignmentFactors(
            slots=jnp.zeros((F, 1), jnp.int32),
            active=jnp.zeros((F,), bool),
            g_body=jnp.tile(jnp.asarray([0.0, 0.0, -1.0], dtype), (F, 1)),
            sqrt_info=jnp.zeros((F, 2, 2), dtype),
        )

    def params(self):
        return (self.g_body, self.sqrt_info)

    def residual(self, block_states, params_one):
        (q, *_), = block_states
        g_body, A = params_one
        # Rotate the body-frame gravity direction into world; when aligned it
        # equals [0, 0, -1], so the xy components are the roll/pitch error.
        g_world = lie.quat_rotate(q, g_body)
        return sm.mv(A, g_world[0:2])
