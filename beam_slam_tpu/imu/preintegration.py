"""IMU preintegration as a ``lax.scan`` over sample buffers.

Re-implementation of ``bs_common::PreIntegrator``
(bs_common/src/bs_common/preintegrator.cpp:26-144): midpoint integration of
(Δq, Δp, Δv), 15×15 covariance propagation in error-state order
(q, p, v, bg, ba — preintegrator.h:13-20), first-order bias Jacobians
(dq/dbg, dp/dbg, dp/dba, dv/dbg, dv/dba), and the sqrt-inverse-covariance
whitener with degeneracy floors (cov_tol / bias_cov_tol) and an invalid-cov
fallback weight.

Differences from the reference (by design, not omission):
  * The sample buffer is a fixed-capacity array with a per-sample validity
    mask instead of a ``std::map`` — static shapes for XLA; the host-side
    ``ImuBuffer`` (models/inertial_odometry.py) owns windowing.
  * Since the (q,p,v) covariance propagation never couples into the bias
    blocks (reference A/B touch only the top-left 9×9; bias blocks are pure
    random walk, preintegrator.cpp:62-66), we propagate the 9×9 block and
    accumulate the two 3×3 bias blocks separately, composing the 15×15 at the
    end — fewer FLOPs per scan step, identical result.
  * sqrt_inv_cov is computed via Cholesky of the (equilibrated) covariance +
    triangular solve instead of LLT(cov⁻¹) — algebraically an equivalent
    whitener (AᵀA = Σ⁻¹), numerically stable in float32.
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp
from beam_slam_tpu.core import struct

from beam_slam_tpu.core import lie


class PreintNoise(NamedTuple):
    """Continuous-time noise model (preintegrator.h cov_w/cov_a/cov_bg/cov_ba).
    Each entry is a 3×3 covariance."""

    cov_w: jnp.ndarray
    cov_a: jnp.ndarray
    cov_bg: jnp.ndarray
    cov_ba: jnp.ndarray

    @staticmethod
    def isotropic(sig_w: float, sig_a: float, sig_bg: float, sig_ba: float,
                  dtype=jnp.float32) -> "PreintNoise":
        eye = jnp.eye(3, dtype=dtype)
        return PreintNoise(
            cov_w=sig_w ** 2 * eye, cov_a=sig_a ** 2 * eye,
            cov_bg=sig_bg ** 2 * eye, cov_ba=sig_ba ** 2 * eye,
        )


@struct.dataclass
class Delta:
    """Preintegrated increment (bs_common::Delta, preintegrator.h:52-59) plus
    the bias Jacobians (bs_common::Jacobian, :64-70). Batched-friendly: all
    fields broadcast over leading dims."""

    t: jnp.ndarray        # [] total integration time
    q: jnp.ndarray        # [4]
    p: jnp.ndarray        # [3]
    v: jnp.ndarray        # [3]
    cov: jnp.ndarray      # [15, 15]
    sqrt_inv_cov: jnp.ndarray  # [15, 15]
    dq_dbg: jnp.ndarray   # [3, 3]
    dp_dbg: jnp.ndarray
    dp_dba: jnp.ndarray
    dv_dbg: jnp.ndarray
    dv_dba: jnp.ndarray


# Degeneracy floors (preintegrator.h:130-134) and invalid-cov fallback (:141).
COV_TOL = 1e-5
BIAS_COV_TOL = 1e-9
INVALID_INV_COV_WEIGHT = 1e-4


def _step(carry, inp, noise: PreintNoise):
    """One Increment (preintegrator.cpp:26-89). carry holds the running
    delta; inp = (dt, w_meas, a_meas, valid)."""
    (q, p, v, cov9, cov_bg_acc, cov_ba_acc,
     dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba, t, bg, ba) = carry
    dt, w_meas, a_meas, valid = inp
    dtype = q.dtype

    w = w_meas - bg
    a = a_meas - ba
    q_full = lie.so3_exp_quat(w * dt)
    q_half = lie.so3_exp_quat(0.5 * w * dt)

    R_delta = lie.quat_to_matrix(q)          # R(Δq) before this step
    R_full_T = lie.quat_to_matrix(q_full).T  # q_full.conjugate().matrix()
    skew_a = lie.skew(a)
    Jr = lie.so3_right_jacobian(w * dt)

    # --- covariance propagation (9×9 q,p,v block; preintegrator.cpp:38-66)
    A = jnp.eye(9, dtype=dtype)
    A = A.at[0:3, 0:3].set(R_full_T)
    A = A.at[6:9, 0:3].set(-dt * R_delta @ skew_a)
    A = A.at[3:6, 0:3].set(-0.5 * dt * dt * R_delta @ skew_a)
    A = A.at[3:6, 6:9].set(dt * jnp.eye(3, dtype=dtype))

    B = jnp.zeros((9, 6), dtype)
    B = B.at[0:3, 0:3].set(dt * Jr)
    B = B.at[6:9, 3:6].set(dt * R_delta)
    B = B.at[3:6, 3:6].set(0.5 * dt * dt * R_delta)

    inv_dt = 1.0 / jnp.maximum(dt, 1e-7)
    Qw = jnp.zeros((6, 6), dtype)
    Qw = Qw.at[0:3, 0:3].set(noise.cov_w * inv_dt)
    Qw = Qw.at[3:6, 3:6].set(noise.cov_a * inv_dt)

    cov9_new = A @ cov9 @ A.T + B @ Qw @ B.T
    cov_bg_new = cov_bg_acc + noise.cov_bg * dt
    cov_ba_new = cov_ba_acc + noise.cov_ba * dt

    # --- bias jacobians (preintegrator.cpp:69-80; update order matters)
    dp_dbg_new = dp_dbg + dt * dv_dbg - 0.5 * dt * dt * R_delta @ skew_a @ dq_dbg
    dp_dba_new = dp_dba + dt * dv_dba - 0.5 * dt * dt * R_delta
    dv_dbg_new = dv_dbg - dt * R_delta @ skew_a @ dq_dbg
    dv_dba_new = dv_dba - dt * R_delta
    dq_dbg_new = R_full_T @ dq_dbg - dt * Jr

    # --- midpoint state update (preintegrator.cpp:82-88)
    q_mid = lie.quat_mul(q, q_half)
    a_mid = lie.quat_rotate(q_mid, a)
    t_new = t + dt
    p_new = p + dt * v + 0.5 * dt * dt * a_mid
    v_new = v + dt * a_mid
    q_new = lie.quat_normalize(lie.quat_mul(q, q_full))

    def sel(new, old):
        return jnp.where(valid, new, old)

    carry = (sel(q_new, q), sel(p_new, p), sel(v_new, v),
             sel(cov9_new, cov9), sel(cov_bg_new, cov_bg_acc),
             sel(cov_ba_new, cov_ba_acc),
             sel(dq_dbg_new, dq_dbg), sel(dp_dbg_new, dp_dbg),
             sel(dp_dba_new, dp_dba), sel(dv_dbg_new, dv_dbg),
             sel(dv_dba_new, dv_dba), sel(t_new, t), bg, ba)
    return carry, None


@partial(jax.jit, static_argnames=("compute_information",))
def preintegrate(dt: jnp.ndarray, w: jnp.ndarray, a: jnp.ndarray,
                 bg: jnp.ndarray, ba: jnp.ndarray, noise: PreintNoise,
                 valid: jnp.ndarray | None = None,
                 compute_information: bool = True) -> Delta:
    """Integrate a buffer of IMU samples (PreIntegrator::Integrate,
    preintegrator.cpp:91-115).

    Args:
      dt:    [N] per-sample integration interval (seconds). Entries with
             dt <= 0 or ``valid == False`` are skipped (masked), mirroring the
             reference's "only increment while next sample ≤ t" windowing.
      w, a:  [N, 3] gyro / accel measurements.
      bg, ba: [3] bias linearization points.
      noise: continuous-time noise model.
    """
    dtype = w.dtype
    if valid is None:
        valid = jnp.ones(dt.shape, bool)
    valid = valid & (dt > 0)

    carry = (
        lie.quat_identity((), dtype), jnp.zeros(3, dtype), jnp.zeros(3, dtype),
        jnp.zeros((9, 9), dtype), jnp.zeros((3, 3), dtype),
        jnp.zeros((3, 3), dtype),
        jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
        jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
        jnp.zeros((3, 3), dtype),
        jnp.zeros((), dtype), bg.astype(dtype), ba.astype(dtype),
    )
    step = lambda c, i: _step(c, i, noise)
    (q, p, v, cov9, cov_bg, cov_ba, dq_dbg, dp_dbg, dp_dba, dv_dbg, dv_dba,
     t, _, _) = jax.lax.scan(step, carry, (dt, w, a, valid))[0]

    cov = jnp.zeros((15, 15), dtype)
    cov = cov.at[0:9, 0:9].set(cov9)
    cov = cov.at[9:12, 9:12].set(cov_bg)
    cov = cov.at[12:15, 12:15].set(cov_ba)

    if compute_information:
        sqrt_inv = sqrt_inv_cov(cov)
    else:
        sqrt_inv = jnp.zeros((15, 15), dtype)
    return Delta(t=t, q=q, p=p, v=v, cov=cov, sqrt_inv_cov=sqrt_inv,
                 dq_dbg=dq_dbg, dp_dbg=dp_dbg, dp_dba=dp_dba,
                 dv_dbg=dv_dbg, dv_dba=dv_dba)


def sqrt_inv_cov(cov: jnp.ndarray) -> jnp.ndarray:
    """Whitening matrix A with AᵀA = cov⁻¹ (PreIntegrator::ComputeSqrtInvCov,
    preintegrator.cpp:117-144), with the reference's degeneracy floors.

    Implementation: Jacobi-equilibrate cov, Cholesky, triangular-solve the
    identity — stable in f32 where inverse-then-Cholesky is not. Falls back to
    INVALID_INV_COV_WEIGHT · I when the factorization fails (reference :139-143).
    """
    dtype = cov.dtype

    # Degeneracy floors (reference :121-133).
    norm1 = jnp.linalg.norm(cov[0:9, 0:9])
    cov = jnp.where(norm1 < COV_TOL,
                    cov.at[0:9, 0:9].set(COV_TOL * jnp.eye(9, dtype=dtype)),
                    cov)
    norm2 = jnp.linalg.norm(cov[9:15, 9:15])
    cov = jnp.where(norm2 < BIAS_COV_TOL,
                    cov.at[9:15, 9:15].set(
                        BIAS_COV_TOL * jnp.eye(6, dtype=dtype)),
                    cov)

    d = jnp.diagonal(cov)
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-30))
    cov_s = cov * (s[:, None] * s[None, :])
    C = jnp.linalg.cholesky(cov_s)
    Cinv = jax.scipy.linalg.solve_triangular(
        C, jnp.eye(15, dtype=dtype), lower=True)
    # cov⁻¹ = S·cov_s⁻¹·S = (Cinv·S)ᵀ(Cinv·S)  →  A = Cinv·diag(s).
    A = Cinv * s[None, :]
    ok = jnp.all(jnp.isfinite(A))
    return jnp.where(ok, A,
                     INVALID_INV_COV_WEIGHT * jnp.eye(15, dtype=dtype))


def predict_state(delta: Delta, q_i, p_i, v_i, gravity=None):
    """Propagate state i through a preintegrated delta
    (ImuPreintegration::PredictState, imu_preintegration.cpp:220-244):
      q_j = q_i ⊗ Δq;  p_j = p_i + v_i·Δt + ½g·Δt² + R(q_i)·Δp;
      v_j = v_i + g·Δt + R(q_i)·Δv.
    """
    if gravity is None:
        from beam_slam_tpu.core.factors import GRAVITY_WORLD
        gravity = GRAVITY_WORLD.astype(q_i.dtype)
    dt = delta.t
    q_j = lie.quat_normalize(lie.quat_mul(q_i, delta.q))
    p_j = p_i + dt * v_i + 0.5 * dt * dt * gravity + lie.quat_rotate(q_i, delta.p)
    v_j = v_i + dt * gravity + lie.quat_rotate(q_i, delta.v)
    return q_j, p_j, v_j


# ---------------------------------------------------------------------------
# Host-numpy mirror — the ONLINE factor-creation path
# ---------------------------------------------------------------------------

def preintegrate_np(dt, w, a, bg, ba, noise: PreintNoise,
                    compute_information: bool = True) -> Delta:
    """Pure-numpy mirror of :func:`preintegrate` for the online trigger path.

    A keyframe interval holds ~20-100 IMU samples: microseconds of math on
    the host, less than one device dispatch plus a blocking result pull —
    the reference likewise preintegrates on CPU
    (bs_common/src/bs_common/preintegrator.cpp). The batched/vmapped device
    path remains for offline workloads (synthetic builders, refinement).

    Parity with the device path is asserted in tests/test_preintegration.py.
    """
    import numpy as np

    dt = np.asarray(dt, np.float64)
    w = np.asarray(w, np.float64)
    a = np.asarray(a, np.float64)
    bg = np.asarray(bg, np.float64)
    ba = np.asarray(ba, np.float64)
    cov_w = np.asarray(noise.cov_w, np.float64)
    cov_a = np.asarray(noise.cov_a, np.float64)
    cov_bg_n = np.asarray(noise.cov_bg, np.float64)
    cov_ba_n = np.asarray(noise.cov_ba, np.float64)

    q = np.array([1.0, 0, 0, 0])
    p = np.zeros(3)
    v = np.zeros(3)
    cov9 = np.zeros((9, 9))
    cov_bg = np.zeros((3, 3))
    cov_ba = np.zeros((3, 3))
    dq_dbg = np.zeros((3, 3))
    dp_dbg = np.zeros((3, 3))
    dp_dba = np.zeros((3, 3))
    dv_dbg = np.zeros((3, 3))
    dv_dba = np.zeros((3, 3))
    t = 0.0
    eye3 = np.eye(3)

    for i in range(len(dt)):
        h = float(dt[i])
        if h <= 0:
            continue
        wi = w[i] - bg
        ai = a[i] - ba
        q_full = np.asarray(lie.so3_exp_quat(wi * h))
        q_half = np.asarray(lie.so3_exp_quat(0.5 * wi * h))
        R_delta = np.asarray(lie.quat_to_matrix(q))
        R_full_T = np.asarray(lie.quat_to_matrix(q_full)).T
        skew_a = np.asarray(lie.skew(ai))
        Jr = np.asarray(lie.so3_right_jacobian(wi * h))

        A = np.eye(9)
        A[0:3, 0:3] = R_full_T
        A[6:9, 0:3] = -h * R_delta @ skew_a
        A[3:6, 0:3] = -0.5 * h * h * R_delta @ skew_a
        A[3:6, 6:9] = h * eye3
        B = np.zeros((9, 6))
        B[0:3, 0:3] = h * Jr
        B[6:9, 3:6] = h * R_delta
        B[3:6, 3:6] = 0.5 * h * h * R_delta
        Qw = np.zeros((6, 6))
        inv_h = 1.0 / max(h, 1e-7)
        Qw[0:3, 0:3] = cov_w * inv_h
        Qw[3:6, 3:6] = cov_a * inv_h
        cov9 = A @ cov9 @ A.T + B @ Qw @ B.T
        cov_bg = cov_bg + cov_bg_n * h
        cov_ba = cov_ba + cov_ba_n * h

        dp_dbg = dp_dbg + h * dv_dbg - 0.5 * h * h * R_delta @ skew_a @ dq_dbg
        dp_dba = dp_dba + h * dv_dba - 0.5 * h * h * R_delta
        dv_dbg = dv_dbg - h * R_delta @ skew_a @ dq_dbg
        dv_dba = dv_dba - h * R_delta
        dq_dbg = R_full_T @ dq_dbg - h * Jr

        q_mid = np.asarray(lie.quat_mul(q, q_half))
        a_mid = np.asarray(lie.quat_rotate(q_mid, ai))
        p = p + h * v + 0.5 * h * h * a_mid
        v = v + h * a_mid
        q = np.asarray(lie.quat_normalize(lie.quat_mul(q, q_full)))
        t += h

    cov = np.zeros((15, 15))
    cov[0:9, 0:9] = cov9
    cov[9:12, 9:12] = cov_bg
    cov[12:15, 12:15] = cov_ba
    if compute_information:
        sqrt_inv = sqrt_inv_cov_np(cov)
    else:
        sqrt_inv = np.zeros((15, 15), np.float32)
    f32 = np.float32
    return Delta(t=f32(t), q=q.astype(f32), p=p.astype(f32),
                 v=v.astype(f32), cov=cov.astype(f32),
                 sqrt_inv_cov=sqrt_inv.astype(f32),
                 dq_dbg=dq_dbg.astype(f32), dp_dbg=dp_dbg.astype(f32),
                 dp_dba=dp_dba.astype(f32), dv_dbg=dv_dbg.astype(f32),
                 dv_dba=dv_dba.astype(f32))


def sqrt_inv_cov_np(cov) -> "np.ndarray":
    """numpy mirror of :func:`sqrt_inv_cov` (same floors and fallback)."""
    import numpy as np

    cov = np.asarray(cov, np.float64).copy()
    if np.linalg.norm(cov[0:9, 0:9]) < COV_TOL:
        cov[0:9, 0:9] = COV_TOL * np.eye(9)
    if np.linalg.norm(cov[9:15, 9:15]) < BIAS_COV_TOL:
        cov[9:15, 9:15] = BIAS_COV_TOL * np.eye(6)
    d = np.maximum(np.diagonal(cov), 1e-30)
    s = 1.0 / np.sqrt(d)
    cov_s = cov * (s[:, None] * s[None, :])
    try:
        C = np.linalg.cholesky(cov_s)
    except np.linalg.LinAlgError:
        return (INVALID_INV_COV_WEIGHT * np.eye(15)).astype(np.float32)
    import scipy.linalg as sla
    Cinv = sla.solve_triangular(C, np.eye(15), lower=True)
    A = Cinv * s[None, :]
    if not np.isfinite(A).all():
        return (INVALID_INV_COV_WEIGHT * np.eye(15)).astype(np.float32)
    return A.astype(np.float32)


def predict_state_np(delta: Delta, q_i, p_i, v_i):
    """numpy mirror of :func:`predict_state`."""
    import numpy as np

    g = np.asarray([0.0, 0.0, -9.80665])
    q_i = np.asarray(q_i, np.float64)
    p_i = np.asarray(p_i, np.float64)
    v_i = np.asarray(v_i, np.float64)
    dt = float(delta.t)
    q_j = np.asarray(lie.quat_normalize(
        lie.quat_mul(q_i, np.asarray(delta.q, np.float64))))
    p_j = (p_i + dt * v_i + 0.5 * dt * dt * g
           + np.asarray(lie.quat_rotate(q_i, np.asarray(delta.p, np.float64))))
    v_j = v_i + dt * g + np.asarray(
        lie.quat_rotate(q_i, np.asarray(delta.v, np.float64)))
    return (q_j.astype(np.float32), p_j.astype(np.float32),
            v_j.astype(np.float32))
