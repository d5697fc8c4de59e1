"""SO(3)/SE(3) Lie-group math, backend-dual over numpy and JAX.

Re-implementation of the subset of ``beam_utils/se3.h`` /
``beam_utils/math.h`` that beam_slam uses (see reference usage in
bs_common/src/bs_common/preintegrator.cpp:35-52 — ``beam::LieAlgebraToR``,
``beam::RightJacobianOfSO3``, ``beam::SkewTransform`` — and
bs_constraints/src/jacobians.cpp).

Every function dispatches on its inputs: JAX arrays (including tracers
under jit/vmap/grad — tracers are ``jax.Array`` instances) run the jnp
path and stay fully jit/vmap/grad-safe; plain numpy/python inputs run
the numpy path *eagerly on the host*. The host pipeline (transaction
building, odometry bookkeeping, seeds) calls these on tiny arrays
thousands of times per second — routing those through the device would
be ~600 eager dispatches per scan, each costing far more than its math.

Conventions:
  * Quaternions are stored ``[w, x, y, z]`` (Hamilton, active rotation),
    matching Eigen's internal ``Quaterniond(w,x,y,z)`` constructor order used
    throughout the reference.
  * All functions are shape-polymorphic over leading batch dims: inputs of
    shape ``(..., 3)`` / ``(..., 4)`` produce outputs with the same leading
    dims. No data-dependent control flow; small-angle branches are handled
    with ``where`` on safe operands.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _xp(*arrays):
    """numpy for host values, jnp when any input is a jax array/tracer."""
    for a in arrays:
        if isinstance(a, jax.Array):
            return jnp
    return np


def skew(v) -> jnp.ndarray:
    """Skew-symmetric (cross-product) matrix. (..., 3) -> (..., 3, 3).

    Mirrors ``beam::SkewTransform`` (preintegrator.cpp:44).
    """
    xp = _xp(v)
    v = xp.asarray(v)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = xp.zeros_like(x)
    return xp.stack(
        [
            xp.stack([zero, -z, y], axis=-1),
            xp.stack([z, zero, -x], axis=-1),
            xp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


# ----------------------------------------------------------------------------
# Quaternion algebra ([w, x, y, z])
# ----------------------------------------------------------------------------


def quat_identity(shape=(), dtype=jnp.float32) -> jnp.ndarray:
    q = jnp.zeros(tuple(shape) + (4,), dtype=dtype)
    return q.at[..., 0].set(1.0)


def quat_mul(a, b) -> jnp.ndarray:
    """Hamilton product a ⊗ b. (..., 4) x (..., 4) -> (..., 4)."""
    xp = _xp(a, b)
    a = xp.asarray(a)
    b = xp.asarray(b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return xp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q) -> jnp.ndarray:
    xp = _xp(q)
    q = xp.asarray(q)
    return q * xp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q) -> jnp.ndarray:
    xp = _xp(q)
    q = xp.asarray(q)
    n = xp.linalg.norm(q, axis=-1, keepdims=True)
    return q / xp.maximum(n, _EPS)


def quat_rotate(q, v) -> jnp.ndarray:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v. (...,4),(...,3)->(...,3).

    Uses the 15-mul expansion rather than forming the rotation matrix.
    """
    xp = _xp(q, v)
    q = xp.asarray(q)
    v = xp.asarray(v)
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * xp.cross(qv, v)
    return v + qw * t + xp.cross(qv, t)


def quat_to_matrix(q) -> jnp.ndarray:
    """Unit quaternion -> rotation matrix. (..., 4) -> (..., 3, 3)."""
    xp = _xp(q)
    q = xp.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return xp.stack(
        [
            xp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            xp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            xp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion [w,x,y,z]. Branch-free Shepperd.

    (..., 3, 3) -> (..., 4). Safe under jit; picks the numerically best of the
    four Shepperd candidates with where/take_along_axis.
    """
    xp = _xp(R)
    R = xp.asarray(R)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q_k^2 values (all >= 0 up to fp error).
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return xp.sqrt(xp.maximum(x, _EPS * _EPS))

    # Branch w: q = [t, (m21-m12)/4t', ...] with t' = sqrt(qw2)/2 etc.
    sw = _safe_sqrt(qw2)
    qa = xp.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], axis=-1) / (2.0 * sw[..., None])
    sx = _safe_sqrt(qx2)
    qb = xp.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], axis=-1) / (2.0 * sx[..., None])
    sy = _safe_sqrt(qy2)
    qc = xp.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], axis=-1) / (2.0 * sy[..., None])
    sz = _safe_sqrt(qz2)
    qd = xp.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], axis=-1) / (2.0 * sz[..., None])

    vals = xp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = xp.argmax(vals, axis=-1)
    cand = xp.stack([qa, qb, qc, qd], axis=-2)  # (..., 4 candidates, 4)
    q = xp.take_along_axis(
        cand, best[..., None, None].astype(xp.int32), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign: w >= 0.
    return q * xp.where(q[..., 0:1] < 0, -1.0, 1.0)


# ----------------------------------------------------------------------------
# SO(3) exp/log and Jacobians
# ----------------------------------------------------------------------------


def so3_exp_quat(w) -> jnp.ndarray:
    """exp: so(3) -> unit quaternion. (..., 3) -> (..., 4).

    Mirrors ``beam::LieAlgebraToR`` (preintegrator.cpp:35) composed with the
    quaternion representation. Taylor-safe near zero.
    """
    xp = _xp(w)
    w = xp.asarray(w)
    theta2 = xp.sum(w * w, axis=-1, keepdims=True)
    theta = xp.sqrt(xp.maximum(theta2, _EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    # sin(t/2)/t with Taylor fallback 1/2 - t^2/48.
    k = xp.where(small, 0.5 - theta2 / 48.0, xp.sin(half) / theta)
    cw = xp.where(small, 1.0 - theta2 / 8.0, xp.cos(half))
    return xp.concatenate([cw, k * w], axis=-1)


def so3_log(q) -> jnp.ndarray:
    """log: unit quaternion -> so(3) rotation vector. (..., 4) -> (..., 3).

    Mirrors ``beam::RToLieAlgebra`` (inertial_alignment.cpp:156). Returns the
    minimal-angle representative (|axis*angle| <= pi).
    """
    xp = _xp(q)
    q = xp.asarray(q)
    # Canonicalize to w >= 0 for the shortest arc.
    q = q * xp.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = xp.clip(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn2 = xp.sum(v * v, axis=-1, keepdims=True)
    vn = xp.sqrt(xp.maximum(vn2, _EPS * _EPS))
    angle = 2.0 * xp.arctan2(vn, w)
    small = vn2 < _EPS
    k = xp.where(small, 2.0 / xp.maximum(w, _EPS), angle / vn)
    return k * v


def so3_exp_matrix(w) -> jnp.ndarray:
    """exp: so(3) -> rotation matrix (Rodrigues). (..., 3) -> (..., 3, 3)."""
    xp = _xp(w)
    w = xp.asarray(w)
    theta2 = xp.sum(w * w, axis=-1)
    theta = xp.sqrt(xp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = xp.where(small, 1.0 - theta2 / 6.0, xp.sin(theta) / theta)
    b = xp.where(small, 0.5 - theta2 / 24.0, (1.0 - xp.cos(theta)) / theta2)
    W = skew(w)
    WW = W @ W
    eye = xp.broadcast_to(xp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def so3_right_jacobian(w) -> jnp.ndarray:
    """Right Jacobian J_r of SO(3). (..., 3) -> (..., 3, 3).

    Mirrors ``beam::RightJacobianOfSO3`` (preintegrator.cpp:52):
      J_r(w) = I - b(θ)·[w]× + c(θ)·[w]×²,
      b = (1-cosθ)/θ², c = (θ - sinθ)/θ³.
    """
    xp = _xp(w)
    w = xp.asarray(w)
    theta2 = xp.sum(w * w, axis=-1)
    theta = xp.sqrt(xp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = xp.where(small, 0.5 - theta2 / 24.0, (1.0 - xp.cos(theta)) / theta2)
    c = xp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                 (theta - xp.sin(theta)) / (theta2 * theta))
    W = skew(w)
    WW = W @ W
    eye = xp.broadcast_to(xp.eye(3, dtype=w.dtype), W.shape)
    return eye - b[..., None, None] * W + c[..., None, None] * WW


def so3_left_jacobian(w) -> jnp.ndarray:
    """Left Jacobian J_l(w) = J_r(-w)."""
    return so3_right_jacobian(-_xp(w).asarray(w))


def delta_q(dtheta) -> jnp.ndarray:
    """First-order quaternion increment [1, θ/2] used by the reference IMU
    factor's bias correction (``bs_common::DeltaQ``, cost functor :98)."""
    xp = _xp(dtheta)
    dtheta = xp.asarray(dtheta)
    half = 0.5 * dtheta
    one = xp.ones_like(half[..., :1])
    return quat_normalize(xp.concatenate([one, half], axis=-1))


# ----------------------------------------------------------------------------
# SE(3) helpers (4x4 homogeneous transforms)
# ----------------------------------------------------------------------------


def make_transform(q, p) -> jnp.ndarray:
    """(quat, translation) -> 4x4 transform. Mirrors
    bs_constraints helpers.h ``OrientationAndPositionToTransformationMatrix``."""
    xp = _xp(q, p)
    q = xp.asarray(q)
    p = xp.asarray(p)
    R = quat_to_matrix(q)
    batch = R.shape[:-2]
    top = xp.concatenate([R, p[..., :, None]], axis=-1)       # (..., 3, 4)
    bottom = xp.broadcast_to(
        xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=q.dtype), batch + (1, 4))
    return xp.concatenate([top, bottom], axis=-2)


def invert_transform(T) -> jnp.ndarray:
    """Rigid-transform inverse. Mirrors bs_constraints helpers.h
    ``InvertTransform``."""
    xp = _xp(T)
    T = xp.asarray(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = xp.swapaxes(R, -1, -2)
    top = xp.concatenate([Rt, -(Rt @ t[..., None])], axis=-1)
    bottom = xp.broadcast_to(
        xp.asarray([0.0, 0.0, 0.0, 1.0], dtype=T.dtype),
        T.shape[:-2] + (1, 4))
    return xp.concatenate([top, bottom], axis=-2)


def transform_point(T, pt) -> jnp.ndarray:
    return (T[..., :3, :3] @ pt[..., None])[..., 0] + T[..., :3, 3]


def transform_to_quat_trans(T):
    return matrix_to_quat(T[..., :3, :3]), T[..., :3, 3]


def se3_boxminus_quat(q_a, p_a, q_b, p_b):
    """Minimal 6-dof difference of pose a w.r.t. pose b: [log(q_b⁻¹ q_a), p_a - p_b]."""
    xp = _xp(q_a, p_a, q_b, p_b)
    dq = quat_mul(quat_conj(q_b), q_a)
    return xp.concatenate([so3_log(dq), xp.asarray(p_a) - xp.asarray(p_b)],
                          axis=-1)
