"""Multi-view geometry kernels: triangulation, essential-matrix RANSAC,
batched PnP pose refinement.

JAX replacements for the beam_cv utilities the reference drives
(SURVEY.md §1 L0): ``Triangulation::TriangulatePoint``
(visual_odometry.cpp TriangulateLandmark :532), the essential-matrix RANSAC
outlier gate on incoming tracks (visual_odometry.cpp:516-527), and
``PoseRefinement::RefinePose`` (the Ceres PnP refine in LocalizeFrame :217).

RANSAC is batched hypothesis scoring — all M minimal samples are solved and
scored in one shot (masks instead of early exit), SURVEY.md §7's
'RANSAC/ragged visual tracks' strategy.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------


def triangulate_dlt(q_wc1, p_wc1, q_wc2, p_wc2, ray1, ray2):
    """Two-view midpoint/DLT triangulation from bearing rays.

    q/p: world-from-camera poses; ray: unit bearings in each camera frame
    (backprojected, undistorted). Batched over leading dims.
    Returns (X_w, valid) — valid requires positive depth in both views and a
    non-degenerate baseline/parallax.
    """
    d1 = lie.quat_rotate(q_wc1, ray1)
    d2 = lie.quat_rotate(q_wc2, ray2)
    # closed-form midpoint: solve [d1 -d2][t1 t2]ᵀ = p2 - p1 in lstsq sense
    b = p_wc2 - p_wc1
    d11 = jnp.sum(d1 * d1, axis=-1)
    d22 = jnp.sum(d2 * d2, axis=-1)
    d12 = jnp.sum(d1 * d2, axis=-1)
    denom = d11 * d22 - d12 * d12
    bd1 = jnp.sum(b * d1, axis=-1)
    bd2 = jnp.sum(b * d2, axis=-1)
    denom_safe = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    t1 = (bd1 * d22 - bd2 * d12) / denom_safe
    t2 = (bd1 * d12 - bd2 * d11) / denom_safe
    X1 = p_wc1 + t1[..., None] * d1
    X2 = p_wc2 + t2[..., None] * d2
    X = 0.5 * (X1 + X2)
    parallax_ok = jnp.abs(denom) > 1e-6
    valid = (t1 > 1e-3) & (t2 > 1e-3) & parallax_ok
    return X, valid


def triangulation_reprojection_gate(q_wc, p_wc, intr4, X_w, uv, max_px):
    """Reprojection sanity check used after triangulation (the reference
    validates new landmarks by reprojection error)."""
    X_c = lie.quat_rotate(lie.quat_conj(q_wc), X_w - p_wc)
    z = jnp.maximum(X_c[..., 2], 1e-6)
    u = intr4[..., 0] * X_c[..., 0] / z + intr4[..., 2]
    v = intr4[..., 1] * X_c[..., 1] / z + intr4[..., 3]
    err = jnp.linalg.norm(jnp.stack([u, v], axis=-1) - uv, axis=-1)
    return (err < max_px) & (X_c[..., 2] > 1e-3)


# ---------------------------------------------------------------------------
# Essential matrix RANSAC (8-point, batched hypotheses)
# ---------------------------------------------------------------------------


class RansacResult(NamedTuple):
    E: jnp.ndarray        # [3, 3] best essential matrix
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray
    best_score: jnp.ndarray


@partial(jax.jit, static_argnums=(3,))
def essential_ransac(xn1: jnp.ndarray, xn2: jnp.ndarray, valid: jnp.ndarray,
                     n_hypotheses: int = 128, threshold: float = 2e-3,
                     key: jnp.ndarray | None = None) -> RansacResult:
    """8-point essential RANSAC on *normalized* image coordinates.

    xn1/xn2: [N, 2] normalized coords ((u-cx)/fx) in frames 1/2; valid: [N].
    All hypotheses are solved and Sampson-scored in parallel.
    """
    N = xn1.shape[0]
    if key is None:
        key = jax.random.PRNGKey(0)
    # sample from valid indices with replacement-safe weighting
    w = valid.astype(jnp.float32) + 1e-6
    idx = jax.random.categorical(
        key, jnp.log(w)[None, :].repeat(n_hypotheses * 8, 0))
    idx = idx.reshape(n_hypotheses, 8)

    h1 = jnp.concatenate([xn1, jnp.ones((N, 1), xn1.dtype)], axis=1)
    h2 = jnp.concatenate([xn2, jnp.ones((N, 1), xn2.dtype)], axis=1)

    def solve_one(sel):
        a = h1[sel]   # [8, 3]
        b = h2[sel]
        # rows: kron(a_i, b_i): E s.t. b᛫ᵀ E a = 0  → A·vec(E) = 0
        A = jnp.einsum("ni,nj->nij", b, a).reshape(8, 9)
        _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        E = Vt[-1].reshape(3, 3)
        # rank-2 projection
        U, S, Vt2 = jnp.linalg.svd(E)
        S = S.at[2].set(0.0)
        return (U * S[None, :]) @ Vt2

    Es = jax.vmap(solve_one)(idx)            # [M, 3, 3]

    def sampson(E):
        Ea = jnp.einsum("ij,nj->ni", E, h1)       # [N, 3]
        Etb = jnp.einsum("ji,nj->ni", E, h2)
        num = jnp.einsum("ni,ni->n", h2, Ea) ** 2
        den = (Ea[:, 0] ** 2 + Ea[:, 1] ** 2
               + Etb[:, 0] ** 2 + Etb[:, 1] ** 2)
        return num / jnp.maximum(den, 1e-12)

    d = jax.vmap(sampson)(Es)                # [M, N]
    inl = (d < threshold * threshold) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    return RansacResult(E=Es[best], inliers=inl[best],
                        n_inliers=scores[best], best_score=scores[best])


# ---------------------------------------------------------------------------
# PnP refinement (RefinePose equivalent)
# ---------------------------------------------------------------------------


class PnPResult(NamedTuple):
    q: jnp.ndarray
    p: jnp.ndarray
    information: jnp.ndarray   # [6, 6] (JᵀWJ), tangent order [dθ, dp]
    mean_error_px: jnp.ndarray
    n_inliers: jnp.ndarray
    converged: jnp.ndarray


@partial(jax.jit, static_argnums=(6,))
def refine_pose(q0, p0, X_w, uv, intr4, valid, iterations: int = 10,
                huber_px: float = 3.0, min_inliers: int = 10) -> PnPResult:
    """GN refinement of a world-from-camera pose against 2D-3D pairs
    (pose_refiner_->RefinePose, visual_odometry.cpp LocalizeFrame :217).

    X_w [N,3], uv [N,2] undistorted pixels, intr4 = [fx, fy, cx, cy].
    Huber-reweighted; fixed iterations; masked.
    """
    dtype = uv.dtype
    fx, fy, cx, cy = intr4[0], intr4[1], intr4[2], intr4[3]

    def residual_all(q, p):
        X_c = lie.quat_rotate(lie.quat_conj(q)[None, :], X_w - p[None, :])
        z = jnp.maximum(X_c[:, 2], 1e-3)
        u = fx * X_c[:, 0] / z + cx
        v = fy * X_c[:, 1] / z + cy
        return jnp.stack([u, v], axis=-1) - uv

    def body(carry, _):
        q, p = carry
        r0 = residual_all(q, p)
        en = jnp.linalg.norm(r0, axis=1)
        w = jnp.where(en <= huber_px, 1.0, huber_px / jnp.maximum(en, 1e-9))
        w = w * valid.astype(dtype)

        def res_flat(delta):
            qq = lie.quat_mul(q, lie.so3_exp_quat(delta[0:3]))
            pp = p + delta[3:6]
            return (residual_all(qq, pp) * jnp.sqrt(w)[:, None]).reshape(-1)

        delta0 = jnp.zeros(6, dtype)
        r = res_flat(delta0)
        J = jax.jacfwd(res_flat)(delta0)
        H = J.T @ J + 1e-6 * jnp.eye(6, dtype=dtype)
        g = -J.T @ r
        delta = jnp.linalg.solve(H, g)
        okd = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(okd, delta, 0.0)
        q = lie.quat_normalize(lie.quat_mul(q, lie.so3_exp_quat(delta[0:3])))
        p = p + delta[3:6]
        return (q, p), (H, okd)

    (q, p), (Hs, oks) = jax.lax.scan(body, (q0, p0), None, length=iterations)
    r = residual_all(q, p)
    en = jnp.linalg.norm(r, axis=1)
    inl = valid & (en < 2 * huber_px)
    n_inl = jnp.sum(inl)
    mean_err = jnp.sum(en * inl) / jnp.maximum(n_inl, 1)
    return PnPResult(q=q, p=p, information=Hs[-1], mean_error_px=mean_err,
                     n_inliers=n_inl.astype(jnp.int32),
                     converged=(n_inl >= min_inliers) & oks[-1])
