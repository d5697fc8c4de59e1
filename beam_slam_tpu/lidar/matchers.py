"""General point-cloud matchers: ICP (point-to-point), GICP-style
(point-to-plane), and NDT-style (voxel Gaussian) registration.

The reference's MultiScanRegistration supports matcher variants ICP / GICP /
NDT / LOAM through libbeam's ``beam_matching::Matchers.h``
(multi_scan_registration.h:18-139). The LOAM matcher lives in
:mod:`beam_slam_tpu.lidar.registration`; this module provides the
non-feature-based variants with the same recipe: brute-force
correspondence over dense distance matrices, batched closed-form fits, fixed GN
iterations with masked weights.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.ops.knn import knn_topk


class MatcherConfig(NamedTuple):
    iterations: int = 10
    max_corr_dist: float = 1.0
    k_normal: int = 8          # neighbors for normal estimation (GICP)
    min_inliers: int = 30
    huber_delta: float = 0.5
    max_rot_step: float = 0.2
    max_trans_step: float = 1.0


class MatchResult(NamedTuple):
    q: jnp.ndarray
    p: jnp.ndarray
    information: jnp.ndarray
    mean_residual: jnp.ndarray
    n_inliers: jnp.ndarray
    converged: jnp.ndarray


def _gn_register(src, src_valid, residual_geom_fn, q0, p0,
                 cfg: MatcherConfig):
    """Shared fixed-iteration GN loop. ``residual_geom_fn(pts_world,
    valid)`` returns per-point (target geometry..., weights) and a residual
    closure maker."""
    dtype = src.dtype

    def body(carry, _):
        q, p = carry
        world = lie.quat_rotate(q[None, :], src) + p[None, :]
        make_res, w = residual_geom_fn(world, src_valid)

        def residuals(delta):
            dq = lie.so3_exp_quat(delta[0:3])
            q_new = lie.quat_mul(q, dq)
            p_new = p + delta[3:6]
            pts = lie.quat_rotate(q_new[None, :], src) + p_new[None, :]
            r = make_res(pts)
            # Huber via sqrt-weight
            a = jnp.abs(r)
            hw = jnp.where(a <= cfg.huber_delta, 1.0,
                           cfg.huber_delta / jnp.maximum(a, 1e-9))
            return r * jnp.sqrt(hw) * w

        d0 = jnp.zeros(6, dtype)
        r = residuals(d0)
        J = jax.jacfwd(residuals)(d0)
        H = J.T @ J + 1e-4 * jnp.eye(6, dtype=dtype)
        delta = jnp.linalg.solve(H, -J.T @ r)
        ok = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(ok, delta, 0.0)
        rn = jnp.linalg.norm(delta[0:3])
        tn = jnp.linalg.norm(delta[3:6])
        delta = delta.at[0:3].multiply(
            jnp.minimum(1.0, cfg.max_rot_step / jnp.maximum(rn, 1e-12)))
        delta = delta.at[3:6].multiply(
            jnp.minimum(1.0, cfg.max_trans_step / jnp.maximum(tn, 1e-12)))
        cost0 = jnp.sum(r * r)
        cost1 = jnp.sum(residuals(delta) ** 2)
        delta = jnp.where(ok & (cost1 < cost0), delta, 0.0)
        q_new = lie.quat_normalize(
            lie.quat_mul(q, lie.so3_exp_quat(delta[0:3])))
        p_new = p + delta[3:6]
        n_in = jnp.sum(w > 0)
        mean_r = jnp.sum(jnp.abs(r)) / jnp.maximum(jnp.sum(w > 0), 1)
        return (q_new, p_new), (H, n_in, mean_r, ok)

    (q, p), (Hs, n_ins, mean_rs, oks) = jax.lax.scan(
        body, (q0.astype(dtype), p0.astype(dtype)), None,
        length=cfg.iterations)
    conv = (n_ins[-1] >= cfg.min_inliers) & oks[-1]
    return MatchResult(q=q, p=p, information=Hs[-1],
                       mean_residual=mean_rs[-1],
                       n_inliers=n_ins[-1].astype(jnp.int32), converged=conv)


def icp_point_to_point(src, src_valid, tgt, tgt_valid, q0, p0,
                       cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """Classic ICP: nearest-target-point distance residuals (3 per point)."""

    def geom(world, valid):
        idx, d2 = knn_topk(world, tgt, tgt_valid, 1)
        nn = tgt[idx[:, 0]]
        w = (valid & (d2[:, 0] < cfg.max_corr_dist ** 2)
             & jnp.isfinite(d2[:, 0])).astype(world.dtype)

        def make_res(pts):
            return (pts - nn).reshape(-1)

        return make_res, jnp.repeat(w, 3)

    return _gn_register(src, src_valid, geom, q0, p0, cfg)


def ndt_voxel_gaussian(src, src_valid, tgt, tgt_valid, q0, p0,
                       cfg: MatcherConfig = MatcherConfig(),
                       voxel: float = 1.0,
                       grid_dims=(40, 40, 16)) -> MatchResult:
    """NDT-style registration: the target is modelled as per-voxel Gaussians
    (mean + covariance); each source point is scored by the Mahalanobis
    distance to its voxel's distribution.

    Static-shape formulation: a dense static voxel grid (scatter-add moments,
    batched 3×3 whitening factors) with point→cell gathers — no hash maps,
    no data-dependent shapes.
    """
    dtype = src.dtype
    G = grid_dims[0] * grid_dims[1] * grid_dims[2]
    dims = jnp.asarray(grid_dims, jnp.int32)

    # grid anchored at the target cloud's min corner
    tgt_safe = jnp.where(tgt_valid[:, None], tgt, jnp.inf)
    origin = jnp.min(tgt_safe, axis=0) - 0.5 * voxel
    origin = jnp.where(jnp.isfinite(origin), origin, 0.0)

    def cell_of(pts):
        c = jnp.floor((pts - origin) / voxel).astype(jnp.int32)
        inside = jnp.all((c >= 0) & (c < dims), axis=1)
        c = jnp.clip(c, 0, dims - 1)
        flat = (c[:, 0] * grid_dims[1] + c[:, 1]) * grid_dims[2] + c[:, 2]
        return flat, inside

    flat_t, inside_t = cell_of(tgt)
    w_t = (tgt_valid & inside_t).astype(dtype)
    cnt = jnp.zeros((G,), dtype).at[flat_t].add(w_t)
    s1 = jnp.zeros((G, 3), dtype).at[flat_t].add(tgt * w_t[:, None])
    s2 = jnp.zeros((G, 3, 3), dtype).at[flat_t].add(
        jnp.einsum("ni,nj->nij", tgt, tgt) * w_t[:, None, None])
    n_safe = jnp.maximum(cnt, 1.0)
    mu = s1 / n_safe[:, None]
    cov = s2 / n_safe[:, None, None] - jnp.einsum("ni,nj->nij", mu, mu)
    # regularize: NDT floors the covariance so thin cells stay usable
    cov = cov + (0.05 * voxel) ** 2 * jnp.eye(3, dtype=dtype)[None]
    occupied = cnt >= 3
    L = jnp.linalg.cholesky(jnp.linalg.inv(cov))
    L = jnp.where(jnp.isfinite(L).all(axis=(1, 2))[:, None, None], L, 0.0)

    def geom(world, valid):
        flat, inside = cell_of(world)
        ok = valid & inside & occupied[flat]
        mu_p = mu[flat]
        L_p = L[flat]
        w = ok.astype(dtype)

        def make_res(pts):
            return jnp.einsum("nij,nj->ni", L_p, pts - mu_p).reshape(-1)

        return make_res, jnp.repeat(w, 3)

    return _gn_register(src, src_valid, geom, q0, p0, cfg)


def gicp_point_to_plane(src, src_valid, tgt, tgt_valid, q0, p0,
                        cfg: MatcherConfig = MatcherConfig()) -> MatchResult:
    """GICP-style: project the point-to-nearest error onto the local target
    surface normal (plane fit over k neighbors)."""

    def geom(world, valid):
        idx, d2 = knn_topk(world, tgt, tgt_valid, cfg.k_normal)
        nb = tgt[idx]                              # [N, k, 3]
        centroid = jnp.mean(nb, axis=1)
        X = nb - centroid[:, None, :]
        S = jnp.einsum("nki,nkj->nij", X, X)
        # normal = smallest-eigenvector via two deflated power iterations
        d1 = jnp.broadcast_to(jnp.asarray([1.0, 0, 0], world.dtype),
                              centroid.shape) + 0.01 * centroid
        for _ in range(4):
            d1 = jnp.einsum("nij,nj->ni", S, d1)
            d1 = d1 / jnp.maximum(
                jnp.linalg.norm(d1, axis=1, keepdims=True), 1e-9)
        lam1 = jnp.einsum("ni,nij,nj->n", d1, S, d1)
        S2 = S - lam1[:, None, None] * jnp.einsum("ni,nj->nij", d1, d1)
        d2v = jnp.cross(d1, jnp.asarray([0.577, 0.577, 0.578], world.dtype))
        for _ in range(4):
            d2v = jnp.einsum("nij,nj->ni", S2, d2v)
            d2v = d2v / jnp.maximum(
                jnp.linalg.norm(d2v, axis=1, keepdims=True), 1e-9)
        normal = jnp.cross(d1, d2v)
        normal = normal / jnp.maximum(
            jnp.linalg.norm(normal, axis=1, keepdims=True), 1e-9)
        ok = (valid & (d2[:, 0] < cfg.max_corr_dist ** 2)
              & jnp.isfinite(d2[:, 0])
              & jnp.all(jnp.isfinite(normal), axis=1))
        normal = jnp.where(ok[:, None], normal, 0.0)
        cen = jnp.where(ok[:, None], centroid, 0.0)
        w = ok.astype(world.dtype)

        def make_res(pts):
            return jnp.einsum("ni,ni->n", pts - cen, normal)

        return make_res, w

    return _gn_register(src, src_valid, geom, q0, p0, cfg)
