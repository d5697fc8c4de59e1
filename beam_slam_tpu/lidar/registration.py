"""LOAM scan-to-map registration as a fixed-iteration batched GN kernel.

Replacement for libbeam's ``LoamMatcher`` as driven by the
reference's ScanToMapLoamRegistration (bs_models/src/lib/scan_registration/
scan_to_map_registration.cpp) and MultiScanLoamRegistration
(multi_scan_registration.cpp): point-to-line residuals on edge features and
point-to-plane residuals on surface features against a feature map, solved by
Gauss-Newton on the 6-dof pose.

Design (SURVEY.md §7.5):
  * correspondence search is brute-force k-NN via a dense distance matrix
    (‖a‖² + ‖b‖² − 2a·bᵀ — one matmul, ops/knn.py) with masking, instead of
    kd-trees;
  * line/plane fits are closed-form per-correspondence batched ops (power
    iteration for the principal direction, small least-squares for normals);
  * the GN loop is a fixed number of iterations with masked inlier weights —
    static shapes throughout, one compiled kernel per (scan-cap, map-cap).
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar.cloud import FeatureCloud
from beam_slam_tpu.ops.knn import knn_topk


class LoamRegistrationConfig(NamedTuple):
    # Total GN step budget. corr_refits=0 (default) runs the ADAPTIVE
    # schedule: correspondences are refit (k-NN + line/plane fits — the
    # expensive stage) whenever the pose has moved more than
    # ``refit_rot_tol``/``refit_trans_tol`` since the last fit, and reused
    # otherwise (a lax.cond skips the k-NN entirely). Near convergence the
    # pose stops moving, the assignments are provably stable, and the
    # remaining GN steps cost only the cheap residual solve — recovering the
    # A-LOAM schedule's amortization without its staleness risk.
    #
    # Measured caution (round-3 regression root cause): taking >1 GN step on
    # *stale* correspondences overshoots past where the correspondences
    # change and lands the alternation in a false local minimum ~13 cm off
    # (tests/test_sensor_log.py replay-LIO went 11x over its ATE bound when
    # the default dropped to 2 refits x 4 steps). The movement gate avoids
    # exactly that: any step large enough to change assignments exceeds the
    # tolerance and forces a refit before the next step.
    #
    # corr_refits>0 is the legacy fixed schedule: that many fits, each
    # followed by ceil(iterations/corr_refits) fixed-correspondence steps
    # (used by the offline refinement tiers that want refit-every-step
    # deterministically: corr_refits=iterations).
    iterations: int = 8
    corr_refits: int = 0
    # adaptive-schedule movement gates (pose change since the last fit that
    # forces a correspondence refit). Scale intuition: neighbor sets change
    # when points move a noticeable fraction of the feature spacing (~5-10
    # cm on a VLP-16 map); 5 mm / 0.2 deg is ~10x below that, so reused
    # assignments are exact in practice. 0 disables reuse (refit every step).
    refit_rot_tol: float = 0.0035
    refit_trans_tol: float = 0.005
    k_edge: int = 5
    # k_surf must be large enough to reach across scan rings: the k nearest
    # neighbors of a surface point are often collinear along its own ring,
    # which leaves the plane normal unconstrained and biases the solve.
    k_surf: int = 10
    max_corr_dist: float = 1.0         # correspondence gate (m)
    edge_eig_ratio_min: float = 3.0    # λ1/λ2 gate for valid line fit
    plane_fit_tol: float = 0.1         # max |residual| of plane fit points (m)
    # rank-2 gate: 2nd principal scatter eigenvalue must be a real fraction of
    # the 1st, otherwise the neighbor set is a line, not a plane.
    plane_planarity_min: float = 0.02
    min_inliers: int = 20
    # per-iteration trust region (rad / m)
    max_rot_step: float = 0.1
    max_trans_step: float = 0.5
    # correspondence search mode: "knn" (gather top-k + neighbor fits) or
    # "radius" (fixed-radius neighborhood MOMENTS via masked matmuls, see
    # _radius_moments). Measured on the synthetic VLP-16 scene: radius
    # converges (0.6 cm from cm-level seeds with the gates below) but kNN is
    # ~6x more accurate and has a wider convergence basin — fixed-radius
    # balls cannot adapt to ring-spacing anisotropy, so ~10% of fits mix
    # structures. kNN stays the default; radius is the mode for DENSE maps
    # (e.g. aggregated submaps) where its locality matches the data.
    corr_mode: str = "knn"
    edge_radius: float = 0.35
    surf_radius: float = 0.3
    radius_min_neighbors: int = 5
    # rms point-plane gate for radius mode (λ₃/n); the kNN mode gates each
    # neighbor at plane_fit_tol instead
    plane_rms_tol: float = 0.03


class RegistrationResult(NamedTuple):
    q: jnp.ndarray             # [4] refined T_MAP_SCAN rotation
    p: jnp.ndarray             # [3] refined translation
    information: jnp.ndarray   # [6, 6] GN information (JᵀWJ), tangent order [dθ, dp]
    mean_residual: jnp.ndarray  # [] mean |inlier residual|
    n_inliers: jnp.ndarray     # [] int
    converged: jnp.ndarray     # [] bool (enough inliers & finite solve)


def _edge_residuals(pts_map, pts_valid, map_edges, map_valid,
                    cfg: LoamRegistrationConfig):
    """Fit a line to the k-NN of each (map-frame) scan edge point; return the
    correspondence geometry (centroid, direction, weight) — held fixed for
    the GN step that follows (classic ICP-style alternation)."""
    idx, d2 = knn_topk(pts_map, map_edges, map_valid, cfg.k_edge)
    nb = map_edges[idx]                              # [N, k, 3]
    nb_ok = map_valid[idx] & jnp.isfinite(d2)
    centroid = jnp.mean(nb, axis=1)
    X = nb - centroid[:, None, :]
    S = jnp.einsum("nki,nkj->nij", X, X)             # [N, 3, 3] scatter

    # principal direction via shifted power iteration (deterministic init)
    d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], pts_map.dtype),
                         centroid.shape) + 0.01 * centroid
    for _ in range(4):
        d = jnp.einsum("nij,nj->ni", S, d)
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    lam1 = jnp.einsum("ni,nij,nj->n", d, S, d)
    lam_rest = 0.5 * (jnp.trace(S, axis1=1, axis2=2) - lam1)
    line_ok = lam1 > cfg.edge_eig_ratio_min * jnp.maximum(lam_rest, 1e-9)

    # sanitize: any non-finite fit must contribute exactly zero (NaN·0 = NaN
    # would otherwise leak into the GN system through masked rows)
    finite = (jnp.all(jnp.isfinite(centroid), axis=1)
              & jnp.all(jnp.isfinite(d), axis=1))
    centroid = jnp.where(finite[:, None], centroid, 0.0)
    d = jnp.where(finite[:, None], d, jnp.asarray([1.0, 0.0, 0.0], d.dtype))

    w = (pts_valid & line_ok & finite & jnp.all(nb_ok, axis=1)
         & (d2[:, 0] < cfg.max_corr_dist ** 2))
    return centroid, d, w


def _plane_residuals(pts_map, pts_valid, map_surfs, map_valid,
                     cfg: LoamRegistrationConfig):
    """Fit a plane to the k-NN of each scan surface point; returns
    (unit normal, offset, weight) with the plane as n·x + offset = 0.

    The normal comes from the *centered* neighbor scatter (smallest
    principal direction = cross of the two largest, via power iteration +
    deflation — all fusible elementwise math). The A-LOAM ``n·x + 1 = 0``
    least-squares form solves Σ x xᵀ, whose condition number grows like
    (range / patch size)² — catastrophically ill-conditioned in f32 for
    far-away patches; the centered scatter is invariant to the patch's
    distance from the origin."""
    idx, d2 = knn_topk(pts_map, map_surfs, map_valid, cfg.k_surf)
    nb = map_surfs[idx]                              # [N, k, 3]
    nb_ok = map_valid[idx] & jnp.isfinite(d2)
    centroid = jnp.mean(nb, axis=1)
    X = nb - centroid[:, None, :]
    S = jnp.einsum("nki,nkj->nij", X, X)
    d1 = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], nb.dtype),
                          centroid.shape) + 0.01 * centroid
    for _ in range(4):
        d1 = jnp.einsum("nij,nj->ni", S, d1)
        d1 = d1 / jnp.maximum(jnp.linalg.norm(d1, axis=1, keepdims=True), 1e-9)
    lam1 = jnp.einsum("ni,nij,nj->n", d1, S, d1)
    # deflate and find λ2
    S2 = S - lam1[:, None, None] * jnp.einsum("ni,nj->nij", d1, d1)
    d2v = jnp.cross(d1, jnp.asarray([0.577, 0.577, 0.578], nb.dtype))
    for _ in range(4):
        d2v = jnp.einsum("nij,nj->ni", S2, d2v)
        d2v = d2v / jnp.maximum(jnp.linalg.norm(d2v, axis=1, keepdims=True),
                                1e-9)
    lam2 = jnp.einsum("ni,nij,nj->n", d2v, S2, d2v)
    # planarity gate: neighbor scatter must be rank ≥ 2 (collinear same-ring
    # neighbor sets fit a plane perfectly but leave its normal free)
    planar = lam2 > cfg.plane_planarity_min * jnp.maximum(lam1, 1e-9)

    # plane normal ⊥ the two principal in-plane directions
    n_raw = jnp.cross(d1, d2v)
    n_norm = jnp.maximum(jnp.linalg.norm(n_raw, axis=1, keepdims=True), 1e-9)
    n_hat = n_raw / n_norm
    offset = -jnp.einsum("ni,ni->n", n_hat, centroid)

    # sanitize non-finite fits (degenerate neighbor sets) before masking
    finite = (jnp.all(jnp.isfinite(n_hat), axis=1) & jnp.isfinite(offset)
              & planar)
    n_hat = jnp.where(finite[:, None], n_hat,
                      jnp.asarray([0.0, 0.0, 1.0], n_hat.dtype))
    offset = jnp.where(finite, offset, 0.0)

    # fit quality: every neighbor close to the plane
    fit_res = jnp.abs(jnp.einsum("nki,ni->nk", nb, n_hat)
                      + offset[:, None])
    plane_ok = jnp.all(fit_res < cfg.plane_fit_tol, axis=1)
    w = (pts_valid & plane_ok & finite & jnp.all(nb_ok, axis=1)
         & (d2[:, 0] < cfg.max_corr_dist ** 2))
    return n_hat, offset, w


def _radius_moments(query, ref, ref_valid, rad: float, chunk: int = 512):
    """Zeroth/first/second moments of each query's fixed-radius neighborhood
    (the radius-mode correspondence search).

    Instead of gather-based k-NN (sort + irregular gathers), accumulate
      n  = Σ_r [d²(q,r) < rad²]            (count)
      m1 = Σ_r w·r                          (sum)
      m2 = Σ_r w·(r rᵀ)                     (scatter, 9 cols)
    as W @ [1, r, rr9] over [chunk, R] mask blocks — matmuls only, no
    top-k, no gather. Line/plane fits need exactly these moments (centroid +
    scatter), so the neighbor SET is never materialized.
    """
    R3 = jnp.where(ref_valid[:, None], ref, jnp.asarray(1e5, ref.dtype))
    r_sq = jnp.sum(R3 * R3, axis=1)
    outer9 = (R3[:, :, None] * R3[:, None, :]).reshape(-1, 9)
    aug = jnp.concatenate(
        [jnp.ones((R3.shape[0], 1), R3.dtype), R3, outer9], axis=1)
    Q = query.shape[0]
    Qp = -(-Q // chunk) * chunk
    qpad = jnp.zeros((Qp, 3), query.dtype).at[:Q].set(query)

    def body(qc):
        d2 = (jnp.sum(qc * qc, axis=1, keepdims=True) + r_sq[None, :]
              - 2.0 * qc @ R3.T)
        W = (d2 < rad * rad).astype(qc.dtype)
        return W @ aug

    mom = jax.lax.map(body, qpad.reshape(-1, chunk, 3)).reshape(Qp, 13)[:Q]
    n = mom[:, 0]
    safe_n = jnp.maximum(n, 1.0)
    c = mom[:, 1:4] / safe_n[:, None]
    S = (mom[:, 4:13].reshape(-1, 3, 3)
         - safe_n[:, None, None] * (c[:, :, None] * c[:, None, :]))
    return n, c, S


def _principal_dirs(S, c):
    """Top-2 principal directions + eigenvalues of per-point 3×3 scatters
    (shifted power iteration + deflation — shared by the kNN and radius
    correspondence fits)."""
    d1 = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], S.dtype),
                          c.shape) + 0.01 * c
    for _ in range(4):
        d1 = jnp.einsum("nij,nj->ni", S, d1)
        d1 = d1 / jnp.maximum(jnp.linalg.norm(d1, axis=1, keepdims=True),
                              1e-9)
    lam1 = jnp.einsum("ni,nij,nj->n", d1, S, d1)
    S2 = S - lam1[:, None, None] * (d1[:, :, None] * d1[:, None, :])
    d2v = jnp.cross(d1, jnp.asarray([0.577, 0.577, 0.578], S.dtype))
    for _ in range(4):
        d2v = jnp.einsum("nij,nj->ni", S2, d2v)
        d2v = d2v / jnp.maximum(jnp.linalg.norm(d2v, axis=1, keepdims=True),
                                1e-9)
    lam2 = jnp.einsum("ni,nij,nj->n", d2v, S2, d2v)
    return d1, lam1, d2v, lam2


def _edge_residuals_radius(pts_map, pts_valid, map_edges, map_valid,
                           cfg: LoamRegistrationConfig):
    """Line fit from fixed-radius neighborhood moments (matmul path)."""
    n, c, S = _radius_moments(pts_map, map_edges, map_valid,
                              cfg.edge_radius)
    d1, lam1, _, lam2 = _principal_dirs(S, c)
    lam_rest = 0.5 * jnp.maximum(
        jnp.trace(S, axis1=1, axis2=2) - lam1, 0.0)
    line_ok = lam1 > cfg.edge_eig_ratio_min * jnp.maximum(lam_rest, 1e-9)
    finite = (jnp.all(jnp.isfinite(c), axis=1)
              & jnp.all(jnp.isfinite(d1), axis=1))
    c = jnp.where(finite[:, None], c, 0.0)
    d1 = jnp.where(finite[:, None], d1,
                   jnp.asarray([1.0, 0.0, 0.0], d1.dtype))
    w = pts_valid & line_ok & finite & (n >= cfg.radius_min_neighbors)
    return c, d1, w


def _plane_residuals_radius(pts_map, pts_valid, map_surfs, map_valid,
                            cfg: LoamRegistrationConfig):
    """Plane fit from fixed-radius neighborhood moments (matmul path).

    Fit quality uses the smallest scatter eigenvalue: rms point-plane
    distance² = λ₃/n (the neighbor list is never materialized)."""
    n, c, S = _radius_moments(pts_map, map_surfs, map_valid,
                              cfg.surf_radius)
    d1, lam1, d2v, lam2 = _principal_dirs(S, c)
    planar = lam2 > cfg.plane_planarity_min * jnp.maximum(lam1, 1e-9)
    n_raw = jnp.cross(d1, d2v)
    n_norm = jnp.maximum(jnp.linalg.norm(n_raw, axis=1, keepdims=True), 1e-9)
    n_hat = n_raw / n_norm
    offset = -jnp.einsum("ni,ni->n", n_hat, c)
    lam3 = jnp.maximum(jnp.trace(S, axis1=1, axis2=2) - lam1 - lam2, 0.0)
    rms2 = lam3 / jnp.maximum(n, 1.0)
    flat_ok = rms2 < cfg.plane_rms_tol ** 2
    finite = (jnp.all(jnp.isfinite(n_hat), axis=1) & jnp.isfinite(offset)
              & planar)
    n_hat = jnp.where(finite[:, None], n_hat,
                      jnp.asarray([0.0, 0.0, 1.0], n_hat.dtype))
    offset = jnp.where(finite, offset, 0.0)
    w = (pts_valid & flat_ok & finite & planar
         & (n >= cfg.radius_min_neighbors))
    return n_hat, offset, w


@partial(jax.jit, static_argnames=("cfg",))
def register_loam(scan: FeatureCloud, map_edges, map_edges_valid,
                  map_surfs, map_surfs_valid, q0, p0,
                  cfg: LoamRegistrationConfig = LoamRegistrationConfig()
                  ) -> RegistrationResult:
    """Refine T_MAP_SCAN = (q, p) from the initial guess (q0, p0).

    Jitted at module level (static ``cfg``): eager execution re-traced the
    inner GN ``lax.scan`` on every call — a per-scan compile storm that
    exhausted LLVM section mappings on long sessions.

    ``scan`` features are in the scan frame; maps are world/map-frame point
    sets (strong+weak features concatenated by the caller).
    """
    # scan side: STRONG edges only (classic LOAM matches sharp scan points
    # against the denser map; weak scan "edges" are often ring-arc artifacts
    # whose line fits are viewpoint-dependent and creep the solution — the
    # observed failure mode was ~0.15°/iteration rotation drift)
    edges = jnp.concatenate([scan.edge_strong, scan.edge_weak], axis=0)
    edges_valid = jnp.concatenate([scan.edge_strong_valid,
                                   jnp.zeros_like(scan.edge_weak_valid)],
                                  axis=0)
    surfs = jnp.concatenate([scan.surf_strong, scan.surf_weak], axis=0)
    surfs_valid = jnp.concatenate([scan.surf_strong_valid,
                                   scan.surf_weak_valid], axis=0)
    dtype = edges.dtype

    refits = max(1, min(cfg.corr_refits or cfg.iterations, cfg.iterations))
    inner_steps = -(-cfg.iterations // refits)  # ceil

    def fit_corr(q, p):
        """Correspondence fit at the current estimate (the expensive stage:
        two k-NN searches + neighbor line/plane fits)."""
        e_map = lie.quat_rotate(q[None, :], edges) + p[None, :]
        s_map = lie.quat_rotate(q[None, :], surfs) + p[None, :]
        if cfg.corr_mode == "radius":
            cen, dirs, w_e = _edge_residuals_radius(
                e_map, edges_valid, map_edges, map_edges_valid, cfg)
            n_hat, off, w_s = _plane_residuals_radius(
                s_map, surfs_valid, map_surfs, map_surfs_valid, cfg)
        else:
            cen, dirs, w_e = _edge_residuals(e_map, edges_valid, map_edges,
                                             map_edges_valid, cfg)
            n_hat, off, w_s = _plane_residuals(s_map, surfs_valid, map_surfs,
                                               map_surfs_valid, cfg)
        return (cen, dirs, w_e, n_hat, off, w_s)

    def gn_step(q, p, corr):
        """One fixed-correspondence GN step (the Ceres-solve analog)."""
        cen, dirs, w_e, n_hat, off, w_s = corr
        n_in = jnp.sum(w_e) + jnp.sum(w_s)

        def residuals(delta):
            dq = lie.so3_exp_quat(delta[0:3])
            q_new = lie.quat_mul(q, dq)
            p_new = p + delta[3:6]
            e = lie.quat_rotate(q_new[None, :], edges) + p_new[None, :]
            s = lie.quat_rotate(q_new[None, :], surfs) + p_new[None, :]
            # point-to-line distance; eps-guarded sqrt: the plain norm
            # has a NaN jacfwd gradient when the cross product is
            # exactly zero (point on the line), which poisons the GN
            # system.
            cr = jnp.cross(e - cen, dirs)
            r_e = jnp.sqrt(jnp.sum(cr * cr, axis=1) + 1e-12)
            r_s = jnp.einsum("ni,ni->n", s, n_hat) + off  # pt-to-plane
            return jnp.concatenate([r_e * w_e, r_s * w_s])

        delta0 = jnp.zeros(6, dtype)
        r = residuals(delta0)
        J = jax.jacfwd(residuals)(delta0)
        H = J.T @ J
        g = -J.T @ r
        Hd = H + 1e-4 * jnp.eye(6, dtype=dtype)
        delta = jnp.linalg.solve(Hd, g)
        ok = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(ok, delta, 0.0)
        # trust region: a refit with a degenerate correspondence set can
        # produce one catastrophic step that the remaining iterations
        # never recover from — clamp rotation/translation step norms...
        rot_n = jnp.linalg.norm(delta[0:3])
        tr_n = jnp.linalg.norm(delta[3:6])
        delta = delta.at[0:3].multiply(jnp.minimum(
            1.0, cfg.max_rot_step / jnp.maximum(rot_n, 1e-12)))
        delta = delta.at[3:6].multiply(jnp.minimum(
            1.0, cfg.max_trans_step / jnp.maximum(tr_n, 1e-12)))
        # ...and reject any step that increases the
        # (fixed-correspondence) cost.
        cost0 = jnp.sum(r * r)
        cost1 = jnp.sum(residuals(delta) ** 2)
        accept = ok & (cost1 < cost0)
        delta = jnp.where(accept, delta, 0.0)
        q_new = lie.quat_normalize(
            lie.quat_mul(q, lie.so3_exp_quat(delta[0:3])))
        p_new = p + delta[3:6]
        mean_r = jnp.sum(jnp.abs(r)) / jnp.maximum(n_in, 1)
        return (q_new, p_new), (H, n_in, mean_r, ok)

    adaptive = (cfg.corr_refits == 0
                and (cfg.refit_rot_tol > 0 or cfg.refit_trans_tol > 0))
    if adaptive:
        # movement-gated refit: k-NN + fits run only when the pose moved
        # enough since the last fit to change assignments; the lax.cond
        # skips the whole correspondence stage otherwise (steady-state
        # seeds converge after 1-2 refits → most iterations cost only the
        # 6-dof GN solve)
        q0d = q0.astype(dtype)
        p0d = p0.astype(dtype)
        corr0 = fit_corr(q0d, p0d)

        def body(carry, _):
            q, p, corr, q_ref, p_ref = carry
            dq_m = lie.quat_mul(lie.quat_conj(q_ref), q)
            moved = ((jnp.linalg.norm(lie.so3_log(dq_m))
                      > cfg.refit_rot_tol)
                     | (jnp.linalg.norm(p - p_ref) > cfg.refit_trans_tol))
            corr, q_ref, p_ref = jax.lax.cond(
                moved,
                lambda args: (fit_corr(args[0], args[1]), args[0], args[1]),
                lambda args: (args[2], args[3], args[4]),
                (q, p, corr, q_ref, p_ref))
            (q_new, p_new), (H, n_in, mean_r, ok) = gn_step(q, p, corr)
            return ((q_new, p_new, corr, q_ref, p_ref),
                    (H, n_in, mean_r, ok))

        (q, p, _, _, _), (Hs, n_ins, mean_rs, oks) = jax.lax.scan(
            body, (q0d, p0d, corr0, q0d, p0d), None,
            length=cfg.iterations)
    else:
        def refit_body(carry, _):
            q, p = carry
            corr = fit_corr(q, p)
            (q, p), (Hs, n_ins, mean_rs, oks) = jax.lax.scan(
                lambda c, _: gn_step(c[0], c[1], corr), (q, p), None,
                length=inner_steps)
            return (q, p), (Hs[-1], n_ins[-1], mean_rs[-1], oks[-1])

        (q, p), (Hs, n_ins, mean_rs, oks) = jax.lax.scan(
            refit_body, (q0.astype(dtype), p0.astype(dtype)), None,
            length=refits)
    H = Hs[-1]
    n_in = n_ins[-1]
    converged = (n_in >= cfg.min_inliers) & oks[-1]
    return RegistrationResult(q=q, p=p, information=H,
                              mean_residual=mean_rs[-1],
                              n_inliers=n_in.astype(jnp.int32),
                              converged=converged)


def sqrt_info_from_information(H: jnp.ndarray, scale: float = 1.0,
                               floor: float = 1e-4) -> jnp.ndarray:
    """Whitener A with AᵀA = scale·H for use in relative-pose factors
    (reference: covariance from Ceres or fixed, scan_registration_base.h).
    Falls back to floor·I if H is not SPD."""
    dtype = H.dtype
    Hs = scale * H + 1e-9 * jnp.eye(H.shape[0], dtype=dtype)
    L = jnp.linalg.cholesky(Hs)
    A = jnp.swapaxes(L, -1, -2)
    ok = jnp.all(jnp.isfinite(A))
    return jnp.where(ok, A, floor * jnp.eye(H.shape[0], dtype=dtype))
