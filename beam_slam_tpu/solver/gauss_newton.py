"""Batched Levenberg–Marquardt over the fixed-shape window state, with
Schur-complement elimination of landmarks.

This is the batched replacement for the Ceres solve inside
``fuse_graphs::HashGraph::optimize`` (driven by the reference fixed-lag
smoother, bs_optimizers/src/fixed_lag_smoother.cpp:281 with
SPARSE_NORMAL_CHOLESKY, ≤10-40 iterations, ≤0.05 s — lvio.yaml:7-17).

Design (SURVEY.md §7.2):
  * Every factor family linearizes in one ``vmap`` (residual + Jacobian via
    forward-mode autodiff), producing whitened blocks.
  * The normal equations are assembled densely over the window's tangent dof
    (K·15 IMU dof + E·6 extrinsic dof) with scatter-adds. Landmark blocks
    (visual BA) are **Schur-eliminated on chip**: per-landmark 3×3 diagonal
    blocks H_ll, the pose-landmark coupling W, and the reduced camera system
    H_red = H_pp − W·H_ll⁻¹·Wᵀ — one matmul — then dense Cholesky on the
    reduced system and closed-form landmark back-substitution.
  * Jacobi equilibration makes the reduced system ~unit-diagonal so float32
    Cholesky is accurate (validated against f64 oracles in tests).
  * The LM loop is a ``lax.scan`` of a fixed number of iterations with
    in-graph accept/reject ("delayed gratification" damping) and an inert
    ``done`` latch — compiler-friendly control flow, no recompiles, no host
    sync inside the loop.

``holdVariable`` (fuse) and inactive slots are handled by masking rows/columns
of H (and W / H_ll for landmarks) and pinning those dof to zero update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from beam_slam_tpu.core.window import LANDMARK_DOF, WindowState
# Closed-form cofactor inverse of batched 3x3 SPD blocks: pure elementwise
# math that XLA fuses into the surrounding Schur computation — replaces
# the batched LU custom-call of jnp.linalg.inv (a kernel launch + unfusible
# op per LM iteration). The damped blocks are floored well away from
# singularity (see _solve_damped), so the adjugate form is safe.
from beam_slam_tpu.ops.mat3 import inv3x3 as _inv3x3
from beam_slam_tpu.ops import smallmat as _sm

_DIAG_EPS = 1e-12


def _gram(J: jnp.ndarray) -> jnp.ndarray:
    """Per-factor JᵀJ ([..., R, D] → [..., D, D]). For tiny residual dims the
    batched-dot lowering makes every factor's [D,R]@[R,D] its own padded
    matmul tile (see ops/smallmat.py); broadcast-mul-reduce keeps it
    elementwise. Larger R stays a matmul."""
    if J.shape[-2] <= 4:
        return _sm.gram_r(J)
    return jnp.einsum("...ri,...rj->...ij", J, J)


def _jtr(J: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Per-factor Jᵀr ([..., R, D], [..., R] → [..., D])."""
    if J.shape[-2] <= 4:
        return _sm.jtr(J, r)
    return jnp.einsum("...ri,...r->...i", J, r)


def _cross(Ja: jnp.ndarray, Jb: jnp.ndarray) -> jnp.ndarray:
    """Per-factor JaᵀJb ([...,R,Da], [...,R,Db] → [..., Da, Db])."""
    if Ja.shape[-2] <= 4:
        return _sm.cross_r(Ja, Jb)
    return jnp.einsum("...rd,...rc->...dc", Ja, Jb)


class SolverOptions(NamedTuple):
    """Solve configuration. Mirrors the solver_options block of the
    reference configs (beam_slam_launch/config/lvio.yaml:7-17).

    ``max_iterations`` is a *runtime* limit (traced — changing it does NOT
    recompile); the compiled LM scan always has ``scan_length`` steps, with
    iterations beyond the limit inert (computed, then discarded — they cost
    full time!). ``scan_length=None`` (default) compiles exactly
    ``max_iterations`` steps; set it explicitly only when one executable
    must serve several different runtime iteration budgets.
    """

    max_iterations: int = 10
    function_tolerance: float = 1e-6
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    scan_length: Optional[int] = None  # static compiled iteration capacity
    # True compiles the LM loop as a lax.while_loop that STOPS at
    # convergence instead of a fixed-length scan that computes-and-discards
    # the remaining iterations. Steady-state smoother ticks converge in 1-3
    # iterations, so this trades the scan's static schedule for a ~3x
    # shorter average cycle (the Ceres behavior: iterate until
    # function_tolerance, never past max_iterations).
    early_exit: bool = False
    # Normal-equation assembly kernel: "scatter" (per-factor scatter-adds;
    # the fastest on the CPU and on the GPU), "dense" (one-hot expansion to
    # dense Jacobian rows + one JᵀJ matmul) or "blocks" (local Gram blocks +
    # region one-hot matmuls, no dense rows). All produce identical normal
    # equations (tests/test_solver.py asserts agreement).
    assembly: str = "scatter"


class SolveDiagnostics(NamedTuple):
    """Per-solve diagnostics mirroring the Ceres summary fields surfaced by
    the reference (fixed_lag_smoother.cpp:705-718: termination type, total
    time, iterations, initial/final cost)."""

    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    iterations: jnp.ndarray   # accepted LM steps
    converged: jnp.ndarray    # hit function_tolerance before max_iterations
    final_lambda: jnp.ndarray


def robust_weight(sq_norm: jnp.ndarray, loss_scale: Optional[float]):
    """IRLS weight + cost for a (optionally Cauchy-robustified) factor.

    The reference attaches ``fuse_loss::CauchyLoss`` to lidar/visual pose
    factors (bs_constraints/relative_pose/pose_3d_stamped_transaction.cpp).
    Cauchy: ρ(s) = c²·log(1 + s/c²); weight ρ'(s) = 1/(1 + s/c²).
    """
    if loss_scale is None:
        return jnp.ones_like(sq_norm), sq_norm
    c2 = loss_scale * loss_scale
    w = 1.0 / (1.0 + sq_norm / c2)
    rho = c2 * jnp.log1p(sq_norm / c2)
    return w, rho


def assemble_normal_equations(
    window: WindowState,
    families: Sequence,
    losses: Tuple[Optional[float], ...],
):
    """Linearize every factor family and scatter-add the normal equations.

    Returns (H [D+1,D+1], g [D+1], H_ll [L,3,3], g_l [L,3], W [D+1,L·3],
    cost). The last dense row/col is a padding ("trash") dof.
    """
    D = window.num_dense_dof
    L = window.landmarks.capacity
    dtype = window.imu.q.dtype
    H = jnp.zeros((D + 1, D + 1), dtype)
    g = jnp.zeros((D + 1,), dtype)
    H_ll = jnp.zeros((L, 3, 3), dtype)
    g_l = jnp.zeros((L, 3), dtype)
    W = jnp.zeros((D + 1, L * LANDMARK_DOF), dtype)
    cost = jnp.zeros((), dtype)

    for fam, loss in zip(families, losses):
        r, J, col, _, lm_slot, J_lm = fam.linearize(window)
        s = jnp.sum(r * r, axis=-1)
        w, rho = robust_weight(s, loss)
        cost = cost + 0.5 * jnp.sum(rho)
        sw = jnp.sqrt(w)
        r = r * sw[:, None]
        J = J * sw[:, None, None]
        # g -= Jᵀ r  (scatter over local columns)
        g = g.at[col].add(-_jtr(J, r))
        # H += Jᵀ J  (scatter [Dd, Dd] blocks)
        H = H.at[col[:, :, None], col[:, None, :]].add(_gram(J))
        if lm_slot is not None:
            J_lm = J_lm * sw[:, None, None]
            H_ll = H_ll.at[lm_slot].add(_gram(J_lm))
            g_l = g_l.at[lm_slot].add(-_jtr(J_lm, r))
            lm_cols = (lm_slot[:, None] * LANDMARK_DOF
                       + jnp.arange(LANDMARK_DOF, dtype=jnp.int32)[None, :])
            W = W.at[col[:, :, None], lm_cols[:, None, :]].add(_cross(J, J_lm))
    return H, g, H_ll, g_l, W, cost


def assemble_normal_equations_dense(
    window: WindowState,
    families: Sequence,
    losses: Tuple[Optional[float], ...],
):
    """Matmul-only assembly.

    Each factor's local Jacobian blocks are expanded to a dense row over the
    window's full dof via one-hot slot→column einsums (matmuls only, no
    scatters), all families' rows are stacked into one Jacobian J_all
    [N_rows, D+1] (plus a landmark-column matrix Jlm_all [N_rows, L·3]), and
    the normal equations come from single large matmuls:

        H = J_allᵀ J_all,  g = −J_allᵀ r,  W = J_allᵀ Jlm_all,

    with the per-landmark 3×3 blocks H_ll and g_l accumulated by small
    one-hot einsums. Identical output contract to
    :func:`assemble_normal_equations`.
    """
    from beam_slam_tpu.core import factors as fc
    from beam_slam_tpu.core.window import IMU_DOF, MOTION_DOF, POSE_DOF

    D = window.num_dense_dof
    K = window.imu.capacity
    E = window.extrinsics.capacity
    M = window.motion.capacity
    L = window.landmarks.capacity
    dtype = window.imu.q.dtype
    H_ll = jnp.zeros((L, 3, 3), dtype)
    g_l = jnp.zeros((L, 3), dtype)
    cost = jnp.zeros((), dtype)

    J_rows, r_rows, Jlm_rows = [], [], []
    for fam, loss in zip(families, losses):
        r, J, _, _, lm_slot, J_lm = fam.linearize(window)
        F, R = r.shape
        s = jnp.sum(r * r, axis=-1)
        w, rho = robust_weight(s, loss)
        cost = cost + 0.5 * jnp.sum(rho)
        sw = jnp.sqrt(w)
        r = r * sw[:, None]
        J = J * sw[:, None, None]

        # expand local dense blocks into [F, R, K*15], [F, R, E*6] and
        # [F, R, M*6] regions
        blocks = [k for k in type(fam).BLOCKS if k != fc.BLOCK_LANDMARK]
        J_imu = None
        J_ext = None
        J_mot = None
        o = 0
        for b, kind in enumerate(blocks):
            d = fc.block_dof(kind)
            Jb = J[:, :, o:o + d]
            o += d
            sl = fam.slots[:, b]
            if kind == fc.BLOCK_IMU:
                oh = jax.nn.one_hot(sl, K, dtype=dtype)
                part = jnp.einsum("frd,fk->frkd", Jb, oh)
                J_imu = part if J_imu is None else J_imu + part
            elif kind == fc.BLOCK_MOTION:
                oh = jax.nn.one_hot(sl, M, dtype=dtype)
                part = jnp.einsum("frd,fk->frkd", Jb, oh)
                J_mot = part if J_mot is None else J_mot + part
            else:
                oh = jax.nn.one_hot(sl, E, dtype=dtype)
                part = jnp.einsum("frd,fk->frkd", Jb, oh)
                J_ext = part if J_ext is None else J_ext + part
        row = jnp.concatenate([
            (J_imu.reshape(F, R, K * IMU_DOF) if J_imu is not None
             else jnp.zeros((F, R, K * IMU_DOF), dtype)),
            (J_ext.reshape(F, R, E * POSE_DOF) if J_ext is not None
             else jnp.zeros((F, R, E * POSE_DOF), dtype)),
            (J_mot.reshape(F, R, M * MOTION_DOF) if J_mot is not None
             else jnp.zeros((F, R, M * MOTION_DOF), dtype)),
        ], axis=-1)
        J_rows.append(row.reshape(F * R, D))
        r_rows.append(r.reshape(F * R))

        if lm_slot is not None:
            J_lm = J_lm * sw[:, None, None]
            oh_lm = jax.nn.one_hot(lm_slot, L, dtype=dtype)  # [F, L]
            # Pose-landmark coupling without materializing [F,R,L·3]:
            # contract the residual axis per factor first (each factor
            # touches exactly ONE landmark), then one small ohᵀ matmul.
            Cr = _cross(row.reshape(F, R, D), J_lm)
            W_fam = jnp.einsum("lf,fdk->dlk", oh_lm.T,
                               Cr).reshape(D, L * LANDMARK_DOF)
            Jlm_rows.append(W_fam)
            Hll_f = _gram(J_lm)
            H_ll = H_ll + jnp.einsum("lf,fij->lij", oh_lm.T, Hll_f)
            gl_f = _jtr(J_lm, r)
            g_l = g_l - jnp.einsum("lf,fi->li", oh_lm.T, gl_f)

    J_all = jnp.concatenate(J_rows, axis=0)
    r_all = jnp.concatenate(r_rows, axis=0)
    H_d = J_all.T @ J_all
    g_d = -(J_all.T @ r_all)

    W_parts = [p for p in Jlm_rows if p is not None]
    if W_parts:
        W_d = sum(W_parts)
    else:
        W_d = jnp.zeros((D, L * LANDMARK_DOF), dtype)

    # pad with the trailing "trash" dof to match the scatter path's contract
    H = jnp.zeros((D + 1, D + 1), dtype).at[:D, :D].set(H_d)
    g = jnp.zeros((D + 1,), dtype).at[:D].set(g_d)
    W = jnp.zeros((D + 1, L * LANDMARK_DOF), dtype).at[:D, :].set(W_d)
    return H, g, H_ll, g_l, W, cost


def assemble_normal_equations_blocks(
    window: WindowState,
    families: Sequence,
    losses: Tuple[Optional[float], ...],
):
    """Block-wise matmul assembly.

    The ``dense`` path expands every factor's local Jacobian to a dense row
    over the full window dof (``frd,fk->frkd`` one-hot einsums), whose
    [F, R, K·15] tensors cost layout copies + reshapes before the JᵀJ
    matmul. This path never materializes dense Jacobian rows:

      * per family, one batched matmul forms the local Gram blocks
        P[f] = J_fᵀ J_f  [F, Dl, Dl] and q[f] = J_fᵀ r_f;
      * contributions scatter into per-region accumulators
        (imu×imu [K,15,K,15], imu×ext [K,15,E,6], …) via *small* one-hot
        matmuls: slot one-hots [F, K] for single-block diagonals, slot-pair
        one-hots [F·n₁·n₂, K₁·K₂] for cross-block terms — all matmuls on
        tensors ~100× smaller than the dense rows;
      * the dense H is assembled from the regions with static slice writes.

    Identical output contract to :func:`assemble_normal_equations`
    (tests/test_solver.py asserts agreement of all three paths).
    """
    import numpy as np

    from beam_slam_tpu.core import factors as fc
    from beam_slam_tpu.core.window import IMU_DOF, MOTION_DOF, POSE_DOF

    D = window.num_dense_dof
    K = window.imu.capacity
    E = window.extrinsics.capacity
    M = window.motion.capacity
    L = window.landmarks.capacity
    dtype = window.imu.q.dtype

    KINDS = (fc.BLOCK_IMU, fc.BLOCK_EXTRINSIC, fc.BLOCK_MOTION)
    CAP = {fc.BLOCK_IMU: K, fc.BLOCK_EXTRINSIC: E, fc.BLOCK_MOTION: M}
    DOF = {fc.BLOCK_IMU: IMU_DOF, fc.BLOCK_EXTRINSIC: POSE_DOF,
           fc.BLOCK_MOTION: MOTION_DOF}
    ROFF = {fc.BLOCK_IMU: 0, fc.BLOCK_EXTRINSIC: K * IMU_DOF,
            fc.BLOCK_MOTION: K * IMU_DOF + E * POSE_DOF}
    ORD = {k: i for i, k in enumerate(KINDS)}

    A = {}        # canonical (kind1, kind2) -> [C1, d1, C2, d2]
    Adiag = {}    # kind -> [C, d, d] same-slot diagonal contributions
    g_reg = {k: jnp.zeros((CAP[k], DOF[k]), dtype) for k in KINDS}
    H_ll = jnp.zeros((L, 3, 3), dtype)
    g_l = jnp.zeros((L, 3), dtype)
    W_rows = {}   # kind -> [C·d, L·3] pose-landmark coupling rows
    cost = jnp.zeros((), dtype)

    for fam, loss in zip(families, losses):
        r, J, _, _, lm_slot, J_lm = fam.linearize(window)
        F = r.shape[0]
        s = jnp.sum(r * r, axis=-1)
        w, rho = robust_weight(s, loss)
        cost = cost + 0.5 * jnp.sum(rho)
        sw = jnp.sqrt(w)
        r = r * sw[:, None]
        J = J * sw[:, None, None]

        P = _gram(J)                              # [F, Dl, Dl]
        q = _jtr(J, r)                            # [F, Dl]

        # dense blocks grouped by kind: kind -> (block indices, local offs)
        blocks = [k for k in type(fam).BLOCKS if k != fc.BLOCK_LANDMARK]
        offs, o = [], 0
        for k in blocks:
            offs.append(o)
            o += fc.block_dof(k)
        groups = {}
        for b, k in enumerate(blocks):
            groups.setdefault(k, []).append((b, offs[b]))

        def _cols(kind):
            """Static local-column index array for the kind's blocks."""
            return np.concatenate([np.arange(off, off + DOF[kind])
                                   for _, off in groups[kind]])

        def _slots(kind):
            bs = [b for b, _ in groups[kind]]
            return fam.slots[:, bs]                       # [F, n]

        # gradient: g -= Jᵀ r, region-scattered by slot one-hots
        for kind in groups:
            n = len(groups[kind])
            d = DOF[kind]
            qg = jnp.take(q, _cols(kind), axis=1).reshape(F * n, d)
            oh = jax.nn.one_hot(_slots(kind).reshape(-1), CAP[kind],
                                dtype=dtype)
            g_reg[kind] = g_reg[kind] - jnp.einsum("xc,xd->cd", oh, qg)

        # Hessian blocks per canonical kind pair
        for k1 in groups:
            for k2 in groups:
                if ORD[k2] < ORD[k1]:
                    continue  # mirrored at dense-assembly time
                n1, n2 = len(groups[k1]), len(groups[k2])
                d1, d2 = DOF[k1], DOF[k2]
                c1, c2 = _cols(k1), _cols(k2)
                Ps = jnp.take(jnp.take(P, c1, axis=1), c2, axis=2)
                Ps = Ps.reshape(F, n1, d1, n2, d2)
                if k1 == k2 and n1 == 1:
                    # single same-kind block: diagonal contribution only
                    oh = jax.nn.one_hot(_slots(k1)[:, 0], CAP[k1],
                                        dtype=dtype)
                    contrib = jnp.einsum("fc,fde->cde", oh,
                                         Ps.reshape(F, d1, d2))
                    Adiag[k1] = Adiag.get(
                        k1, jnp.zeros((CAP[k1], d1, d1), dtype)) + contrib
                    continue
                # general: slot-pair one-hot over all ordered block combos
                # (same-kind groups cover both mirrored halves + diagonal)
                Ps = Ps.transpose(0, 1, 3, 2, 4).reshape(
                    F * n1 * n2, d1, d2)
                S1 = _slots(k1)
                S2 = _slots(k2)
                pair = (S1[:, :, None] * CAP[k2]
                        + S2[:, None, :]).reshape(-1)
                oh = jax.nn.one_hot(pair, CAP[k1] * CAP[k2], dtype=dtype)
                contrib = jnp.einsum("xp,xde->pde", oh, Ps).reshape(
                    CAP[k1], CAP[k2], d1, d2).transpose(0, 2, 1, 3)
                key = (k1, k2)
                A[key] = A.get(key, jnp.zeros(
                    (CAP[k1], d1, CAP[k2], d2), dtype)) + contrib

        # landmark system + pose-landmark coupling
        if lm_slot is not None:
            J_lm = J_lm * sw[:, None, None]
            oh_lm = jax.nn.one_hot(lm_slot, L, dtype=dtype)    # [F, L]
            Hll_f = _gram(J_lm)
            H_ll = H_ll + jnp.einsum("lf,fij->lij", oh_lm.T, Hll_f)
            gl_f = _jtr(J_lm, r)
            g_l = g_l - jnp.einsum("lf,fi->li", oh_lm.T, gl_f)
            Cr = _cross(J, J_lm)                               # [F, Dl, 3]
            for kind in groups:
                n = len(groups[kind])
                d = DOF[kind]
                C = CAP[kind]
                Cg = jnp.take(Cr, _cols(kind), axis=1).reshape(
                    F, n, d * LANDMARK_DOF).reshape(F * n, d * LANDMARK_DOF)
                oh_c = jax.nn.one_hot(_slots(kind).reshape(-1), C,
                                      dtype=dtype)
                oh_l = jnp.broadcast_to(oh_lm[:, None, :],
                                        (F, n, L)).reshape(F * n, L)
                # opt_einsum picks the 2-stage contraction order
                Wk = jnp.einsum("xc,xd,xl->cdl", oh_c, Cg, oh_l)
                Wk = Wk.reshape(C, d, LANDMARK_DOF, L).transpose(
                    0, 1, 3, 2).reshape(C * d, L * LANDMARK_DOF)
                W_rows[kind] = W_rows.get(kind, jnp.zeros(
                    (C * d, L * LANDMARK_DOF), dtype)) + Wk

    # assemble the dense system from the region accumulators
    H = jnp.zeros((D + 1, D + 1), dtype)
    for (k1, k2), Areg in A.items():
        o1, o2 = ROFF[k1], ROFF[k2]
        n1 = CAP[k1] * DOF[k1]
        n2 = CAP[k2] * DOF[k2]
        mat = Areg.reshape(n1, n2)
        H = H.at[o1:o1 + n1, o2:o2 + n2].add(mat)
        if k1 != k2:
            H = H.at[o2:o2 + n2, o1:o1 + n1].add(mat.T)
    for kind, Dk in Adiag.items():
        C, d = CAP[kind], DOF[kind]
        o = ROFF[kind]
        eyeC = jnp.eye(C, dtype=dtype)
        full = (Dk[:, :, None, :] * eyeC[:, None, :, None]).reshape(
            C * d, C * d)
        H = H.at[o:o + C * d, o:o + C * d].add(full)

    g = jnp.zeros((D + 1,), dtype)
    o = 0
    for kind in KINDS:
        n = CAP[kind] * DOF[kind]
        g = g.at[o:o + n].set(g_reg[kind].reshape(-1))
        o += n

    W = jnp.zeros((D + 1, L * LANDMARK_DOF), dtype)
    for kind, Wk in W_rows.items():
        o = ROFF[kind]
        W = W.at[o:o + Wk.shape[0], :].add(Wk)
    return H, g, H_ll, g_l, W, cost


def _assemble(window, families, losses, mode: str):
    # Flagship window, 10-iteration solve on an NVIDIA H100 80GB HBM3 at a
    # 400 W power limit: scatter 7.39 ms, dense 11.40 ms, blocks 13.01 ms.
    if mode == "dense":
        return assemble_normal_equations_dense(window, families, losses)
    if mode == "blocks":
        return assemble_normal_equations_blocks(window, families, losses)
    return assemble_normal_equations(window, families, losses)


# jitted assembly entry point for host callers (e.g. exact marginalization) —
# one dispatch instead of one per eager op
assemble_normal_equations_jit = functools.partial(
    jax.jit, static_argnums=(2,))(assemble_normal_equations)


def total_cost(window: WindowState, families: Sequence,
               losses: Tuple[Optional[float], ...]) -> jnp.ndarray:
    """Robustified cost only (no Jacobians) — used for LM trial evaluation."""
    cost = jnp.zeros((), window.imu.q.dtype)
    for fam, loss in zip(families, losses):
        r = fam.residual_only(window)
        s = jnp.sum(r * r, axis=-1)
        _, rho = robust_weight(s, loss)
        cost = cost + 0.5 * jnp.sum(rho)
    return cost


def _solve_damped(H, g, free, lam, H_ll, g_l, W, lm_free):
    """Schur-reduced damped solve.

    Dense part: (S·H_red·S + λI) y = S·g_red with Jacobi scaling S — the
    float32-conditioning workhorse (SURVEY.md §7 'Double precision' risk).
    Landmarks: per-slot 3×3 inverses of (H_ll + λ·diag(H_ll)), masked by
    ``lm_free``; back-substituted after the reduced solve.
    """
    dtype = H.dtype
    Dp = H.shape[0]
    L = H_ll.shape[0]
    freef = free.astype(dtype)
    lmf = lm_free.astype(dtype)

    # mask held/inactive dense dof and landmark slots
    Hm = H * (freef[:, None] * freef[None, :])
    Hm = Hm + jnp.diag(1.0 - freef)
    gm = g * freef
    W = W * freef[:, None] * jnp.repeat(lmf, LANDMARK_DOF)[None, :]
    eye3 = jnp.eye(3, dtype=dtype)
    # damping λ·diag(H_ll) + a trace-relative floor: a landmark seen from a
    # single view has a rank-2 3×3 block whose f32 inverse explodes and makes
    # the Schur complement indefinite; the floor bounds ‖H_ll⁻¹‖ by ~1e5/tr.
    diag_ll = jax.vmap(jnp.diag)(H_ll)
    tr = jnp.trace(H_ll, axis1=1, axis2=2)
    Hll_d = (H_ll + jax.vmap(jnp.diag)(lam * diag_ll + 1e-8)
             + (1e-5 * tr)[:, None, None] * eye3[None])
    Hll_d = jnp.where(lmf[:, None, None] > 0, Hll_d, eye3[None])
    g_l = g_l * lmf[:, None]
    Hll_inv = _inv3x3(Hll_d)

    # reduced camera system: H_red = H - W·Hll⁻¹·Wᵀ
    Wr = W.reshape(Dp, L, 3)
    Y = jnp.einsum("dlk,lkm->dlm", Wr, Hll_inv)
    H_red = Hm - jnp.einsum("dlm,elm->de", Y, Wr)
    g_red = gm - jnp.einsum("dlm,lm->d", Y, g_l)

    d = jnp.diagonal(H_red)
    s = jax.lax.rsqrt(jnp.maximum(d, _DIAG_EPS))
    Hs = H_red * (s[:, None] * s[None, :])
    Hs = Hs + lam * jnp.eye(Dp, dtype=dtype)
    gs = g_red * s
    # Pad the reduced system to the next multiple of 128 with an identity
    # block (decoupled unit equations): the leading Dp entries of the padded
    # solution equal the unpadded one exactly, and every window capacity
    # near a multiple of 128 shares one factorization shape.
    pad = (-Dp) % 128
    if pad:
        Hs = jnp.zeros((Dp + pad, Dp + pad), dtype).at[:Dp, :Dp].set(Hs)
        Hs = Hs.at[jnp.arange(Dp, Dp + pad),
                   jnp.arange(Dp, Dp + pad)].set(1.0)
        gs = jnp.zeros((Dp + pad,), dtype).at[:Dp].set(gs)
    Lc = jnp.linalg.cholesky(Hs)
    y = jax.scipy.linalg.cho_solve((Lc, True), gs)
    delta = y[:Dp] * s * freef

    # landmark back-substitution: δ_l = Hll⁻¹ (g_l − Wᵀ δ_p)
    rhs_l = g_l - jnp.einsum("dlk,d->lk", Wr, delta)
    delta_l = jnp.einsum("lkm,lk->lm", Hll_inv, rhs_l) * lmf[:, None]

    ok = jnp.all(jnp.isfinite(delta)) & jnp.all(jnp.isfinite(delta_l))
    delta = jnp.where(ok, delta, jnp.zeros_like(delta))
    delta_l = jnp.where(ok, delta_l, jnp.zeros_like(delta_l))
    return delta, delta_l, ok


def solve_damped_batched(H, g, free, lam, H_ll, g_l, W, lm_free):
    """Batched damped Schur solve over a leading batch axis (every argument
    carries it): the vmapped :func:`_solve_damped`, whose batched Cholesky
    and triangular solves XLA hands to the device's solver library."""
    return jax.vmap(_solve_damped)(H, g, free, lam, H_ll, g_l, W, lm_free)


def solve(
    window: WindowState,
    families: Tuple,
    losses: Tuple[Optional[float], ...],
    options: SolverOptions = SolverOptions(),
) -> Tuple[WindowState, SolveDiagnostics]:
    """Run LM on the window. ``families``/``losses`` are parallel tuples;
    family *types* and capacities are static, their array contents traced.
    ``options.max_iterations`` is passed as a traced scalar so different
    iteration budgets (within one scan_length) share one executable."""
    sl = options.scan_length or options.max_iterations
    n_iter = jnp.asarray(min(options.max_iterations, sl), jnp.int32)
    static = options._replace(max_iterations=0, scan_length=sl)
    return _solve_impl(window, families, n_iter, losses, static)


@functools.partial(jax.jit, static_argnums=(2,))
def marginal_pose_covariance(window, families, losses,
                             slots: jnp.ndarray) -> jnp.ndarray:
    """Marginal 6-dof pose covariance blocks for the requested IMU slots.

    The reference recovers localization covariances for the entropy-based
    validation gate (bs_models/include/bs_models/vision/
    vo_localization_validation.h:32-63, bs_common/utils.h:79
    ShannonEntropyFromPoseCovariance). Here: assemble the (landmark-Schur-
    reduced) normal equations at the current estimate, Cholesky-factor once
    (reusing the _solve_damped conditioning: Jacobi equilibration, held/
    inactive dof pinned), and back-solve only the requested columns.

    slots: [S] int32 IMU slots. Returns [S, 6, 6] covariance over the pose
    tangent [dθ(3), dp(3)] (ES order: rows 0-5 of the state's 15-dof block).
    """
    from beam_slam_tpu.core.window import IMU_DOF

    H, g, H_ll, g_l, W, _ = _assemble(window, families, losses, "scatter")
    dtype = H.dtype
    Dp = H.shape[0]
    L = H_ll.shape[0]
    free = jnp.concatenate([window.dense_free_mask(),
                            jnp.zeros((1,), bool)]).astype(dtype)
    lm_free = (window.landmarks.active & ~window.landmarks.held).astype(dtype)

    Hm = H * (free[:, None] * free[None, :]) + jnp.diag(1.0 - free)
    W = W * free[:, None] * jnp.repeat(lm_free, LANDMARK_DOF)[None, :]
    eye3 = jnp.eye(3, dtype=dtype)
    tr = jnp.trace(H_ll, axis1=1, axis2=2)
    Hll_d = H_ll + (1e-5 * tr + 1e-8)[:, None, None] * eye3[None]
    Hll_d = jnp.where(lm_free[:, None, None] > 0, Hll_d, eye3[None])
    Hll_inv = _inv3x3(Hll_d)
    Wr = W.reshape(Dp, L, 3)
    Y = jnp.einsum("dlk,lkm->dlm", Wr, Hll_inv)
    H_red = Hm - jnp.einsum("dlm,elm->de", Y, Wr)

    d = jnp.diagonal(H_red)
    s = jax.lax.rsqrt(jnp.maximum(d, _DIAG_EPS))
    Hs = H_red * (s[:, None] * s[None, :])
    Hs = Hs + 1e-9 * jnp.eye(Dp, dtype=dtype)
    Lc = jnp.linalg.cholesky(Hs)

    # RHS: scaled unit columns of the requested pose dofs
    cols = (slots[:, None] * IMU_DOF
            + jnp.arange(6, dtype=jnp.int32)[None, :]).reshape(-1)  # [S*6]
    E = jax.nn.one_hot(cols, Dp, dtype=dtype).T * s[:, None]  # [Dp, S*6]
    X = jax.scipy.linalg.cho_solve((Lc, True), E) * s[:, None]
    # diagonal 6x6 blocks of the requested sub-inverse
    S_req = slots.shape[0]
    Xr = X[cols, :].reshape(S_req, 6, S_req, 6)   # [S,6,S,6]
    idx = jnp.arange(S_req)
    cov = Xr[idx, :, idx, :]                      # [S, 6, 6]
    return 0.5 * (cov + jnp.swapaxes(cov, 1, 2))


@functools.partial(jax.jit, static_argnums=(3, 4))
def _solve_impl(window, families, n_iter, losses,
                options: SolverOptions):
    return lm_loop(window,
                   lambda win: _assemble(win, families, losses,
                                         options.assembly),
                   n_iter, options)


def lm_loop(window, assemble, n_iter, options: SolverOptions):
    """The LM iteration machinery over a pluggable ``assemble`` function.

    ``assemble(window) -> (H, g, H_ll, g_l, W, cost)`` — the single-device
    solve passes :func:`_assemble`; the distributed BA solve
    (parallel/distributed_ba.py) passes a psum-reduced assembly so each
    shard linearizes only its factor slice while the damped Schur solve
    runs replicated on the full reduced system.
    """
    free_full = window.dense_free_mask()
    free = jnp.concatenate([free_full, jnp.zeros((1,), bool)])  # trash dof
    lm_free = window.landmarks.active & ~window.landmarks.held

    # One assembly per iteration: iteration k solves the carried normal
    # equations, retracts a trial, and assembles AT THE TRIAL — that single
    # pass yields both the trial cost (accept/reject decision) and, on
    # accept, the next iteration's normal equations. No separate
    # residual-only pass (the factor math dominates assembly, so a
    # residual-only pass costs almost as much as a full assembly).
    H0, g0, H_ll0, g_l0, W0, init_cost = assemble(window)

    def step(carry, _):
        win, (H, g, H_ll, g_l, W), lam, cost, done, iters, attempt = carry
        active = ~done & (attempt < n_iter)
        delta, delta_l, ok = _solve_damped(H, g, free, lam, H_ll, g_l, W,
                                           lm_free)
        trial = win.retract_dense(delta[:-1])
        trial = trial.replace(landmarks=trial.landmarks.retract(delta_l))
        H_t, g_t, H_ll_t, g_l_t, W_t, new_cost = assemble(trial)
        accept = ok & (new_cost < cost) & active
        win = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, b, a), win, trial
        )
        eqs = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, b, a),
            (H, g, H_ll, g_l, W), (H_t, g_t, H_ll_t, g_l_t, W_t)
        )
        rel_drop = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done = done | (accept & (rel_drop < options.function_tolerance))
        lam = jnp.where(
            ~active | done, lam,
            jnp.where(accept, jnp.maximum(lam * 0.5, options.min_lambda),
                      jnp.minimum(lam * 4.0, options.max_lambda)),
        )
        cost = jnp.where(accept, new_cost, cost)
        iters = iters + accept.astype(jnp.int32)
        return (win, eqs, lam, cost, done, iters, attempt + 1), None

    dtype = window.imu.q.dtype
    lam0 = jnp.asarray(options.initial_lambda, dtype)
    carry0 = (window, (H0, g0, H_ll0, g_l0, W0), lam0, init_cost,
              jnp.zeros((), bool), jnp.zeros((), jnp.int32),
              jnp.zeros((), jnp.int32))
    if options.early_exit:
        def cond(carry):
            _, _, _, _, done, _, attempt = carry
            return ~done & (attempt < n_iter)

        (window, _, lam, cost, done, iters, _) = jax.lax.while_loop(
            cond, lambda c: step(c, None)[0], carry0
        )
    else:
        (window, _, lam, cost, done, iters, _), _ = jax.lax.scan(
            step, carry0, None, length=options.scan_length, unroll=2
        )
    diag = SolveDiagnostics(
        initial_cost=init_cost, final_cost=cost, iterations=iters,
        converged=done, final_lambda=lam,
    )
    return window, diag
