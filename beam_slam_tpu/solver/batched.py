"""Shared-topology batched LM solve — the submap-refinement throughput path.

``parallel/sharded.solve_batched`` is the plain vmap of the single-window
solve. Under vmap every per-factor gather and one-hot Gram scatter lowers to
a *batch-looped* small op, so 32 windows can cost 32 × the latency-bound
time of one and no large matmul ever forms.

This module exploits what the submap-refinement workload actually has
(bs_models/src/lib/global_mapping/submap_refinement.cpp:24-162 — B
independent windows of the SAME factor-graph template): when the slot
topology (``slots``/``active`` of every family, and window capacities) is
identical across the batch, every gather and scatter can use ONE shared
one-hot matrix with the batch dim folded into the GEMM's N dimension:

  * block-state gathers:   [F, K] @ [K, B·C]      (one GEMM per block kind)
  * Hessian region scatter: [C₁·C₂, x] @ [x, B·d₁·d₂]
  * pose-landmark coupling: [C·L, x] @ [x, B·d·3]

— all large matmuls instead of B loops of tiny ones. The residual /
Jacobian math itself is elementwise work that vmaps fine and reuses the
exact per-factor functions of :mod:`beam_slam_tpu.core.factors` (so the
factor math cannot diverge from the reference-parity implementations).

Contract: callers must pass families whose ``slots`` and ``active`` arrays
are equal across the leading batch axis (``assert_shared_topology`` checks
on host). ``tests/test_batched_solver.py`` asserts numerical agreement with
the generic vmapped solve.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from beam_slam_tpu.core import factors as fc
from beam_slam_tpu.core.window import (IMU_DOF, LANDMARK_DOF, MOTION_DOF,
                                       POSE_DOF, WindowState)
from beam_slam_tpu.solver import gauss_newton as gn


def _first(tree):
    """Batch element 0 of a pytree (trace-safe)."""
    return jax.tree_util.tree_map(lambda x: x[0], tree)


def assert_shared_topology(families_b) -> None:
    """Host-side check that every family's slots/active are batch-constant.
    Call OUTSIDE jit (concrete arrays)."""
    for fam in families_b:
        s = np.asarray(fam.slots)
        a = np.asarray(fam.active)
        if not (s == s[:1]).all():
            raise ValueError(
                f"{type(fam).__name__}: slots differ across the batch — "
                "the shared-topology solve does not apply; use "
                "parallel.sharded.solve_batched")
        if not (a == a[:1]).all():
            raise ValueError(
                f"{type(fam).__name__}: active masks differ across the batch")


def _state_table(window_b: WindowState, kind: str) -> jnp.ndarray:
    """Per-kind state table [B, C, width] for one-hot gathers."""
    if kind == fc.BLOCK_IMU:
        s = window_b.imu
        return jnp.concatenate([s.q, s.p, s.v, s.bg, s.ba], axis=-1)  # 16
    if kind == fc.BLOCK_EXTRINSIC:
        s = window_b.extrinsics
        return jnp.concatenate([s.q, s.p], axis=-1)                   # 7
    if kind == fc.BLOCK_MOTION:
        s = window_b.motion
        return jnp.concatenate([s.w, s.a], axis=-1)                   # 6
    if kind == fc.BLOCK_LANDMARK:
        return window_b.landmarks.pt                                  # 3
    raise ValueError(kind)


def _split_state(kind: str, g: jnp.ndarray):
    """Split a gathered [.., width] table row back into the block-state
    tuple the residual functions expect (same layout as _gather_block)."""
    if kind == fc.BLOCK_IMU:
        return (g[..., 0:4], g[..., 4:7], g[..., 7:10], g[..., 10:13],
                g[..., 13:16])
    if kind == fc.BLOCK_EXTRINSIC:
        return (g[..., 0:4], g[..., 4:7])
    if kind == fc.BLOCK_MOTION:
        return (g[..., 0:3], g[..., 3:6])
    if kind == fc.BLOCK_LANDMARK:
        return (g,)
    raise ValueError(kind)


def _active_of(window_b: WindowState, kind: str) -> jnp.ndarray:
    if kind == fc.BLOCK_IMU:
        return window_b.imu.active
    if kind == fc.BLOCK_EXTRINSIC:
        return window_b.extrinsics.active
    if kind == fc.BLOCK_MOTION:
        return window_b.motion.active
    if kind == fc.BLOCK_LANDMARK:
        return window_b.landmarks.active
    raise ValueError(kind)


def linearize_shared(fam_b, window_b: WindowState, template=None):
    """Batched linearize with shared topology: one-hot GEMM gathers instead
    of B looped gathers. Returns (r [B,F,R], J [B,F,R,Dd], lm_slot [F]|None,
    J_lm [B,F,R,3]|None, mask [B,F]) — whitened but NOT masked; the caller
    multiplies mask into its robust-weight scaling pass.

    ``template``: optional unbatched family supplying the shared slots —
    pass a closure constant when calling under lax.map so the one-hot
    construction is loop-invariant and hoisted."""
    cls = type(fam_b)
    blocks = cls.BLOCKS
    fam0 = template if template is not None else _first(fam_b)
    slots0 = fam0.slots                      # [F, nb] shared
    F = slots0.shape[0]
    dtype = window_b.imu.q.dtype
    B = window_b.imu.q.shape[0]
    with_lm = fam0.has_landmark()

    # ---- gathers as GEMMs: oh [F, C] @ table [C, B*width]
    gathered = []
    mask_b = jnp.broadcast_to(fam_b.active, (B, F)).astype(dtype)
    for b, k in enumerate(blocks):
        table = _state_table(window_b, k)    # [B, C, w]
        C, w = table.shape[1], table.shape[2]
        oh = jax.nn.one_hot(slots0[:, b], C, dtype=dtype)  # [F, C] shared
        flat = table.transpose(1, 0, 2).reshape(C, B * w)
        g = (oh @ flat).reshape(F, B, w).transpose(1, 0, 2)  # [B, F, w]
        gathered.append(_split_state(k, g))
        act = _active_of(window_b, k).astype(dtype)          # [B, C]
        mask_b = mask_b * jnp.einsum("fc,bc->bf", oh, act)

    used = cls.USED_COLS
    Dl = fam0.local_dof()
    if used is not None:
        expand_np = np.zeros((len(used), Dl), np.float64)
        expand_np[np.arange(len(used)), list(used)] = 1.0
        expand = jnp.asarray(expand_np, dtype)
    else:
        expand = None

    params = fam_b.params()                  # [B, F, ...] leaves

    if cls.HAS_ANALYTIC and fc.analytic_jacobians_enabled():
        rj = jax.vmap(jax.vmap(fam0.residual_and_jacobian_used))
        r, J = rj(gathered, params)
    else:
        def res_one(delta, gathered_one, params_one):
            if expand is not None:
                delta = delta @ expand
            deltas = fam0._split_delta(delta)
            retr = [fc._retract_block(k, g, d)
                    for k, g, d in zip(blocks, gathered_one, deltas)]
            return fam0.residual(retr, params_one)

        zeros = jnp.zeros((B, F, len(used) if used is not None else Dl),
                          dtype)
        r = jax.vmap(jax.vmap(res_one))(zeros, gathered, params)
        J = jax.vmap(jax.vmap(jax.jacfwd(res_one, argnums=0)))(
            zeros, gathered, params)
    if expand is not None:
        J = jnp.einsum("bfru,ud->bfrd", J, expand)

    if with_lm:
        J_lm = J[..., Dl - LANDMARK_DOF:]
        J = J[..., : Dl - LANDMARK_DOF]
        lm_slot = slots0[:, len(blocks) - 1]
    else:
        J_lm, lm_slot = None, None
    # r/J returned RAW + mask: the caller folds mask and the robust-loss
    # weight into ONE scaling pass over J (each extra pass over the
    # [B,F,R,D] tensors is ~100 MB of HBM traffic on the flagship batch)
    return r, J, lm_slot, J_lm, mask_b


def _region_dims(window_b: WindowState):
    """Static region geometry shared by the assembly helpers."""
    K = window_b.imu.q.shape[1]
    E = window_b.extrinsics.q.shape[1]
    M = window_b.motion.w.shape[1]
    KINDS = (fc.BLOCK_IMU, fc.BLOCK_EXTRINSIC, fc.BLOCK_MOTION)
    CAP = {fc.BLOCK_IMU: K, fc.BLOCK_EXTRINSIC: E, fc.BLOCK_MOTION: M}
    DOF = {fc.BLOCK_IMU: IMU_DOF, fc.BLOCK_EXTRINSIC: POSE_DOF,
           fc.BLOCK_MOTION: MOTION_DOF}
    ROFF = {fc.BLOCK_IMU: 0, fc.BLOCK_EXTRINSIC: K * IMU_DOF,
            fc.BLOCK_MOTION: K * IMU_DOF + E * POSE_DOF}
    return KINDS, CAP, DOF, ROFF


def _family_groups(cls):
    """Non-landmark block kinds of a family class: {kind: [(block_idx,
    col_offset)]} plus the per-kind local tangent columns."""
    blocks = [k for k in cls.BLOCKS if k != fc.BLOCK_LANDMARK]
    offs, o = [], 0
    for k in blocks:
        offs.append(o)
        o += fc.block_dof(k)
    groups = {}
    for b, k in enumerate(blocks):
        groups.setdefault(k, []).append((b, offs[b]))
    return groups


def _family_contrib(fam_b, window_b, loss, tmpl, dims):
    """Scatter one family's (or family chunk's) normal-equation
    contributions into region-shaped accumulator deltas.

    Returns a dict with static STRING keys (mixed-type keys break JAX's
    pytree dict-key sort): "g:<kind>" [B,C,d], "Adiag:<kind>" [B,C,d,d],
    "A:<k1>:<k2>" [B,C1,d1,C2,d2], "H_ll" [B,L,3,3], "g_l" [B,L,3],
    "W:<kind>" [B,C·d,L·3], "cost" [B]. All GEMMs keep the full batch B in the N dimension —
    chunking (if any) happens on the FACTOR axis outside this function, so
    batch scaling is never serialized."""
    KINDS, CAP, DOF, _ = dims
    ORD = {k: i for i, k in enumerate(KINDS)}
    B = window_b.imu.q.shape[0]
    L = window_b.landmarks.pt.shape[1]
    dtype = window_b.imu.q.dtype

    fam0 = tmpl if tmpl is not None else _first(fam_b)
    r, J, lm_slot, J_lm, mask = linearize_shared(fam_b, window_b,
                                                 template=tmpl)
    F = r.shape[1]
    s_raw = jnp.sum(r * r, axis=-1)                  # [B, F]
    s = jnp.where(mask > 0, s_raw, 0.0)
    w, rho = gn.robust_weight(s, loss)
    out = {"cost": 0.5 * jnp.sum(rho, axis=-1)}
    sw = jnp.sqrt(w) * mask
    r = r * sw[:, :, None]
    J = J * sw[:, :, None, None]

    P = gn._gram(J)                                  # [B, F, Dl, Dl]
    q = gn._jtr(J, r)                                # [B, F, Dl]

    groups = _family_groups(type(fam0))

    def _cols(kind):
        return np.concatenate([np.arange(off, off + DOF[kind])
                               for _, off in groups[kind]])

    def _slots(kind):
        bs = [b for b, _ in groups[kind]]
        return fam0.slots[:, bs]                     # [F, n] shared

    # gradient: one GEMM per kind with B folded into N
    for kind in groups:
        n = len(groups[kind])
        d = DOF[kind]
        qg = jnp.take(q, _cols(kind), axis=2).reshape(B, F * n, d)
        oh = jax.nn.one_hot(_slots(kind).reshape(-1), CAP[kind],
                            dtype=dtype)             # [F·n, C] shared
        out[f"g:{kind}"] = -jnp.einsum("xc,bxd->bcd", oh, qg)

    # Hessian regions: shared (pair) one-hots, B in the GEMM N dim
    for k1 in groups:
        for k2 in groups:
            if ORD[k2] < ORD[k1]:
                continue
            n1, n2 = len(groups[k1]), len(groups[k2])
            d1, d2 = DOF[k1], DOF[k2]
            c1, c2 = _cols(k1), _cols(k2)
            Ps = jnp.take(jnp.take(P, c1, axis=2), c2, axis=3)
            Ps = Ps.reshape(B, F, n1, d1, n2, d2)
            if k1 == k2 and n1 == 1:
                oh = jax.nn.one_hot(_slots(k1)[:, 0], CAP[k1],
                                    dtype=dtype)     # [F, C]
                out[f"Adiag:{k1}"] = jnp.einsum(
                    "fc,bfde->bcde", oh, Ps.reshape(B, F, d1, d2))
                continue
            Ps = Ps.transpose(0, 1, 2, 4, 3, 5).reshape(
                B, F * n1 * n2, d1 * d2)
            S1, S2 = _slots(k1), _slots(k2)
            pair = (S1[:, :, None] * CAP[k2]
                    + S2[:, None, :]).reshape(-1)    # [F·n1·n2] shared
            oh = jax.nn.one_hot(pair, CAP[k1] * CAP[k2], dtype=dtype)
            out[f"A:{k1}:{k2}"] = jnp.einsum("xp,bxe->bpe", oh, Ps).reshape(
                B, CAP[k1], CAP[k2], d1, d2).transpose(0, 1, 3, 2, 4)

    # landmark system + pose-landmark coupling
    if lm_slot is not None:
        J_lm = J_lm * sw[:, :, None, None]
        oh_lm = jax.nn.one_hot(lm_slot, L, dtype=dtype)   # [F, L] shared
        out["H_ll"] = jnp.einsum("fl,bfij->blij", oh_lm, gn._gram(J_lm))
        out["g_l"] = -jnp.einsum("fl,bfi->bli", oh_lm, gn._jtr(J_lm, r))
        Cr = gn._cross(J, J_lm)                           # [B,F,Dd,3]
        for kind in groups:
            n = len(groups[kind])
            d = DOF[kind]
            C = CAP[kind]
            Cg = jnp.take(Cr, _cols(kind), axis=2).reshape(
                B, F, n, d * LANDMARK_DOF).transpose(0, 2, 1, 3).reshape(
                B, n * F, d * LANDMARK_DOF)
            # shared (slot, landmark) pair one-hot [n·F, C·L] built from the
            # fused pair INDEX (slot·L + lm) — one one_hot instead of the
            # outer product of two (the outer product materialized an
            # [n·F, C, L] intermediate). The GEMM [C·L, n·F] @ [n·F, B·d·3]
            # scatters every coupling block in one matmul.
            slot_flat = _slots(kind).T.reshape(-1)           # [n·F]
            lm_flat = jnp.tile(lm_slot, (n,))                # [n·F]
            pair = jax.nn.one_hot(slot_flat * L + lm_flat, C * L,
                                  dtype=dtype)               # [n·F, C·L]
            Wk = jnp.einsum("xm,bxd->bmd", pair, Cg).reshape(
                B, C, L, d, LANDMARK_DOF).transpose(0, 1, 3, 2, 4)
            out[f"W:{kind}"] = Wk.reshape(B, C * d, L * LANDMARK_DOF)
    return out


def _chunk_leading(x, n_chunks, axis):
    """[.., F, ..] -> [n_chunks, .., F/n, ..] with the chunk axis leading."""
    F = x.shape[axis]
    new = x.reshape(x.shape[:axis] + (n_chunks, F // n_chunks)
                    + x.shape[axis + 1:])
    return jnp.moveaxis(new, axis, 0)


def assemble_shared(
    window_b: WindowState,
    families_b: Sequence,
    losses: Tuple[Optional[float], ...],
    templates: Optional[Sequence] = None,
    f_chunk: int = 0,
):
    """Batched blocks assembly with shared topology. Identical output
    contract to gn.assemble_normal_equations with a leading batch axis:
    (H [B,D+1,D+1], g [B,D+1], H_ll [B,L,3,3], g_l [B,L,3],
    W [B,D+1,L·3], cost [B]).

    ``f_chunk`` > 0 chunks families with more than ``f_chunk`` factors on
    the FACTOR axis (lax.scan with region accumulators): the per-factor
    Gram/coupling intermediates ([B,F,Dl,Dl] etc.) stay chunk-sized at any
    batch size while every scatter GEMM keeps the full B in its N
    dimension, without serializing the batch the way batch-chunking
    (assemble_shared_chunked) does."""
    D = window_b.imu.q.shape[1] * IMU_DOF \
        + window_b.extrinsics.q.shape[1] * POSE_DOF \
        + window_b.motion.w.shape[1] * MOTION_DOF
    B = window_b.imu.q.shape[0]
    L = window_b.landmarks.pt.shape[1]
    dtype = window_b.imu.q.dtype
    dims = _region_dims(window_b)
    KINDS, CAP, DOF, ROFF = dims

    A = {}
    Adiag = {}
    g_reg = {k: jnp.zeros((B, CAP[k], DOF[k]), dtype) for k in KINDS}
    H_ll = jnp.zeros((B, L, 3, 3), dtype)
    g_l = jnp.zeros((B, L, 3), dtype)
    W_rows = {}
    cost = jnp.zeros((B,), dtype)

    if templates is None:
        templates = [None] * len(tuple(families_b))
    for fam_b, loss, tmpl in zip(families_b, losses, templates):
        tmpl = tmpl if tmpl is not None else _first(fam_b)
        F = tmpl.slots.shape[0]
        if f_chunk and F > f_chunk and F % f_chunk == 0:
            n_chunks = F // f_chunk
            fam_xs = jax.tree_util.tree_map(
                lambda x: _chunk_leading(x, n_chunks, axis=1), fam_b)
            tmpl_xs = jax.tree_util.tree_map(
                lambda x: _chunk_leading(x, n_chunks, axis=0), tmpl)

            def body(carry, xs):
                fam_c, tmpl_c = xs
                c = _family_contrib(fam_c, window_b, loss, tmpl_c, dims)
                return {k: carry[k] + c[k] for k in carry}, None

            shapes = jax.eval_shape(
                lambda f, t: _family_contrib(f, window_b, loss, t, dims),
                jax.tree_util.tree_map(lambda x: x[0], fam_xs),
                jax.tree_util.tree_map(lambda x: x[0], tmpl_xs))
            zero = jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), shapes)
            contrib, _ = jax.lax.scan(body, zero, (fam_xs, tmpl_xs))
        else:
            contrib = _family_contrib(fam_b, window_b, loss, tmpl, dims)

        cost = cost + contrib["cost"]
        for key, val in contrib.items():
            if key == "cost":
                continue
            parts = key.split(":")
            tag = parts[0]
            if tag == "g":
                g_reg[parts[1]] = g_reg[parts[1]] + val
            elif tag == "Adiag":
                Adiag[parts[1]] = Adiag.get(parts[1], 0.0) + val
            elif tag == "A":
                k12 = (parts[1], parts[2])
                A[k12] = A.get(k12, 0.0) + val
            elif tag == "W":
                W_rows[parts[1]] = W_rows.get(parts[1], 0.0) + val
            elif key == "H_ll":
                H_ll = H_ll + val
            elif key == "g_l":
                g_l = g_l + val

    # dense assembly from region accumulators
    H = jnp.zeros((B, D + 1, D + 1), dtype)
    for (k1, k2), Areg in A.items():
        o1, o2 = ROFF[k1], ROFF[k2]
        n1 = CAP[k1] * DOF[k1]
        n2 = CAP[k2] * DOF[k2]
        mat = Areg.reshape(B, n1, n2)
        H = H.at[:, o1:o1 + n1, o2:o2 + n2].add(mat)
        if k1 != k2:
            H = H.at[:, o2:o2 + n2, o1:o1 + n1].add(
                jnp.swapaxes(mat, 1, 2))
    for kind, Dk in Adiag.items():
        C, d = CAP[kind], DOF[kind]
        o = ROFF[kind]
        eyeC = jnp.eye(C, dtype=dtype)
        full = (Dk[:, :, :, None, :] * eyeC[None, :, None, :, None]).reshape(
            B, C * d, C * d)
        H = H.at[:, o:o + C * d, o:o + C * d].add(full)

    g = jnp.zeros((B, D + 1), dtype)
    o = 0
    for kind in KINDS:
        n = CAP[kind] * DOF[kind]
        g = g.at[:, o:o + n].set(g_reg[kind].reshape(B, -1))
        o += n

    W = jnp.zeros((B, D + 1, L * LANDMARK_DOF), dtype)
    for kind, Wk in W_rows.items():
        o = ROFF[kind]
        W = W.at[:, o:o + Wk.shape[1], :].add(Wk)
    return H, g, H_ll, g_l, W, cost


def _bcast(flag: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a [B] flag against a [B, ...] array."""
    return flag.reshape(flag.shape + (1,) * (like.ndim - 1))


def assemble_shared_chunked(window_b: WindowState, families_b, losses,
                            chunk: int = 8):
    """assemble_shared over BATCH chunks of ``chunk`` via lax.map.

    Keeps every intermediate at chunk size; the chunks run sequentially.
    It is the default assembly of solve_batched_shared."""
    B = window_b.imu.q.shape[0]
    if chunk >= B or B % chunk != 0:
        return assemble_shared(window_b, families_b, losses)

    # shared-slot templates as closure constants: their one-hot matrices
    # become loop-invariant operands of the map body and are hoisted
    templates = tuple(_first(f) for f in families_b)

    def body(args):
        w, f = args
        return assemble_shared(w, f, losses, templates=templates)

    def split(tree):
        return jax.tree_util.tree_map(
            lambda x: x.reshape((B // chunk, chunk) + x.shape[1:]), tree)

    out = jax.lax.map(body, (split(window_b), split(tuple(families_b))))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((B,) + x.shape[2:]), out)


def lm_loop_batched(window_b: WindowState, assemble, n_iter,
                    options: gn.SolverOptions):
    """Batched LM: per-window damping / accept / convergence latch. Mirrors
    gn.lm_loop with [B]-shaped scalars."""
    B = window_b.imu.q.shape[0]
    dtype = window_b.imu.q.dtype
    free = jax.vmap(
        lambda w: jnp.concatenate([w.dense_free_mask(),
                                   jnp.zeros((1,), bool)]))(window_b)
    lm_free = window_b.landmarks.active & ~window_b.landmarks.held

    H0, g0, H_ll0, g_l0, W0, init_cost = assemble(window_b)

    def step(carry, _):
        win, (H, g, H_ll, g_l, W), lam, cost, done, iters, attempt = carry
        active = ~done & (attempt < n_iter)
        delta, delta_l, ok = gn.solve_damped_batched(
            H, g, free, lam, H_ll, g_l, W, lm_free)
        trial = jax.vmap(
            lambda w, d, dl: w.retract_dense(d[:-1]).replace(
                landmarks=w.landmarks.retract(dl)))(win, delta, delta_l)
        H_t, g_t, H_ll_t, g_l_t, W_t, new_cost = assemble(trial)
        accept = ok & (new_cost < cost) & active
        win = jax.tree_util.tree_map(
            lambda a, b: jnp.where(_bcast(accept, a), b, a), win, trial)
        eqs = jax.tree_util.tree_map(
            lambda a, b: jnp.where(_bcast(accept, a), b, a),
            (H, g, H_ll, g_l, W), (H_t, g_t, H_ll_t, g_l_t, W_t))
        rel_drop = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done = done | (accept & (rel_drop < options.function_tolerance))
        lam = jnp.where(
            ~active | done, lam,
            jnp.where(accept, jnp.maximum(lam * 0.5, options.min_lambda),
                      jnp.minimum(lam * 4.0, options.max_lambda)))
        cost = jnp.where(accept, new_cost, cost)
        iters = iters + accept.astype(jnp.int32)
        return (win, eqs, lam, cost, done, iters, attempt + 1), None

    lam0 = jnp.full((B,), options.initial_lambda, dtype)
    carry0 = (window_b, (H0, g0, H_ll0, g_l0, W0), lam0, init_cost,
              jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32),
              jnp.zeros((), jnp.int32))
    if options.early_exit:
        def cond(carry):
            _, _, _, _, done, _, attempt = carry
            return (~jnp.all(done)) & (attempt < n_iter)

        (window_b, _, lam, cost, done, iters, _) = jax.lax.while_loop(
            cond, lambda c: step(c, None)[0], carry0)
    else:
        (window_b, _, lam, cost, done, iters, _), _ = jax.lax.scan(
            step, carry0, None, length=options.scan_length, unroll=1)
    diag = gn.SolveDiagnostics(
        initial_cost=init_cost, final_cost=cost, iterations=iters,
        converged=done, final_lambda=lam)
    return window_b, diag


@functools.partial(jax.jit, static_argnums=(2, 3, 5, 6))
def _solve_shared_impl(window_b, families_b, losses,
                       options: gn.SolverOptions, n_iter, asm_chunk: int,
                       f_chunk: int):
    if asm_chunk:
        assemble = lambda w: assemble_shared_chunked(  # noqa: E731
            w, families_b, losses, chunk=asm_chunk)
    else:
        templates = tuple(_first(f) for f in families_b)
        assemble = lambda w: assemble_shared(          # noqa: E731
            w, families_b, losses, templates=templates, f_chunk=f_chunk)
    return lm_loop_batched(window_b, assemble, n_iter, options)


def solve_batched_shared(window_b: WindowState, families_b,
                         losses: Tuple[Optional[float], ...],
                         options: gn.SolverOptions = gn.SolverOptions(),
                         check: bool = False, asm_chunk: int = 8,
                         f_chunk: int = 0):
    """Batched LM over B same-topology windows. ``check=True`` validates the
    shared-topology contract on host (requires concrete arrays).

    Assembly variants: ``asm_chunk`` (default 8) assembles the batch in
    chunks of that many windows under ``lax.map``, keeping every
    intermediate at chunk size; ``asm_chunk=0`` assembles the whole batch
    at once, optionally chunked along the factor axis (``f_chunk``)."""
    if check:
        assert_shared_topology(families_b)
    sl = options.scan_length or options.max_iterations
    n_iter = jnp.asarray(min(options.max_iterations, sl), jnp.int32)
    static = options._replace(max_iterations=0, scan_length=sl)
    return _solve_shared_impl(window_b, families_b, losses, static, n_iter,
                              asm_chunk, f_chunk)
