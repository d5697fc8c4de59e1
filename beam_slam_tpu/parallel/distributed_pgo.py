"""Coupled cross-shard distributed pose-graph optimization.

The round-1 multi-chip story solved *independent* per-submap windows. This
module is the coupled path (SURVEY.md §7.8, §2.7): one global pose graph —
the whole-trajectory batch optimization of the reference
(bs_models/src/lib/global_mapping/global_map_batch_optimization.cpp:1-519)
and the submap PGO — partitioned over a ``jax.sharding.Mesh``:

  * FACTORS are sharded over the mesh axis (keyframe-range assignment on the
    host puts odometry-chain factors on the shard owning their first pose;
    loop closures land wherever their first endpoint lives — they are the
    cross-shard edges and need no special casing because...);
  * each shard linearizes only its own factors and assembles a LOCAL
    contribution to the GLOBAL normal equations (dense rows via one-hot
    slot→column einsums — the same matmul-only assembly as the single-chip
    solver);
  * one ``lax.psum`` over the mesh reduces H, g, and the cost — the coupled
    global system — after which every shard runs the identical damped solve
    and retraction (replicated, no further communication);
  * the LM accept/reject loop runs entirely inside one ``shard_map`` call —
    compile once, iterate on chip, communicate one [D+1,D+1] psum per
    iteration.

The linearization/JᵀJ work — the dominant cost for big graphs — scales
1/n_devices; the reduced system stays replicated (a whole-trajectory pose
graph has 6·N dof, e.g. 6k dof for 1k keyframes — far below chip memory).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from beam_slam_tpu.core import lie

AXIS = "shards"
POSE_DOF = 6


class PGOState(NamedTuple):
    """Global pose state, replicated on every shard."""

    q: jnp.ndarray      # [N, 4]
    p: jnp.ndarray      # [N, 3]
    free: jnp.ndarray   # [N] bool — active & !held


class PGOFactors(NamedTuple):
    """Relative-pose factors, sharded along the factor axis. ``i``/``j``
    index GLOBAL pose slots (cross-shard edges just work: the state is
    replicated, only the reduction is collective)."""

    i: jnp.ndarray          # [F] int32
    j: jnp.ndarray          # [F] int32
    dq: jnp.ndarray         # [F, 4] measured q_i⁻¹ q_j
    dp: jnp.ndarray         # [F, 3] measured R_i⁻¹ (p_j - p_i)
    sqrt_info: jnp.ndarray  # [F, 6, 6]
    active: jnp.ndarray     # [F] bool

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "PGOFactors":
        return PGOFactors(
            i=jnp.zeros((F,), jnp.int32), j=jnp.zeros((F,), jnp.int32),
            dq=lie.quat_identity((F,), dtype), dp=jnp.zeros((F, 3), dtype),
            sqrt_info=jnp.zeros((F, 6, 6), dtype),
            active=jnp.zeros((F,), bool))


class PGOPriors(NamedTuple):
    """Absolute pose priors (gauge anchors), sharded like factors."""

    slot: jnp.ndarray       # [Fp] int32
    q0: jnp.ndarray         # [Fp, 4]
    p0: jnp.ndarray         # [Fp, 3]
    sqrt_info: jnp.ndarray  # [Fp, 6, 6]
    active: jnp.ndarray     # [Fp] bool

    @staticmethod
    def zeros(F: int, dtype=jnp.float32) -> "PGOPriors":
        return PGOPriors(
            slot=jnp.zeros((F,), jnp.int32),
            q0=lie.quat_identity((F,), dtype), p0=jnp.zeros((F, 3), dtype),
            sqrt_info=jnp.zeros((F, 6, 6), dtype),
            active=jnp.zeros((F,), bool))


def _rel_residual(q_i, p_i, q_j, p_j, dq, dp, A):
    """[log(dq⁻¹ · (q_i⁻¹ q_j)), R_i⁻¹(p_j − p_i) − dp], whitened — the
    relative-pose residual of the reference PGO factors."""
    q_ij = lie.quat_mul(lie.quat_conj(q_i), q_j)
    r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(dq), q_ij))
    r_p = lie.quat_rotate(lie.quat_conj(q_i), p_j - p_i) - dp
    return A @ jnp.concatenate([r_q, r_p])


def _prior_residual(q, p, q0, p0, A):
    r_q = lie.so3_log(lie.quat_mul(lie.quat_conj(q0), q))
    return A @ jnp.concatenate([r_q, p - p0])


def _local_normal_eqs(state: PGOState, factors: PGOFactors,
                      priors: PGOPriors):
    """This shard's contribution to the global normal equations — dense
    Jacobian rows over all N·6 dof via one-hot einsums, one JᵀJ matmul."""
    N = state.q.shape[0]
    D = N * POSE_DOF
    dtype = state.q.dtype

    # ---- relative factors
    def rel_one(delta, qi, pi, qj, pj, dq, dp, A):
        qi2 = lie.quat_mul(qi, lie.so3_exp_quat(delta[0:3]))
        pi2 = pi + delta[3:6]
        qj2 = lie.quat_mul(qj, lie.so3_exp_quat(delta[6:9]))
        pj2 = pj + delta[9:12]
        return _rel_residual(qi2, pi2, qj2, pj2, dq, dp, A)

    F = factors.i.shape[0]
    gathered = (state.q[factors.i], state.p[factors.i],
                state.q[factors.j], state.p[factors.j])
    zeros = jnp.zeros((F, 12), dtype)
    r = jax.vmap(rel_one)(zeros, *gathered, factors.dq, factors.dp,
                          factors.sqrt_info)
    J = jax.vmap(jax.jacfwd(rel_one, argnums=0))(
        zeros, *gathered, factors.dq, factors.dp, factors.sqrt_info)
    m = factors.active.astype(dtype)
    r = r * m[:, None]
    J = J * m[:, None, None]
    oh_i = jax.nn.one_hot(factors.i, N, dtype=dtype)
    oh_j = jax.nn.one_hot(factors.j, N, dtype=dtype)
    row = (jnp.einsum("frd,fk->frkd", J[:, :, 0:6], oh_i)
           + jnp.einsum("frd,fk->frkd", J[:, :, 6:12], oh_j))
    J_rel = row.reshape(F * POSE_DOF, D)
    r_rel = r.reshape(F * POSE_DOF)

    # ---- priors
    def pr_one(delta, q, p, q0, p0, A):
        q2 = lie.quat_mul(q, lie.so3_exp_quat(delta[0:3]))
        return _prior_residual(q2, p + delta[3:6], q0, p0, A)

    Fp = priors.slot.shape[0]
    zp = jnp.zeros((Fp, POSE_DOF), dtype)
    rp = jax.vmap(pr_one)(zp, state.q[priors.slot], state.p[priors.slot],
                          priors.q0, priors.p0, priors.sqrt_info)
    Jp = jax.vmap(jax.jacfwd(pr_one, argnums=0))(
        zp, state.q[priors.slot], state.p[priors.slot],
        priors.q0, priors.p0, priors.sqrt_info)
    mp = priors.active.astype(dtype)
    rp = rp * mp[:, None]
    Jp = Jp * mp[:, None, None]
    oh_p = jax.nn.one_hot(priors.slot, N, dtype=dtype)
    J_pr = jnp.einsum("frd,fk->frkd", Jp, oh_p).reshape(Fp * POSE_DOF, D)
    r_pr = rp.reshape(Fp * POSE_DOF)

    J_all = jnp.concatenate([J_rel, J_pr], axis=0)
    r_all = jnp.concatenate([r_rel, r_pr])
    H = J_all.T @ J_all
    g = -(J_all.T @ r_all)
    cost = 0.5 * (jnp.sum(r_rel * r_rel) + jnp.sum(r_pr * r_pr))
    return H, g, cost


def _local_cost(state, factors, priors):
    dtype = state.q.dtype
    r = jax.vmap(_rel_residual)(
        state.q[factors.i], state.p[factors.i],
        state.q[factors.j], state.p[factors.j],
        factors.dq, factors.dp, factors.sqrt_info)
    r = r * factors.active.astype(dtype)[:, None]
    rp = jax.vmap(_prior_residual)(
        state.q[priors.slot], state.p[priors.slot],
        priors.q0, priors.p0, priors.sqrt_info)
    rp = rp * priors.active.astype(dtype)[:, None]
    return 0.5 * (jnp.sum(r * r) + jnp.sum(rp * rp))


def _retract(state: PGOState, delta: jnp.ndarray) -> PGOState:
    N = state.q.shape[0]
    d = (delta.reshape(N, POSE_DOF)
         * state.free.astype(delta.dtype)[:, None])
    return state._replace(
        q=lie.quat_normalize(lie.quat_mul(
            state.q, lie.so3_exp_quat(d[:, 0:3]))),
        p=state.p + d[:, 3:6])


def _damped_solve(H, g, lam, free_dof):
    dtype = H.dtype
    Dp = H.shape[0]
    f = free_dof.astype(dtype)
    Hm = H * (f[:, None] * f[None, :]) + jnp.diag(1.0 - f)
    gm = g * f
    d = jnp.diagonal(Hm)
    s = jax.lax.rsqrt(jnp.maximum(d, 1e-12))
    Hs = Hm * (s[:, None] * s[None, :]) + lam * jnp.eye(Dp, dtype=dtype)
    Lc = jnp.linalg.cholesky(Hs)
    y = jax.scipy.linalg.cho_solve((Lc, True), gm * s)
    delta = y * s * f
    ok = jnp.all(jnp.isfinite(delta))
    return jnp.where(ok, delta, 0.0), ok


def _lm_loop(state: PGOState, factors: PGOFactors, priors: PGOPriors,
             n_iter: int, axes=AXIS):
    """Runs INSIDE shard_map: factors/priors are this shard's slice, state
    is replicated. One psum of (H, g, cost) per iteration. ``axes`` may be
    a tuple (hybrid hosts × shards mesh): the psum then runs over both
    axes — within each host's NVLink-joined devices and across hosts."""
    N = state.q.shape[0]
    free_dof = jnp.repeat(state.free, POSE_DOF)

    def assemble(st):
        H, g, cost = _local_normal_eqs(st, factors, priors)
        H = jax.lax.psum(H, axes)
        g = jax.lax.psum(g, axes)
        cost = jax.lax.psum(cost, axes)
        return H, g, cost

    H0, g0, c0 = assemble(state)

    def step(carry, _):
        st, H, g, cost, lam = carry
        delta, ok = _damped_solve(H, g, lam, free_dof)
        trial = _retract(st, delta)
        H_t, g_t, c_t = assemble(trial)
        accept = ok & (c_t < cost)
        st = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, b, a), st, trial)
        H, g = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, b, a), (H, g), (H_t, g_t))
        cost = jnp.where(accept, c_t, cost)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-12),
                        jnp.minimum(lam * 4.0, 1e8))
        return (st, H, g, cost, lam), cost

    lam0 = jnp.asarray(1e-4, state.q.dtype)
    (state, _, _, cost, _), costs = jax.lax.scan(
        step, (state, H0, g0, c0, lam0), None, length=n_iter)
    return state, c0, cost


def pad_factors(factors: PGOFactors, n_shards: int) -> PGOFactors:
    F = factors.i.shape[0]
    Fp = -(-F // n_shards) * n_shards
    if Fp == F:
        return factors
    pad = Fp - F
    return jax.tree_util.tree_map(
        lambda x: jnp.concatenate(
            [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]), factors)


def pad_priors(priors: PGOPriors, n_shards: int) -> PGOPriors:
    F = priors.slot.shape[0]
    Fp = -(-F // n_shards) * n_shards
    if Fp == F:
        return priors
    pad = Fp - F
    return jax.tree_util.tree_map(
        lambda x: jnp.concatenate(
            [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]), priors)


@functools.partial(jax.jit, static_argnames=("mesh", "n_iter", "axes"))
def _solve_impl(state, factors, priors, mesh: Mesh, n_iter: int,
                axes=AXIS):
    fn = jax.shard_map(
        functools.partial(_lm_loop, n_iter=n_iter, axes=axes),
        mesh=mesh,
        in_specs=(P(), P(axes), P(axes)),
        out_specs=(P(), P(), P()),
        check_vma=False)
    return fn(state, factors, priors)


def solve_distributed(mesh: Mesh, state: PGOState, factors: PGOFactors,
                      priors: PGOPriors, n_iter: int = 20):
    """Coupled distributed LM over the global pose graph. Factors/priors are
    padded to the shard count and sharded over the mesh; the state is
    replicated. Returns (state, initial_cost, final_cost)."""
    n_shards = int(np.prod(list(mesh.shape.values())))
    factors = pad_factors(factors, n_shards)
    priors = pad_priors(priors, n_shards)
    factors = jax.device_put(factors, NamedSharding(mesh, P(AXIS)))
    priors = jax.device_put(priors, NamedSharding(mesh, P(AXIS)))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    return _solve_impl(state, factors, priors, mesh, n_iter)


def solve_distributed_hybrid(mesh: Mesh, state: PGOState,
                             factors: PGOFactors, priors: PGOPriors,
                             n_iter: int = 20):
    """Coupled distributed LM over a 2D (host × device) mesh — the
    multi-host tier (:mod:`beam_slam_tpu.parallel.multihost` builds the
    mesh and the locality-preserving factor order). Factors are sharded
    over BOTH axes; the per-iteration global reduction runs over both
    (NVLink inside a host, the host network across hosts)."""
    axes = tuple(mesh.axis_names)
    n_shards = int(np.prod(list(mesh.shape.values())))
    factors = pad_factors(factors, n_shards)
    priors = pad_priors(priors, n_shards)
    factors = jax.device_put(factors, NamedSharding(mesh, P(axes)))
    priors = jax.device_put(priors, NamedSharding(mesh, P(axes)))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    return _solve_impl(state, factors, priors, mesh, n_iter, axes)


def solve_single(state: PGOState, factors: PGOFactors, priors: PGOPriors,
                 n_iter: int = 20):
    """Serial reference: the identical LM loop on one device (psum over a
    1-device mesh)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]), (AXIS,))
    return solve_distributed(mesh, state, factors, priors, n_iter)
