"""Multi-host tier: hybrid 2D mesh construction, owner-locality
factor ordering, and the hierarchical coupled PGO solve — exercised on the
8-virtual-device CPU backend folded into a 2-host × 4-chip topology
(conftest forces --xla_force_host_platform_device_count=8)."""

import numpy as np
import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.parallel import distributed_pgo as dpgo
from beam_slam_tpu.parallel import multihost as mh


def _ring_problem(N, seed=0, noise=0.05):
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False).astype(np.float32)
    p_gt = np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1)
    q_gt = np.stack([np.asarray(lie.so3_exp_quat(
        jnp.asarray([0, 0, a], jnp.float32))) for a in ang])
    rng = np.random.default_rng(seed)
    p_init = p_gt + rng.standard_normal(p_gt.shape).astype(np.float32) * noise
    p_init[0] = p_gt[0]
    state = dpgo.PGOState(q=jnp.asarray(q_gt), p=jnp.asarray(p_init),
                          free=jnp.ones(N, bool).at[0].set(False))

    def rel(i, j):
        dq = np.asarray(lie.quat_mul(lie.quat_conj(jnp.asarray(q_gt[i])),
                                     jnp.asarray(q_gt[j])))
        dp = np.asarray(lie.quat_rotate(lie.quat_conj(jnp.asarray(q_gt[i])),
                                        jnp.asarray(p_gt[j] - p_gt[i])))
        return dq, dp

    pairs = [(i, i + 1) for i in range(N - 1)] + [(0, N // 2), (N // 4,
                                                               3 * N // 4)]
    fac = dpgo.PGOFactors.zeros(len(pairs))
    for k, (i, j) in enumerate(pairs):
        dq, dp = rel(i, j)
        fac = fac._replace(
            i=fac.i.at[k].set(i), j=fac.j.at[k].set(j),
            dq=fac.dq.at[k].set(jnp.asarray(dq)),
            dp=fac.dp.at[k].set(jnp.asarray(dp)),
            sqrt_info=fac.sqrt_info.at[k].set(1e2 * jnp.eye(6)),
            active=fac.active.at[k].set(True))
    pri = dpgo.PGOPriors.zeros(2)
    pri = pri._replace(
        q0=pri.q0.at[0].set(jnp.asarray(q_gt[0])),
        p0=pri.p0.at[0].set(jnp.asarray(p_gt[0])),
        sqrt_info=pri.sqrt_info.at[0].set(1e3 * jnp.eye(6)),
        active=pri.active.at[0].set(True))
    return state, fac, pri, p_gt


def test_hybrid_mesh_shape():
    mesh = mh.make_hybrid_mesh(n_hosts=2, devices_per_host=4)
    assert mesh.axis_names == (mh.HOST_AXIS, mh.SHARD_AXIS)
    assert mesh.shape[mh.HOST_AXIS] == 2
    assert mesh.shape[mh.SHARD_AXIS] == 4


def test_owner_assignment_keeps_chains_local():
    N = 32
    _, fac, _, _ = _ring_problem(N)
    n_hosts = 4
    ordered = mh.order_factors_by_owner(fac, N, n_hosts)
    F = int(ordered.i.shape[0])
    per = -(-F // n_hosts)
    i_np = np.asarray(ordered.i)
    act = np.asarray(ordered.active)
    owner = mh.owner_of(i_np, N, n_hosts)
    local = 0
    for h in range(n_hosts):
        sl = slice(h * per, min((h + 1) * per, F))
        local += int(np.sum((owner[sl] == h) & act[sl]))
    # all but the spilled tail of active factors sit on their owner host
    assert local >= int(act.sum()) - n_hosts, (local, int(act.sum()))


def test_multihost_pgo_matches_single_device():
    N = 32
    state, fac, pri, p_gt = _ring_problem(N)
    mesh = mh.make_hybrid_mesh(n_hosts=2, devices_per_host=4)
    out_mh, c0_mh, cf_mh = mh.solve_pgo_multihost(
        state, fac, pri, n_iter=8, mesh=mesh)
    out_1, c0_1, cf_1 = dpgo.solve_single(state, fac, pri, n_iter=8)
    jax.block_until_ready((out_mh, out_1))
    assert float(cf_mh) < float(c0_mh)
    # identical math, different partitioning → same optimum
    np.testing.assert_allclose(np.asarray(out_mh.p), np.asarray(out_1.p),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_mh.q), np.asarray(out_1.q),
                               atol=1e-4)
    # and both recover the ring
    err = np.linalg.norm(np.asarray(out_mh.p) - p_gt, axis=1).max()
    assert err < 0.02, err


def test_initialize_from_env_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert mh.initialize_from_env() is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert mh.initialize_from_env() is False
