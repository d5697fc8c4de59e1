"""Shared-topology batched solver vs the generic vmapped solve.

The shared path (solver/batched.py) restructures every gather/scatter as
GEMMs with the batch folded in; it must produce the same normal equations
and the same LM trajectory as the generic per-window path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from beam_slam_tpu.parallel import sharded
from beam_slam_tpu.solver import batched as bs
from beam_slam_tpu.solver import gauss_newton as gn
from beam_slam_tpu.utils import synthetic

LOSSES = (None, None, 1.0, 2.0, 2.0)


@pytest.fixture(scope="module")
def batch():
    build = lambda k: synthetic.build_lvio_window(
        k, n_kf=8, kf_dt=0.25, with_vision=True, n_landmarks=16,
        obs_per_lm=4, n_idp=8)[:2]
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    wins, fams = jax.jit(jax.vmap(build))(keys)
    return jax.block_until_ready((wins, fams))


def test_shared_topology_contract(batch):
    wins, fams = batch
    bs.assert_shared_topology(fams)  # synthetic builder is key-independent


def test_assemble_shared_matches_generic(batch):
    """Normal equations from the shared batched assembly == vmapped generic
    scatter assembly."""
    wins, fams = batch
    ref = jax.jit(jax.vmap(
        lambda w, f: gn.assemble_normal_equations(w, f, LOSSES),
        in_axes=(0, 0)))(wins, fams)
    out = jax.jit(lambda w, f: bs.assemble_shared(w, f, LOSSES))(wins, fams)
    names = ("H", "g", "H_ll", "g_l", "W", "cost")
    for name, a, b in zip(names, ref, out):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=name)


def test_solve_batched_shared_matches_generic(batch):
    """Final states of the shared batched LM == the generic vmapped LM."""
    wins, fams = batch
    options = gn.SolverOptions(max_iterations=8, scan_length=8)
    ref_w, ref_d = jax.block_until_ready(
        sharded.solve_batched(wins, fams, LOSSES, options))
    out_w, out_d = jax.block_until_ready(
        bs.solve_batched_shared(wins, fams, LOSSES, options, check=True))
    np.testing.assert_allclose(np.asarray(out_w.imu.p),
                               np.asarray(ref_w.imu.p), atol=5e-4)
    np.testing.assert_allclose(np.asarray(out_w.imu.q),
                               np.asarray(ref_w.imu.q), atol=5e-4)
    np.testing.assert_allclose(np.asarray(out_w.landmarks.pt),
                               np.asarray(ref_w.landmarks.pt), atol=5e-3)
    # both converge to comparable cost
    np.testing.assert_allclose(np.asarray(out_d.final_cost),
                               np.asarray(ref_d.final_cost), rtol=1e-2)


def test_solve_batched_shared_reduces_cost(batch):
    wins, fams = batch
    options = gn.SolverOptions(max_iterations=8, scan_length=8)
    out_w, diag = jax.block_until_ready(
        bs.solve_batched_shared(wins, fams, LOSSES, options))
    assert (np.asarray(diag.final_cost)
            < 0.1 * np.asarray(diag.initial_cost)).all()


def test_assert_shared_topology_rejects_mismatch(batch):
    wins, fams = batch
    bad = list(fams)
    f0 = bad[0]
    slots = np.asarray(f0.slots).copy()
    slots[1, 0, 0] += 1  # window 1 differs
    bad[0] = f0.replace(slots=jnp.asarray(slots))
    with pytest.raises(ValueError, match="slots differ"):
        bs.assert_shared_topology(tuple(bad))


def test_assemble_shared_fchunked_matches_unchunked(batch):
    """Factor-axis-chunked assembly (f_chunk) must produce
    the same normal equations as the whole-family pass. f_chunk=16 forces
    chunking on the reprojection (F=64) and IDP (F=24) families here."""
    wins, fams = batch
    ref = jax.jit(lambda w, f: bs.assemble_shared(w, f, LOSSES))(wins, fams)
    out = jax.jit(lambda w, f: bs.assemble_shared(
        w, f, LOSSES, f_chunk=16))(wins, fams)
    names = ("H", "g", "H_ll", "g_l", "W", "cost")
    for name, a, b in zip(names, ref, out):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=2e-5 * scale, rtol=2e-5,
                                   err_msg=name)


def test_solve_batched_shared_fchunked_matches(batch):
    """Full LM through the F-chunked assembly == unchunked."""
    wins, fams = batch
    options = gn.SolverOptions(max_iterations=6, scan_length=6)
    ref_w, _ = jax.block_until_ready(
        bs.solve_batched_shared(wins, fams, LOSSES, options, f_chunk=0))
    out_w, _ = jax.block_until_ready(
        bs.solve_batched_shared(wins, fams, LOSSES, options, f_chunk=16))
    np.testing.assert_allclose(np.asarray(out_w.imu.p),
                               np.asarray(ref_w.imu.p), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_w.landmarks.pt),
                               np.asarray(ref_w.landmarks.pt), atol=1e-3)


def test_solve_batched_shared_early_exit(batch):
    """Batched early exit: all-done while_loop terminates and matches the
    fixed-length scan states."""
    wins, fams = batch
    opt_scan = gn.SolverOptions(max_iterations=8, scan_length=8)
    opt_ee = gn.SolverOptions(max_iterations=8, early_exit=True)
    w_scan, _ = jax.block_until_ready(
        bs.solve_batched_shared(wins, fams, LOSSES, opt_scan))
    w_ee, d_ee = jax.block_until_ready(
        bs.solve_batched_shared(wins, fams, LOSSES, opt_ee))
    np.testing.assert_allclose(np.asarray(w_ee.imu.p),
                               np.asarray(w_scan.imu.p), atol=1e-5)
