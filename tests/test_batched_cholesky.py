"""The batched damped Schur solve (solver/gauss_newton.solve_damped_batched:
vmapped landmark Schur complement + Cholesky + back-substitution) against a
NumPy float64 solve of the full, unreduced system."""

import numpy as np
import pytest

import jax.numpy as jnp

from beam_slam_tpu.solver import gauss_newton as gn


def _make_system(seed, B, N, L=6):
    """B SPD systems over N dense dof plus L landmarks (3×3 diagonal
    blocks), returned in the solver's split form and as the full matrix."""
    rng = np.random.default_rng(seed)
    n_full = N + 3 * L
    H_full = np.zeros((B, n_full, n_full))
    for b in range(B):
        A = rng.standard_normal((n_full + 8, n_full))
        M = A.T @ A / n_full + 0.1 * np.eye(n_full)
        # landmark-landmark coupling is block diagonal by construction of
        # the Schur elimination (one 3×3 block per landmark)
        lm = M[N:, N:]
        mask = np.kron(np.eye(L), np.ones((3, 3)))
        M[N:, N:] = lm * mask + np.eye(3 * L) * np.abs(lm).sum(1).max()
        H_full[b] = M
    g_full = rng.standard_normal((B, n_full))
    H = H_full[:, :N, :N]
    W = H_full[:, :N, N:]
    H_ll = np.stack([np.stack([H_full[b, N + 3 * i:N + 3 * i + 3,
                                      N + 3 * i:N + 3 * i + 3]
                               for i in range(L)]) for b in range(B)])
    args = (jnp.asarray(H, jnp.float32), jnp.asarray(g_full[:, :N],
                                                       jnp.float32),
            jnp.ones((B, N), bool), jnp.zeros((B,), jnp.float32),
            jnp.asarray(H_ll, jnp.float32),
            jnp.asarray(g_full[:, N:].reshape(B, L, 3), jnp.float32),
            jnp.asarray(W, jnp.float32), jnp.ones((B, L), bool))
    return args, H_full, g_full


def _oracle(H_full, g_full):
    return np.stack([np.linalg.solve(H, g) for H, g in zip(H_full, g_full)])


@pytest.mark.parametrize("B,N", [(3, 128), (8, 256), (5, 640)])
def test_matches_float64_solve(B, N):
    args, H_full, g_full = _make_system(B + N, B, N)
    delta, delta_l, ok = gn.solve_damped_batched(*args)
    x = np.concatenate([np.asarray(delta),
                        np.asarray(delta_l).reshape(B, -1)], axis=1)
    x_ref = _oracle(H_full, g_full)
    assert np.asarray(ok).all()
    scale = np.abs(x_ref).max()
    np.testing.assert_allclose(x, x_ref, atol=2e-3 * scale, rtol=2e-3)


def test_residual_is_small():
    """Direct residual ||H x - g|| of the full system."""
    B, N = 4, 384
    args, H_full, g_full = _make_system(7, B, N)
    delta, delta_l, _ = gn.solve_damped_batched(*args)
    x = np.concatenate([np.asarray(delta, np.float64),
                        np.asarray(delta_l, np.float64).reshape(B, -1)], 1)
    r = np.einsum("bij,bj->bi", H_full, x) - g_full
    assert np.abs(r).max() < 1e-2 * np.abs(g_full).max()


def test_identity_padding():
    """A dof count off the 128 grid pads the reduced system with identity
    rows; the solution must not see them."""
    B, N = 3, 200
    args, H_full, g_full = _make_system(3, B, N)
    delta, delta_l, _ = gn.solve_damped_batched(*args)
    assert delta.shape == (B, N)
    x = np.concatenate([np.asarray(delta),
                        np.asarray(delta_l).reshape(B, -1)], axis=1)
    x_ref = _oracle(H_full, g_full)
    np.testing.assert_allclose(x, x_ref, atol=2e-3 * np.abs(x_ref).max(),
                               rtol=2e-3)
