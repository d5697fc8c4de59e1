"""Fixed-radius neighbourhood moments (lidar/registration._radius_moments)
against a NumPy float64 brute-force oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from beam_slam_tpu.lidar.registration import _radius_moments


def _oracle(q, r, valid, rad):
    q = q.astype(np.float64)
    r = r.astype(np.float64)
    n = np.zeros(len(q))
    c = np.zeros((len(q), 3))
    S = np.zeros((len(q), 3, 3))
    for i, x in enumerate(q):
        nb = r[valid & (np.sum((r - x) ** 2, axis=1) < rad * rad)]
        n[i] = len(nb)
        if len(nb):
            c[i] = nb.mean(0)
            X = nb - c[i]
            S[i] = X.T @ X
    return n, c, S


@pytest.mark.parametrize("Q,R,rad", [(300, 1000, 0.4), (64, 2048, 0.3),
                                     (257, 513, 1.0)])
def test_radius_moments_match_brute_force(Q, R, rad):
    rng = np.random.default_rng(Q + R)
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, (R, 3)).astype(np.float32)
    valid = rng.random(R) > 0.2
    n, c, S = _radius_moments(jnp.asarray(q), jnp.asarray(r),
                              jnp.asarray(valid), rad)
    n_o, c_o, S_o = _oracle(q, r, valid, rad)
    np.testing.assert_array_equal(np.asarray(n), n_o)
    has = n_o > 0
    np.testing.assert_allclose(np.asarray(c)[has], c_o[has], atol=1e-4)
    np.testing.assert_allclose(np.asarray(S)[has], S_o[has], atol=5e-3)


def test_radius_moments_empty_neighborhood():
    """Queries with no neighbors inside the radius: n = 0, centroid and
    scatter well-defined."""
    q = jnp.asarray([[100.0, 100.0, 100.0]], jnp.float32)
    r = jnp.asarray(np.zeros((64, 3), np.float32))
    valid = jnp.ones(64, bool)
    n, c, S = _radius_moments(q, r, valid, 0.5)
    assert float(n[0]) == 0.0
    assert np.isfinite(np.asarray(c)).all()
    assert np.isfinite(np.asarray(S)).all()
