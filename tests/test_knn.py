"""Brute-force kNN (ops/knn.py) against a NumPy float64 brute-force
oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from beam_slam_tpu.ops.knn import knn_topk


def _oracle(q, r, valid, k):
    d2 = np.sum((q[:, None, :].astype(np.float64)
                 - r[None, :, :].astype(np.float64)) ** 2, axis=-1)
    d2 = np.where(valid[None, :], d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d2, idx, axis=1)


def _check(q, r, valid, k, rtol, atol=1e-4, min_same=0.99):
    i_x, d_x = knn_topk(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid), k)
    i_x, d_x = np.asarray(i_x), np.asarray(d_x)
    i_o, d_o = _oracle(q, r, valid, k)
    np.testing.assert_allclose(d_x, d_o, rtol=rtol, atol=atol)
    same = [set(a) == set(b) for a, b in zip(i_x, i_o)]
    assert np.mean(same) >= min_same


@pytest.mark.parametrize("Q,R,k", [(300, 1000, 5), (64, 300, 10),
                                   (257, 513, 3)])
def test_knn_matches_brute_force(Q, R, k):
    rng = np.random.default_rng(Q + R + k)
    q = rng.uniform(-10, 10, (Q, 3)).astype(np.float32)
    r = rng.uniform(-10, 10, (R, 3)).astype(np.float32)
    valid = rng.random(R) > 0.2
    _check(q, r, valid, k, rtol=1e-4)


def test_knn_far_from_origin():
    """Map coordinates 50 m out with half-metre neighbour spacing: the
    |q|²+|r|²−2q·r form cancels there. At full f32 its error stays ~1e-3 m²
    and the neighbour sets hold; a cross term with TF32 inputs (10-bit
    mantissa) errs by several m² and gets almost no neighbour set right."""
    rng = np.random.default_rng(5)
    grid = np.stack(np.meshgrid(*[np.arange(10) * 0.5] * 3,
                                indexing="ij"), -1).reshape(-1, 3)
    r = (grid + 50.0 + rng.uniform(-0.1, 0.1, grid.shape)).astype(
        np.float32)
    q = (50.0 + rng.uniform(0.5, 4.5, (200, 3))).astype(np.float32)
    _check(q, r, np.ones(len(r), bool), 5, rtol=0.0, atol=1e-2,
           min_same=0.95)


@pytest.mark.parametrize("module", ["registration", "matchers"])
def test_registration_knn_call_site(module):
    """The LOAM registration and the ICP/GICP matchers search
    correspondences through knn_topk."""
    import importlib
    import beam_slam_tpu.ops.knn as knn
    mod = importlib.import_module(f"beam_slam_tpu.lidar.{module}")
    assert mod.knn_topk is knn.knn_topk
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.uniform(-5, 5, (100, 3)).astype(np.float32))
    r = jnp.asarray(rng.uniform(-5, 5, (400, 3)).astype(np.float32))
    v = jnp.ones(400, bool)
    idx, d2 = mod.knn_topk(q, r, v, 5)
    D = np.linalg.norm(np.asarray(q)[:, None] - np.asarray(r)[None], axis=2)
    np.testing.assert_allclose(np.sort(np.asarray(d2), 1),
                               np.sort(D, 1)[:, :5] ** 2, rtol=1e-4,
                               atol=1e-4)
