"""Brute-force k-nearest-neighbour search for the registration
correspondence step (lidar/registration.py, lidar/matchers.py).

One [Q, R] squared-distance matrix |q|² + |r|² − 2 q·r over all (query,
ref) pairs and an exact ``lax.top_k`` — the kd-tree search of the
reference, in the form a dense accelerator runs well.

The cross term cancels against the norms at map coordinates of tens of
metres, so its matmul asks for full f32 ("highest") whatever the default
precision: in TF32 its error exceeds the neighbour spacing.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("k",))
def knn_topk(query: jnp.ndarray, ref: jnp.ndarray, ref_valid: jnp.ndarray,
             k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k nearest refs per query point: (idx [Q,k], d2 [Q,k]), nearest
    first. Invalid refs sit at +inf distance — gate with max_corr_dist."""
    d2 = (jnp.sum(query * query, axis=1, keepdims=True)
          + jnp.sum(ref * ref, axis=1)[None, :]
          - 2.0 * jnp.matmul(query, ref.T,
                             precision=jax.lax.Precision.HIGHEST))
    d2 = jnp.where(ref_valid[None, :], d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2, k)
    return idx, -neg
