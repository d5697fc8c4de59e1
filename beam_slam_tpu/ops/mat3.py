"""Batched closed-form 3x3 linear algebra.

XLA lowers ``jnp.linalg.inv``/``jnp.linalg.solve`` on batched small matrices
to a LU-factorization custom call — an unfusible kernel launch that
serializes against the surrounding elementwise work. For the 3x3 SPD blocks
that dominate this framework (Schur landmark blocks, LOAM plane fits,
GICP covariances) the cofactor/adjugate form is pure elementwise math that XLA
fuses into the surrounding computation. Callers must damp/floor their
blocks away from singularity (the adjugate divides by det).
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Cofactor inverse of [..., 3, 3] matrices (elementwise, fusible)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / det
    rows = jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c10, c11, c12], axis=-1),
        jnp.stack([c20, c21, c22], axis=-1),
    ], axis=-2)
    return rows * inv_det[..., None, None]


def solve3x3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = A⁻¹ b for [..., 3, 3] @ [..., 3] via the cofactor inverse."""
    return jnp.einsum("...ij,...j->...i", inv3x3(A), b)
