"""Elementwise small-matrix products for tiny per-factor contractions.

A per-factor ``[2,3] @ [3,3]`` under ``vmap`` lowers to a *batched dot* of
65k tiny matrix products, each its own padded tile of a matrix-product
kernel. Writing the same contractions as broadcast-multiply-reduce keeps
them elementwise: XLA fuses them into the neighboring factor code with no
padding and no extra round trips through device memory.

Use these for any contraction whose contracted dimension is tiny (≤ ~16) and
whose batch dimension is huge (per-factor / per-point math). For genuinely
large contractions keep ``@`` / einsum.
"""

from __future__ import annotations

import jax.numpy as jnp


def mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[..., m, k] @ [..., k, n] as broadcast-mul-reduce (elementwise)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def mv(a: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """[..., m, k] @ [..., k] as broadcast-mul-reduce."""
    return jnp.sum(a * x[..., None, :], axis=-1)


def vm(x: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """[..., k] @ [..., k, n]."""
    return jnp.sum(x[..., :, None] * a, axis=-2)


def gram_r(J: jnp.ndarray) -> jnp.ndarray:
    """Σ_r J[..., r, :] ⊗ J[..., r, :]  ([..., R, D] → [..., D, D]).

    The per-factor normal-equation Gram JᵀJ with a tiny residual dim R.
    Unrolled over R: a reduce over a broadcast 5-D product materializes the
    [..., R, D, D] intermediate (measured 3×231 MB per op on the flagship
    batch); the unrolled sum keeps peak memory at the output size."""
    R = J.shape[-2]
    out = J[..., 0, :, None] * J[..., 0, None, :]
    for r in range(1, R):
        out = out + J[..., r, :, None] * J[..., r, None, :]
    return out


def cross_r(Ja: jnp.ndarray, Jb: jnp.ndarray) -> jnp.ndarray:
    """Σ_r Ja[..., r, :] ⊗ Jb[..., r, :]  ([...,R,Da],[...,R,Db] →
    [..., Da, Db]). Pose-landmark coupling blocks."""
    R = Ja.shape[-2]
    out = Ja[..., 0, :, None] * Jb[..., 0, None, :]
    for r in range(1, R):
        out = out + Ja[..., r, :, None] * Jb[..., r, None, :]
    return out


def jtr(J: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Σ_r J[..., r, :] · r[..., r]  ([..., R, D], [..., R] → [..., D])."""
    R = J.shape[-2]
    out = J[..., 0, :] * r[..., 0, None]
    for i in range(1, R):
        out = out + J[..., i, :] * r[..., i, None]
    return out
