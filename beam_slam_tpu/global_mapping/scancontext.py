"""ScanContext descriptors for loop-closure candidate search.

JAX replacement for libbeam's ``beam_matching/Scancontext.h`` as used
by reloc::RelocCandidateSearchScanContext
(bs_models/src/lib/reloc/reloc_candidate_search_scan_context.cpp): a polar
max-height histogram per scan; similarity = min over yaw (column) shifts of
the mean column-wise cosine distance; plus the 1-D "ring key" used for fast
pre-filtering.

Everything is batched: descriptor construction is one scatter-max, database
search evaluates all (candidate × shift) pairs as a single einsum — the
batched-cosine-distance design of SURVEY.md §7.8.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class ScanContextConfig(NamedTuple):
    n_rings: int = 20
    n_sectors: int = 60
    max_range: float = 80.0


@partial(jax.jit, static_argnums=(2,))
def make_descriptor(points: jnp.ndarray, valid: jnp.ndarray,
                    cfg: ScanContextConfig = ScanContextConfig()):
    """points [N,3] in the sensor frame → descriptor [n_rings, n_sectors]
    (max z per polar bin; empty bins = 0, matching ScanContext)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = jnp.sqrt(x * x + y * y)
    az = jnp.arctan2(y, x)  # [-pi, pi)
    ring = jnp.clip((r / cfg.max_range * cfg.n_rings).astype(jnp.int32),
                    0, cfg.n_rings - 1)
    sector = jnp.clip(((az + jnp.pi) / (2 * jnp.pi)
                       * cfg.n_sectors).astype(jnp.int32),
                      0, cfg.n_sectors - 1)
    flat = ring * cfg.n_sectors + sector
    flat = jnp.where(valid, flat, cfg.n_rings * cfg.n_sectors)  # trash bin
    desc = jnp.full((cfg.n_rings * cfg.n_sectors + 1,), -jnp.inf,
                    points.dtype)
    desc = desc.at[flat].max(jnp.where(valid, z, -jnp.inf))
    desc = jnp.where(jnp.isfinite(desc), desc, 0.0)
    return desc[:-1].reshape(cfg.n_rings, cfg.n_sectors)


def ring_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Rotation-invariant ring key: per-ring occupancy mean. [R,S] → [R]."""
    return jnp.mean((desc != 0.0).astype(desc.dtype), axis=1)


@jax.jit
def distance(desc_a: jnp.ndarray, desc_b: jnp.ndarray):
    """ScanContext distance: min over column shifts of the mean column
    cosine distance. Returns (dist, best_shift)."""
    S = desc_a.shape[1]

    def shifted_dist(shift):
        b = jnp.roll(desc_b, shift, axis=1)
        num = jnp.sum(desc_a * b, axis=0)
        den = (jnp.linalg.norm(desc_a, axis=0)
               * jnp.linalg.norm(b, axis=0))
        cos = jnp.where(den > 1e-9, num / jnp.maximum(den, 1e-9), 0.0)
        cnt = jnp.sum(den > 1e-9)
        return 1.0 - jnp.sum(cos) / jnp.maximum(cnt, 1)

    dists = jax.vmap(shifted_dist)(jnp.arange(S))
    best = jnp.argmin(dists)
    return dists[best], best


@jax.jit
def search(query: jnp.ndarray, database: jnp.ndarray,
           db_valid: jnp.ndarray):
    """Distances of query [R,S] against database [N,R,S] (all shifts, all
    entries at once). Returns (dists [N], best_shifts [N]); invalid entries
    get +inf."""
    def one(db_entry):
        return distance(query, db_entry)
    dists, shifts = jax.vmap(one)(database)
    dists = jnp.where(db_valid, dists, jnp.inf)
    return dists, shifts
