"""Binary feature descriptors + matching.

JAX replacement for the reference's ORB descriptor usage
(VisualFeatureTracker extracts ORB descriptors —
bs_models/src/visual_feature_tracker.cpp; VisualOdometry matches them during
local-map search, and the ImageDatabase builds bag-of-words queries).

Design: BRIEF-style binary tests on a fixed pseudo-random pattern, batched
over keypoints with bilinear sampling; descriptors packed into uint32 words;
Hamming distances via XOR + ``lax.population_count`` as one [N, M] batched
op. Rotation invariance comes from steering the pattern by the patch's
intensity-centroid orientation (the ORB construction).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from beam_slam_tpu.vision.tracker import _bilinear

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH_R = 12.0


def _pattern(key=None):
    """Fixed BRIEF sampling pattern: [N_BITS, 2, 2] (pairs of (x, y))."""
    key = jax.random.PRNGKey(7) if key is None else key
    pts = jax.random.normal(key, (N_BITS, 2, 2)) * (PATCH_R / 2.5)
    return jnp.clip(pts, -PATCH_R, PATCH_R)


_PATTERN = _pattern()


@jax.jit
def orientations(image: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint (ORB): angle of the
    first-moment vector over a circular patch."""
    r = int(PATCH_R)
    dy, dx = jnp.meshgrid(jnp.arange(-r, r + 1, dtype=jnp.float32),
                          jnp.arange(-r, r + 1, dtype=jnp.float32),
                          indexing="ij")
    mask = (dx * dx + dy * dy) <= r * r

    def one(pt):
        patch = _bilinear(image, pt[None, None, :]
                          + jnp.stack([dx, dy], -1)) * mask
        m10 = jnp.sum(patch * dx)
        m01 = jnp.sum(patch * dy)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(xy)


@jax.jit
def compute(image: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Descriptors for keypoints xy [N,2] on image [H,W].
    Returns (desc [N, N_WORDS] uint32, ok [N])."""
    image = image.astype(jnp.float32)
    H, W = image.shape
    th = orientations(image, xy)
    c, s = jnp.cos(th), jnp.sin(th)
    R = jnp.stack([jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2)

    def one(pt, Rk):
        pat = jnp.einsum("ij,bpj->bpi", Rk, _PATTERN)  # steered pattern
        pa = pt[None, :] + pat[:, 0]
        pb = pt[None, :] + pat[:, 1]
        bits = (_bilinear(image, pa) < _bilinear(image, pb)).astype(jnp.uint32)
        words = bits.reshape(N_WORDS, 32)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        return jnp.sum(words << shifts[None, :], axis=1, dtype=jnp.uint32)

    desc = jax.vmap(one)(xy, R)
    m = PATCH_R + 2
    inb = ((xy[:, 0] >= m) & (xy[:, 0] < W - m)
           & (xy[:, 1] >= m) & (xy[:, 1] < H - m))
    return desc, valid & inb


@jax.jit
def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Hamming distances: a [N, W] × b [M, W] → [N, M] int32."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnums=())
def match(desc_a, valid_a, desc_b, valid_b, max_distance: int = 64,
          ratio: float = 0.8):
    """Mutual-nearest matching with Lowe's ratio test.
    Returns (idx_b_for_a [N] int32, good [N] bool)."""
    d = hamming_matrix(desc_a, desc_b)
    big = jnp.int32(N_BITS + 1)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], d, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.min(d, axis=1)
    d2 = d.at[jnp.arange(d.shape[0]), best].set(big)
    second_d = jnp.min(d2, axis=1)
    back = jnp.argmin(d, axis=0)
    mutual = back[best] == jnp.arange(d.shape[0])
    good = (valid_a & mutual & (best_d <= max_distance)
            & (best_d.astype(jnp.float32)
               < ratio * second_d.astype(jnp.float32)))
    return best.astype(jnp.int32), good
