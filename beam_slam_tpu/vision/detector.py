"""FAST corner detection with grid-cell spatial suppression.

JAX replacement for the reference's detector stage
(VisualFeatureTracker uses beam_cv FASTSSC detection —
bs_models/src/visual_feature_tracker.cpp; FAST corners + spatial suppression
for even coverage). Fully vectorized over the image: the 16-point Bresenham
circle is evaluated with ``jnp.roll`` shifts, arc contiguity with a stacked
window-AND, and suppression via per-grid-cell top-1 — fixed feature capacity
= number of cells, jit-stable.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# FAST circle of radius 3 (Bresenham), clockwise from 12 o'clock: (dy, dx)
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class FastConfig(NamedTuple):
    threshold: float = 20.0      # intensity threshold (0-255 scale)
    arc_length: int = 9          # FAST-9
    cell_size: int = 32          # suppression grid cell (px)
    border: int = 4


def fast_score(image: jnp.ndarray, cfg: FastConfig = FastConfig()):
    """Per-pixel FAST corner score ([H, W]; 0 where not a corner)."""
    img = image.astype(jnp.float32)
    shifted = jnp.stack([jnp.roll(img, (-dy, -dx), axis=(0, 1))
                         for dy, dx in _CIRCLE])          # [16, H, W]
    diff = shifted - img[None]
    bright = diff > cfg.threshold
    dark = diff < -cfg.threshold

    def contiguous(mask):
        ext = jnp.concatenate([mask, mask[: cfg.arc_length - 1]], axis=0)
        hit = jnp.zeros_like(mask[0])
        for k in range(16):
            hit = hit | jnp.all(ext[k: k + cfg.arc_length], axis=0)
        return hit

    corner = contiguous(bright) | contiguous(dark)
    score = jnp.sum(jnp.maximum(jnp.abs(diff) - cfg.threshold, 0.0), axis=0)
    score = jnp.where(corner, score, 0.0)
    # zero the border
    H, W = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    b = cfg.border
    inside = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    return jnp.where(inside, score, 0.0)


def detect(image: jnp.ndarray, cfg: FastConfig = FastConfig()
           ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detect corners with one winner per grid cell.

    Returns (xy [N, 2] float32 (x, y), score [N], valid [N]) with
    N = (H // cell) * (W // cell), fixed for a given image size.
    """
    score = fast_score(image, cfg)
    H, W = score.shape
    c = cfg.cell_size
    Hc, Wc = H // c, W // c
    s = score[: Hc * c, : Wc * c].reshape(Hc, c, Wc, c)
    s = s.transpose(0, 2, 1, 3).reshape(Hc, Wc, c * c)
    best = jnp.argmax(s, axis=-1)
    best_score = jnp.take_along_axis(s, best[..., None], axis=-1)[..., 0]
    dy = best // c
    dx = best % c
    yy = (jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc), 0) * c + dy)
    xx = (jax.lax.broadcasted_iota(jnp.int32, (Hc, Wc), 1) * c + dx)
    xy = jnp.stack([xx, yy], axis=-1).reshape(-1, 2).astype(jnp.float32)
    best_score = best_score.reshape(-1)
    return xy, best_score, best_score > 0.0
