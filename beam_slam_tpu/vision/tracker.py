"""Pyramidal Lucas-Kanade feature tracking.

JAX replacement for the reference's KLT-style tracker
(beam_cv::Tracker driven by VisualFeatureTracker,
bs_models/src/visual_feature_tracker.cpp — detector + descriptor + tracker
producing per-landmark pixel tracks). Dense, regular compute: patches are
sampled with bilinear gathers, the 2×2 normal equations are closed-form, and
everything is vmapped over the feature axis — no data-dependent shapes.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class LKConfig(NamedTuple):
    levels: int = 3           # pyramid levels (coarse to fine)
    window: int = 7           # patch side (odd)
    iterations: int = 8       # per-level GN iterations
    min_det: float = 1e-4     # Hessian degeneracy gate
    max_error: float = 12.0   # mean abs photometric error gate (0-255)
    max_motion: float = 60.0  # max total displacement (px, finest level)


def build_pyramid(image: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """Simple 2x2 average-pool pyramid, finest first."""
    img = image.astype(jnp.float32)
    pyr = [img]
    for _ in range(levels - 1):
        H, W = img.shape
        img = img[: H // 2 * 2, : W // 2 * 2].reshape(H // 2, 2, W // 2, 2)
        img = img.mean(axis=(1, 3))
        pyr.append(img)
    return pyr


def _bilinear(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img at (x, y) locations. xy [..., 2] → [...]."""
    x, y = xy[..., 0], xy[..., 1]
    H, W = img.shape
    x0 = jnp.clip(jnp.floor(x), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0, H - 2).astype(jnp.int32)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11))


def _track_level(prev_img, next_img, pt_prev, pt_next, cfg: LKConfig):
    """One pyramid level of LK for a single feature (vmapped by caller)."""
    w = cfg.window // 2
    dy, dx = jnp.meshgrid(jnp.arange(-w, w + 1, dtype=jnp.float32),
                          jnp.arange(-w, w + 1, dtype=jnp.float32),
                          indexing="ij")
    offs = jnp.stack([dx.ravel(), dy.ravel()], axis=-1)    # [w², 2]

    base = pt_prev[None, :] + offs
    T = _bilinear(prev_img, base)
    # template gradients (central differences on the prev image)
    gx = (_bilinear(prev_img, base + jnp.asarray([0.5, 0.0]))
          - _bilinear(prev_img, base - jnp.asarray([0.5, 0.0])))
    gy = (_bilinear(prev_img, base + jnp.asarray([0.0, 0.5]))
          - _bilinear(prev_img, base - jnp.asarray([0.0, 0.5])))
    Gxx = jnp.sum(gx * gx)
    Gxy = jnp.sum(gx * gy)
    Gyy = jnp.sum(gy * gy)
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > cfg.min_det

    inv = jnp.where(ok, 1.0 / jnp.maximum(det, cfg.min_det), 0.0)

    def body(_, p):
        I = _bilinear(next_img, p[None, :] + offs)
        e = I - T
        bx = jnp.sum(e * gx)
        by = jnp.sum(e * gy)
        dp = -inv * jnp.stack([Gyy * bx - Gxy * by, Gxx * by - Gxy * bx])
        return p + dp

    p = jax.lax.fori_loop(0, cfg.iterations, body, pt_next)
    err = jnp.mean(jnp.abs(_bilinear(next_img, p[None, :] + offs) - T))
    return p, ok, err


@partial(jax.jit, static_argnums=(4,))
def track(prev_pyr: Tuple[jnp.ndarray, ...], next_pyr: Tuple[jnp.ndarray, ...],
          pts: jnp.ndarray, valid: jnp.ndarray, cfg: LKConfig = LKConfig()):
    """Track pts [N,2] from prev to next. Returns (new_pts [N,2], ok [N]).

    Coarse-to-fine over the pyramids (finest first in the tuples).
    """
    levels = len(prev_pyr)
    scale = 2.0 ** (levels - 1)
    guess = pts / scale
    ok_all = valid
    err = jnp.zeros(pts.shape[0], jnp.float32)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        p_prev = pts / s
        out = jax.vmap(lambda pp, pn: _track_level(
            prev_pyr[lvl], next_pyr[lvl], pp, pn, cfg))(p_prev, guess)
        new_p, ok_lvl, err = out
        ok_all = ok_all & ok_lvl
        guess = jnp.where(ok_all[:, None], new_p, p_prev)
        if lvl > 0:
            guess = guess * 2.0
    H, W = prev_pyr[0].shape
    inb = ((guess[:, 0] >= 1) & (guess[:, 0] < W - 1)
           & (guess[:, 1] >= 1) & (guess[:, 1] < H - 1))
    motion_ok = jnp.linalg.norm(guess - pts, axis=1) < cfg.max_motion
    ok = ok_all & inb & (err < cfg.max_error) & motion_ok
    return guess, ok
