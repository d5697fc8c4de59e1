"""LOAM feature extraction as a batched XLA kernel.

JAX replacement for libbeam's ``LoamFeatureExtractor`` (used by the
reference at bs_models/src/lidar_odometry.cpp:362-386 via ScanPose, and
bs_models/src/lib/lidar/lidar_path_init.cpp): ring-wise curvature over the
azimuth-sorted grid, per-sector selection of sharp edge points and flat
surface points with a strong/weak split (LoamPointCloud's
edges/surfaces × strong/weak sets).

Everything is regular, masked tensor math on the [R, W] ring grid: circular
neighborhoods via roll, per-(ring,sector) selection via top_k — no kd-trees,
no data-dependent shapes (SURVEY.md §7 'Irregular neighbor search').

Simplifications vs classic LOAM (documented, compensated):
  * no greedy non-max suppression around picked points; instead weak sets are
    stride-subsampled, which serves the same spatial-spread purpose in a
    shape-static way.
  * occlusion/parallel-beam rejection is a simple neighbor-range-ratio gate.
"""

from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp

from beam_slam_tpu.lidar.cloud import FeatureCloud, RingGrid


class LoamConfig(NamedTuple):
    """Defaults follow LOAM/A-LOAM conventions; tunable via the JSON config
    layer (mirrors beam_slam_launch config/ loam_config.json)."""

    n_sectors: int = 6
    neighbors: int = 5            # curvature half-window
    edge_strong_per_sector: int = 2
    edge_weak_per_sector: int = 20
    surf_strong_per_sector: int = 4
    surf_weak_stride: int = 4     # subsample of remaining flat points
    edge_curvature_min: float = 0.1
    surf_curvature_max: float = 0.1
    min_range: float = 0.3
    max_range: float = 120.0
    occlusion_ratio: float = 1.15  # neighbor range jump gate


def curvature(grid: RingGrid, cfg: LoamConfig):
    """Per-point LOAM curvature and pickability mask. [R, W] each."""
    xyz, valid = grid.xyz, grid.valid
    r = jnp.linalg.norm(xyz, axis=-1)
    valid = valid & (r > cfg.min_range) & (r < cfg.max_range)

    k = cfg.neighbors
    acc = -2.0 * k * xyz
    nb_valid = valid
    range_jump = jnp.zeros_like(r, bool)
    for off in range(1, k + 1):
        for s in (-off, off):
            xyz_s = jnp.roll(xyz, s, axis=1)
            acc = acc + xyz_s
            nb_valid = nb_valid & jnp.roll(valid, s, axis=1)
            if off == 1:
                r_s = jnp.roll(r, s, axis=1)
                ratio = jnp.maximum(r, r_s) / jnp.maximum(
                    jnp.minimum(r, r_s), 1e-3)
                range_jump = range_jump | (ratio > cfg.occlusion_ratio)

    c = jnp.sum(acc * acc, axis=-1) / jnp.maximum(r * r, 1e-6)
    pickable = nb_valid & ~range_jump
    return c, pickable


def _select_top(xyz_sec, score_sec, mask_sec, k, stride=1):
    """Per-(ring,sector) top-k by score over the sector axis.
    xyz_sec: [R, NS, Ws, 3]; score/mask: [R, NS, Ws]. Returns ([R*NS*k', 3],
    [R*NS*k']) with k' = ceil(k/stride)."""
    neg_inf = jnp.asarray(-jnp.inf, score_sec.dtype)
    s = jnp.where(mask_sec, score_sec, neg_inf)
    vals, idx = jax.lax.top_k(s, k)                       # [R, NS, k]
    if stride > 1:
        vals = vals[..., ::stride]
        idx = idx[..., ::stride]
    picked = jnp.take_along_axis(xyz_sec, idx[..., None], axis=2)
    ok = jnp.isfinite(vals)
    R, NS, kk = vals.shape
    return picked.reshape(R * NS * kk, 3), ok.reshape(R * NS * kk)


@partial(jax.jit, static_argnames=("cfg",))
def extract_features(grid: RingGrid, cfg: LoamConfig = LoamConfig()
                     ) -> FeatureCloud:
    """Full LOAM feature extraction. Output caps are static functions of
    (R, n_sectors, cfg) — jit-stable across scans."""
    R, W = grid.valid.shape
    NS = cfg.n_sectors
    assert W % NS == 0, "grid width must divide into sectors"
    Ws = W // NS

    c, pickable = curvature(grid, cfg)
    xyz_sec = grid.xyz.reshape(R, NS, Ws, 3)
    c_sec = c.reshape(R, NS, Ws)
    ok_sec = pickable.reshape(R, NS, Ws)

    edge_mask = ok_sec & (c_sec > cfg.edge_curvature_min)
    surf_mask = ok_sec & (c_sec < cfg.surf_curvature_max)

    e_s, e_s_ok = _select_top(xyz_sec, c_sec, edge_mask,
                              cfg.edge_strong_per_sector)
    e_w, e_w_ok = _select_top(xyz_sec, c_sec, edge_mask,
                              cfg.edge_weak_per_sector)
    s_s, s_s_ok = _select_top(xyz_sec, -c_sec, surf_mask,
                              cfg.surf_strong_per_sector)
    # weak surfaces: every flat point, stride-subsampled for spread
    s_w, s_w_ok = _select_top(xyz_sec, -c_sec, surf_mask, Ws,
                              stride=cfg.surf_weak_stride)
    return FeatureCloud(
        edge_strong=e_s, edge_strong_valid=e_s_ok,
        edge_weak=e_w, edge_weak_valid=e_w_ok,
        surf_strong=s_s, surf_strong_valid=s_s_ok,
        surf_weak=s_w, surf_weak_valid=s_w_ok)
