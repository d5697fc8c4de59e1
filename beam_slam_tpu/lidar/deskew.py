"""Per-point scan deskewing (motion compensation).

JAX replacement for the reference's LidarScanDeskewer plugin
(bs_models/src/lidar_scan_deskewer.cpp:13-62): every point is re-expressed in
the scan-start frame using the pose interpolated at its own timestamp (the
reference queries a FrameInitializer per point; here the whole grid is
compensated in one vectorized kernel given the scan-start and scan-end poses
from inertial odometry)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar.cloud import RingGrid


def slerp(q0: jnp.ndarray, q1: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Quaternion slerp, batched over s (s broadcastable to [...]).
    q0, q1: [4]; s: [...] → [..., 4]. Shortest arc, Taylor-safe."""
    dot = jnp.sum(q0 * q1)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    small = sin_theta < 1e-5
    w0 = jnp.where(small, 1.0 - s, jnp.sin((1.0 - s) * theta)
                   / jnp.where(small, 1.0, sin_theta))
    w1 = jnp.where(small, s, jnp.sin(s * theta)
                   / jnp.where(small, 1.0, sin_theta))
    q = w0[..., None] * q0 + w1[..., None] * q1
    return lie.quat_normalize(q)


@jax.jit
def deskew(grid: RingGrid, q0, p0, q1, p1, t0: float, t1: float) -> RingGrid:
    """Motion-compensate ``grid`` into the scan-start frame.

    (q0,p0) / (q1,p1): world-from-lidar poses at times t0 (scan start) and t1
    (scan end); grid.time holds per-point offsets from scan start.
    Result: points as they would appear if all were captured at t0.
    """
    s = jnp.clip((grid.time - 0.0) / jnp.maximum(t1 - t0, 1e-6), 0.0, 1.0)
    q_t = slerp(q0, q1, s)                         # [R, W, 4]
    p_t = p0 + s[..., None] * (p1 - p0)            # [R, W, 3]
    # world point, then back into the scan-start frame
    pw = lie.quat_rotate(q_t, grid.xyz) + p_t
    q0_inv = lie.quat_conj(q0)
    xyz0 = lie.quat_rotate(q0_inv[None, None], pw - p0[None, None])
    xyz0 = jnp.where(grid.valid[..., None], xyz0, 0.0)
    return grid._replace(xyz=xyz0)
