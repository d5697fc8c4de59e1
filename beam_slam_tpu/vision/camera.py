"""Pinhole camera model with radial-tangential distortion.

JAX replacement for the used subset of libbeam's
``beam_calibration::CameraModel`` (reference call sites:
bs_models/src/visual_odometry.cpp:426-430 — ``UndistortPixel``,
``BackProject``, ``ProjectPoint``). All ops are batched over leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class PinholeRadtan(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 640
    height: int = 480

    @property
    def intr4(self):
        return jnp.asarray([self.fx, self.fy, self.cx, self.cy], jnp.float32)

    def _distort_normalized(self, xn):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = (x * radial + 2 * self.p1 * x * y
              + self.p2 * (r2 + 2 * x * x))
        yd = (y * radial + self.p1 * (r2 + 2 * y * y)
              + 2 * self.p2 * x * y)
        return jnp.stack([xd, yd], axis=-1)

    def project(self, X_cam: jnp.ndarray):
        """Camera-frame 3D point(s) → distorted pixel(s). Returns (uv, valid)
        where valid = point in front of the camera and inside the image."""
        z = X_cam[..., 2]
        z_safe = jnp.maximum(z, 1e-6)
        xn = X_cam[..., :2] / z_safe[..., None]
        xd = self._distort_normalized(xn)
        uv = jnp.stack([self.fx * xd[..., 0] + self.cx,
                        self.fy * xd[..., 1] + self.cy], axis=-1)
        valid = ((z > 1e-3) & (uv[..., 0] >= 0) & (uv[..., 0] < self.width)
                 & (uv[..., 1] >= 0) & (uv[..., 1] < self.height))
        return uv, valid

    def undistort_pixel(self, uv: jnp.ndarray, iters: int = 5):
        """Distorted pixel → undistorted pixel (ideal pinhole). Fixed-point
        iteration on normalized coordinates (beam_calibration UndistortPixel
        equivalent; fixed iteration count for jit)."""
        xn_d = jnp.stack([(uv[..., 0] - self.cx) / self.fx,
                          (uv[..., 1] - self.cy) / self.fy], axis=-1)
        xn = xn_d
        for _ in range(iters):
            delta = self._distort_normalized(xn) - xn
            xn = xn_d - delta
        return jnp.stack([self.fx * xn[..., 0] + self.cx,
                          self.fy * xn[..., 1] + self.cy], axis=-1)

    def back_project(self, uv: jnp.ndarray, undistorted: bool = True):
        """Pixel → unit bearing ray in the camera frame (``BackProject``)."""
        if not undistorted:
            uv = self.undistort_pixel(uv)
        xn = jnp.stack([(uv[..., 0] - self.cx) / self.fx,
                        (uv[..., 1] - self.cy) / self.fy,
                        jnp.ones_like(uv[..., 0])], axis=-1)
        return xn / jnp.linalg.norm(xn, axis=-1, keepdims=True)
