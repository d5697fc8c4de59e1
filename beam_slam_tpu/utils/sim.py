"""Analytic ground-truth trajectory simulator for tests and benchmarks.

The reference test suite drives IMU preintegration with a random C² SE(3)
B-spline (basalt::Se3Spline<5>, bs_models/tests/imu_preintegration_tests.cpp:89-122)
and samples exact angular velocity / body acceleration from it. Here we use a
smooth analytic trajectory instead, with the *exact* derivatives obtained by
JAX forward-mode autodiff — same role (C² ground truth with closed-form IMU
measurements), built from JAX primitives.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.core.factors import GRAVITY_WORLD


class TrajectorySample(NamedTuple):
    t: jnp.ndarray       # [N]
    q: jnp.ndarray       # [N, 4] world-from-body
    p: jnp.ndarray       # [N, 3]
    v: jnp.ndarray       # [N, 3]
    w_body: jnp.ndarray  # [N, 3] exact gyro (body frame)
    a_body: jnp.ndarray  # [N, 3] exact accelerometer (body frame, incl. gravity)


class AnalyticTrajectory:
    """Sinusoidal C-infinity SE(3) trajectory.

    p(t) = amp_p ⊙ [sin(ω₀t), cos(ω₁t), sin(ω₂t)] + v_drift·t
    θ(t) = amp_r ⊙ [sin(ν₀t), sin(ν₁t), sin(ν₂t)]   (rotation vector)
    q(t) = exp(θ(t))
    """

    def __init__(self, amp_p=(1.0, 1.0, 0.4), freq_p=(0.9, 0.7, 1.1),
                 v_drift=(0.25, 0.0, 0.05), amp_r=(0.4, 0.3, 0.5),
                 freq_r=(0.8, 1.2, 0.6), dtype=jnp.float32):
        self.amp_p = jnp.asarray(amp_p, dtype)
        self.freq_p = jnp.asarray(freq_p, dtype)
        self.v_drift = jnp.asarray(v_drift, dtype)
        self.amp_r = jnp.asarray(amp_r, dtype)
        self.freq_r = jnp.asarray(freq_r, dtype)
        self.dtype = dtype

    # All trajectory functions take a scalar time; batching is via vmap.
    def p(self, t):
        ph = self.freq_p * t
        osc = jnp.stack([jnp.sin(ph[0]), jnp.cos(ph[1]), jnp.sin(ph[2])])
        return self.amp_p * osc + self.v_drift * t

    def theta(self, t):
        return self.amp_r * jnp.sin(self.freq_r * t)

    def q(self, t):
        return lie.so3_exp_quat(self.theta(t))

    def sample(self, t: jnp.ndarray) -> TrajectorySample:
        """Sample states + exact IMU measurements at times t [N].

        Jitted at module level: eager re-tracing of the nested
        vmap(jacfwd(jacfwd)) cost ~360 ms per call and dominated session
        wall clock (round-3 CPU profile: 87 s of 965 s in re-tracing)."""
        t = jnp.asarray(t, self.dtype)
        q, p, v, w_body, a_body = _sample_jit(
            t, self.amp_p, self.freq_p, self.v_drift, self.amp_r,
            self.freq_r)
        return TrajectorySample(t=t, q=q, p=p, v=v, w_body=w_body,
                                a_body=a_body)


@jax.jit
def _sample_jit(t, amp_p, freq_p, v_drift, amp_r, freq_r):
    dtype = t.dtype

    def pos(ti):
        ph = freq_p * ti
        osc = jnp.stack([jnp.sin(ph[0]), jnp.cos(ph[1]), jnp.sin(ph[2])])
        return amp_p * osc + v_drift * ti

    def quat(ti):
        return lie.so3_exp_quat(amp_r * jnp.sin(freq_r * ti))

    def one(ti):
        p = pos(ti)
        v = jax.jacfwd(pos)(ti)
        acc_w = jax.jacfwd(jax.jacfwd(pos))(ti)
        q = quat(ti)
        qdot = jax.jacfwd(quat)(ti)
        # body angular velocity: w = 2 · vec(q⁻¹ ⊗ q̇)
        w_body = 2.0 * lie.quat_mul(lie.quat_conj(q), qdot)[1:4]
        # accelerometer measures R(q)ᵀ · (a_world - g)
        a_body = lie.quat_rotate(lie.quat_conj(q),
                                 acc_w - GRAVITY_WORLD.astype(dtype))
        return q, p, v, w_body, a_body

    return jax.vmap(one)(t)


def imu_measurements(traj: AnalyticTrajectory, t0: float, t1: float,
                     rate_hz: float, key=None, sig_w: float = 0.0,
                     sig_a: float = 0.0) -> TrajectorySample:
    """Regularly-sampled IMU stream over [t0, t1] with optional white noise
    (mirrors the reference tests' with/without-noise variants,
    imu_preintegration_tests.cpp:701/:830)."""
    n = int(round((t1 - t0) * rate_hz)) + 1
    t = t0 + jnp.arange(n, dtype=traj.dtype) / rate_hz
    s = traj.sample(t)
    if key is not None and (sig_w > 0 or sig_a > 0):
        kw, ka = jax.random.split(key)
        s = s._replace(
            w_body=s.w_body + sig_w * jax.random.normal(kw, s.w_body.shape,
                                                        traj.dtype),
            a_body=s.a_body + sig_a * jax.random.normal(ka, s.a_body.shape,
                                                        traj.dtype),
        )
    return s
