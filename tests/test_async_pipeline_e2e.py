"""Regression guard for a session accuracy fault: with
``async_solve=True`` the double-buffered optimizer tick must still fan out
every harvested graph update to the notify consumers (IMU-odometry rebasing,
lidar scan-pose / registration-map updates, VO map updates) — the reference's
``notify(transaction, graph_clone)`` contract
(bs_optimizers/src/fixed_lag_smoother.cpp:308).

The bug: the async tick harvested solves without firing the notify
fan-out, so every model dead-reckoned on its seed trajectory and the session
ATE degraded ~40x while every smoother-only async test stayed green. These
tests exercise async_solve (and the device-resident pipelined registration
path) through the FULL LocalMapper pipeline and assert ATE parity against
the synchronous path — at the level the bug lived.
"""

import numpy as np
import pytest

from beam_slam_tpu.pipeline.sim_session import run_synthetic_session

# Reduced envelope keeps each session ~1 min on the 4-core CPU CI backend
# (the full reference envelope runs in tools/run_session.py and the
# gated tests of test_envelope_e2e.py).
_ENV = dict(duration_s=8.0, lag_s=4.0, imu_hz=100.0, cam_hz=10.0,
            lidar_hz=5.0, max_states=48)


def _run(mode, **tweaks):
    def tweak(cfg):
        for k, v in tweaks.items():
            setattr(cfg, k, v)

    return run_synthetic_session(mode=mode, config_tweak=tweak, **_ENV)


@pytest.mark.slow
def test_async_solve_lio_ate_parity():
    """async_solve=True through LocalMapper + InertialOdometry +
    LidarOdometry: the notify fan-out must keep the models rebased, so the
    async ATE stays within a small factor of the sync run (not the 40x
    dead-reckoning blowup of the unnotified round-3 path)."""
    sync = _run("LIO", async_solve=False)
    asyn = _run("LIO", async_solve=True)
    assert sync.ate_rmse_m < 0.06, sync
    assert asyn.ate_rmse_m < max(2.5 * sync.ate_rmse_m, 0.06), (
        f"async ATE {asyn.ate_rmse_m:.4f} m vs sync {sync.ate_rmse_m:.4f} m "
        "— async notify fan-out regression (round-3 killer)")
    # the async path must actually solve asynchronously, not fall back
    assert asyn.n_solves > 10, asyn


@pytest.mark.slow
def test_async_solve_lvio_ate_parity():
    """Same guard through the visual consumers (VO landmark/map rebasing)."""
    sync = _run("LVIO", async_solve=False)
    asyn = _run("LVIO", async_solve=True)
    assert sync.ate_rmse_m < 0.12, sync
    assert asyn.ate_rmse_m < max(2.5 * sync.ate_rmse_m, 0.12), (
        f"async ATE {asyn.ate_rmse_m:.4f} m vs sync {sync.ate_rmse_m:.4f} m")
    assert asyn.n_solves > 10, asyn


@pytest.mark.slow
def test_async_plus_pipelined_registration_ate_parity():
    """The deployment fast path (async_solve + device-resident pipelined
    scan-to-map registration) — exactly what tools/run_session.py runs —
    must match the plain sync/host path."""
    sync = _run("LIO", async_solve=False, pipelined_registration=False)
    fast = _run("LIO", async_solve=True, pipelined_registration=True)
    assert fast.ate_rmse_m < max(2.5 * sync.ate_rmse_m, 0.06), (
        f"fast-path ATE {fast.ate_rmse_m:.4f} m vs sync "
        f"{sync.ate_rmse_m:.4f} m")
    assert fast.n_solves > 10, fast
