"""End-to-end sessions at the REFERENCE envelope:
200 Hz IMU, 20 Hz camera, 10 Hz lidar, per-config lags from the reference
YAMLs (lio.yaml:3 lag 4 s, lvio.yaml:3 lag 10 s), max_states 64. Asserts
the ATE bound that docs/ATE.md records.

Opt-in (BEAM_SLAM_RUN_ENVELOPE=1): a 64-state LVIO solve is ~3.7 s per tick
on the 4-core CPU CI backend — a full session is 10-20 min per mode, which
would dwarf the rest of the suite. The same sessions at reduced envelope
run unconditionally in test_lvio_e2e.py / test_vio_e2e.py; the full-envelope
numbers are regenerated by ``python tools/run_ate_benchmark.py`` (docs/
ATE.md) and by this file under the env flag."""

import os

import numpy as np
import pytest

from beam_slam_tpu.pipeline.sim_session import run_synthetic_session

_gated = pytest.mark.skipif(
    not os.environ.get("BEAM_SLAM_RUN_ENVELOPE"),
    reason="full-envelope sessions are opt-in: BEAM_SLAM_RUN_ENVELOPE=1")


def test_lio_envelope_smoke():
    """ALWAYS-ON short session at the exact reference envelope rates
    (200 Hz IMU + 10 Hz lidar, lio.yaml lag 4 s) — round-2 verdict: the
    envelope was never exercised in CI because every test here was gated.
    6 s keeps it ~2-3 min on the CPU backend."""
    r = run_synthetic_session(mode="LIO", duration_s=6.0, lag_s=4.0,
                              imu_hz=200.0, lidar_hz=10.0, max_states=64)
    assert r.ate_rmse_m < 0.05, r
    assert r.n_solves > 20


@_gated
@pytest.mark.slow
def test_lvio_envelope_session():
    r = run_synthetic_session(mode="LVIO", duration_s=12.0, lag_s=10.0,
                              imu_hz=200.0, cam_hz=20.0, lidar_hz=10.0,
                              max_states=64)
    assert r.ate_rmse_m < 0.05, r
    assert r.n_solves > 20
    assert np.isfinite(r.mean_solve_ms)


@_gated
@pytest.mark.slow
def test_lio_envelope_session():
    r = run_synthetic_session(mode="LIO", duration_s=12.0, lag_s=4.0,
                              imu_hz=200.0, lidar_hz=10.0, max_states=64)
    assert r.ate_rmse_m < 0.05, r
    assert r.n_solves > 40


@_gated
@pytest.mark.slow
def test_vio_envelope_session():
    r = run_synthetic_session(mode="VIO", duration_s=12.0, lag_s=7.0,
                              imu_hz=200.0, cam_hz=20.0, max_states=64)
    assert r.ate_rmse_m < 0.05, r
