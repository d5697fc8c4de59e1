"""Synthetic full-pipeline session runner — drives the LocalMapper with
simulated IMU / camera / lidar streams at configurable rates and evaluates
ATE against the analytic ground truth.

This is the self-generated accuracy baseline BASELINE.md calls for (the
reference publishes no numbers): run LIO / VIO / LVIO at the reference
envelope (lvio.yaml:2-3 — 10 s lag, 200 Hz IMU, 20 Hz camera, 10 Hz VLP-16)
and record ATE RMSE. Used by ``tools/run_ate_benchmark.py`` (writes
docs/ATE.md) and the envelope e2e tests.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar.cloud import synthetic_structured_scene
from beam_slam_tpu.models.slam_initialization import InitParams
from beam_slam_tpu.models.visual_feature_tracker import CameraMeasurement
from beam_slam_tpu.pipeline.config import CalibrationConfig, LocalMapperConfig
from beam_slam_tpu.pipeline.local_mapper import LocalMapper
from beam_slam_tpu.utils import sim
from beam_slam_tpu.utils.evaluation import ate_rmse
from beam_slam_tpu.vision.camera import PinholeRadtan

CAM = PinholeRadtan(400.0, 400.0, 320.0, 240.0)
# host numpy math (lie is numpy-dual): a module-level jnp op would dispatch
# an eager device computation AT IMPORT TIME
Q_BC = np.asarray(lie.matrix_to_quat(np.asarray(
    [[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)))
P_BC = np.asarray([0.1, 0.0, 0.05], np.float32)
Q_BL = np.array([1, 0, 0, 0], np.float32)
P_BL = np.asarray([0.05, 0.0, -0.08], np.float32)


@dataclasses.dataclass
class SessionResult:
    mode: str
    duration_s: float
    ate_rmse_m: float
    n_poses: int
    n_solves: int
    mean_solve_ms: float
    wall_s: float
    counters: Dict[str, int]


def generate_session_events(mode: str = "LVIO", duration_s: float = 20.0,
                            imu_hz: float = 200.0, cam_hz: float = 20.0,
                            lidar_hz: float = 10.0, seed: int = 11,
                            scene=None):
    """Pre-generate the full sensor stream for a session (same trajectory,
    scene, landmark corridor and noise draws as ``run_synthetic_session``)
    so a *driver* can feed a mapper and time ONLY the pipeline — the basis
    of the on-device session benchmark (tools/run_session.py), where
    simulator cost must not pollute the frames/s measurement.

    Returns (traj, events, n_frames) with events a time-sorted list of
    ("imu", t, w, a) / ("scan", t, grid) / ("cam", CameraMeasurement) /
    ("pose", t, q, p) / ("tick", t) tuples mirroring the online loop's
    feed order.
    """
    rng = np.random.default_rng(seed)
    v_drift = (0.35, 0.05, 0.0)
    traj = sim.AnalyticTrajectory(amp_p=(0.6, 0.5, 0.2), v_drift=v_drift,
                                  amp_r=(0.1, 0.1, 0.15))
    scene = scene if scene is not None else synthetic_structured_scene(
        n_rings=16, width=504)
    use_cam = mode in ("VIO", "LVIO")
    use_lidar = mode in ("LIO", "LVIO")
    corridor = 7.0 + v_drift[0] * duration_s
    n_lm = max(120, int(round(120 * corridor / 7.0)))
    lx = rng.uniform(4.0, 4.0 + corridor, n_lm)
    ly = (v_drift[1] / max(v_drift[0], 1e-9)) * lx \
        + rng.uniform(-4.5, 4.5, n_lm)
    lms = np.stack([lx, ly, rng.uniform(-2.2, 2.2, n_lm)],
                   axis=1).astype(np.float32)

    def camera_obs_all(gq, gp):
        """All frames' landmark observations in ONE batched projection
        (eager per-frame jnp calls cost a device round trip each).
        Returns {frame k: (ids, pix)}."""
        q_wc = np.asarray(lie.quat_mul(gq, Q_BC[None, :]))       # [F, 4]
        p_wc = gp + np.asarray(lie.quat_rotate(gq, P_BC[None, :]))
        X_c = np.asarray(lie.quat_rotate(
            lie.quat_conj(q_wc)[:, None, :], lms[None, :, :] - p_wc[:, None, :]))
        uv, valid = jax.device_get(CAM.project(jnp.asarray(X_c)))
        valid = valid & (X_c[..., 2] < 12.0)
        out = {}
        for f in range(len(gq)):
            ids = np.nonzero(valid[f])[0].astype(np.int64)
            if ids.size > 150:
                ids = ids[np.argsort(X_c[f, ids, 2])[:150]]
                ids = np.sort(ids)
            pix = uv[f, ids] + rng.standard_normal(
                (ids.size, 2)).astype(np.float32) * 0.3
            out[f] = (ids, pix.astype(np.float32))
        return out

    tick_hz = cam_hz if use_cam else lidar_hz
    dt_frame = 1.0 / tick_hz
    n_frames = int(duration_s * tick_hz)
    n_imu = max(int(imu_hz / tick_hz), 1)

    # ---- ONE batched trajectory sample for the whole stream instead of 2
    # blocking device pulls per frame.
    frame_t = (np.arange(1, n_frames + 1) * dt_frame)
    steps = (np.arange(n_imu) + 0.5) / n_imu * dt_frame
    imu_t = (frame_t - dt_frame)[:, None] + steps[None, :]      # [F, n_imu]
    s_all = traj.sample(jnp.asarray(imu_t.reshape(-1), jnp.float32))
    g_all = traj.sample(jnp.asarray(frame_t, jnp.float32))
    w_all, a_all, gq, gp = jax.device_get(
        (s_all.w_body, s_all.a_body, g_all.q, g_all.p))
    w_all = w_all.reshape(n_frames, n_imu, 3)
    a_all = a_all.reshape(n_frames, n_imu, 3)

    # ---- all scans in one batched transform (host numpy via numpy-dual lie)
    scan_every = 1 if not use_cam else max(int(tick_hz / lidar_hz), 1)
    scan_ks = [k for k in range(1, n_frames + 1)
               if use_lidar and k % scan_every == 0]
    scans = {}
    if scan_ks:
        ks = np.asarray(scan_ks) - 1
        q_wl = np.asarray(lie.quat_mul(gq[ks], Q_BL[None, :]))
        p_wl = gp[ks] + np.asarray(lie.quat_rotate(gq[ks], P_BL[None, :]))
        sxyz = np.asarray(scene.xyz)
        svalid = np.asarray(scene.valid)
        for i, k in enumerate(scan_ks):
            xyz = np.asarray(lie.quat_rotate(
                lie.quat_conj(q_wl[i])[None, None], sxyz - p_wl[i]))
            xyz = np.where(svalid[..., None], xyz, 0.0).astype(np.float32)
            scans[k] = scene._replace(xyz=jnp.asarray(xyz))

    cam_all = camera_obs_all(gq, gp) if use_cam else None

    events = []
    for k in range(1, n_frames + 1):
        t = float(frame_t[k - 1])
        for i in range(n_imu):
            events.append(("imu", float(imu_t[k - 1, i]),
                           w_all[k - 1, i], a_all[k - 1, i]))
        q_gt, p_gt = gq[k - 1], gp[k - 1]
        if k in scans:
            events.append(("scan", round(t, 6), scans[k]))
        if not use_lidar:
            qn = np.asarray(lie.quat_mul(q_gt, np.asarray(lie.so3_exp_quat(
                rng.standard_normal(3).astype(np.float32) * 0.002))))
            events.append(("pose", round(t, 6), qn,
                           p_gt + rng.standard_normal(3).astype(np.float32)
                           * 0.005))
        if use_cam:
            ids, pix = cam_all[k - 1]
            events.append(("cam", CameraMeasurement(round(t, 6), ids, pix,
                                                    pix)))
        events.append(("tick", t))
    return traj, events, n_frames


def run_synthetic_session(mode: str = "LVIO", duration_s: float = 20.0,
                          lag_s: float = 10.0, imu_hz: float = 200.0,
                          cam_hz: float = 20.0, lidar_hz: float = 10.0,
                          max_states: int = 64, max_iterations: int = 8,
                          seed: int = 11,
                          scene=None, on_tick=None,
                          true_landmarks_out=None,
                          config_tweak=None) -> SessionResult:
    """One full pipeline session at the given envelope. ``mode`` selects
    which sensors feed the local mapper (LIO: no camera; VIO: no lidar after
    init — init still uses FRAMEINIT/LIDAR as configured; LVIO: all).

    ``on_tick(mapper, t, traj)`` runs after every frame tick — the
    instrumentation hook for accuracy diagnosis (tools/diagnose_lvio.py).
    ``true_landmarks_out`` (a list) receives the ground-truth landmark
    array so callers can score the estimated map."""
    rng = np.random.default_rng(seed)
    v_drift = (0.35, 0.05, 0.0)
    traj = sim.AnalyticTrajectory(amp_p=(0.6, 0.5, 0.2),
                                  v_drift=v_drift,
                                  amp_r=(0.1, 0.1, 0.15))
    scene = scene if scene is not None else synthetic_structured_scene(
        n_rings=16, width=504)
    use_cam = mode in ("VIO", "LVIO")
    # VIO: no lidar at all — SLAM init falls back to FRAMEINIT, driven by an
    # external odometry pose stream (fed below), matching the reference's
    # frame-initializer config for camera-only pipelines
    use_lidar = mode in ("LIO", "LVIO")
    # Landmarks populate the whole drift corridor (the trajectory advances
    # v_drift[0]·duration metres in x): constant density along the path so
    # the camera always has fresh features ahead of it, like a real scene.
    corridor = 7.0 + v_drift[0] * duration_s
    n_lm = max(120, int(round(120 * corridor / 7.0)))
    lx = rng.uniform(4.0, 4.0 + corridor, n_lm)
    # centre the lateral band on the drifted path (y advances vy/vx per x)
    ly = (v_drift[1] / max(v_drift[0], 1e-9)) * lx \
        + rng.uniform(-4.5, 4.5, n_lm)
    lms = np.stack([lx, ly, rng.uniform(-2.2, 2.2, n_lm)],
                   axis=1).astype(np.float32)
    if true_landmarks_out is not None:
        true_landmarks_out.append(lms)

    cfg = LocalMapperConfig(
        mode=mode, lag_duration=lag_s, max_states=max_states,
        max_landmarks=256, max_reprojection_factors=4096,
        max_iterations=max_iterations,
        init=InitParams(mode="LIDAR", min_trajectory_length_m=1.5,
                        min_observability=0.1),
        calibration=CalibrationConfig(
            camera=CAM if use_cam else None,
            q_baselink_cam=Q_BC if use_cam else None,
            p_baselink_cam=P_BC if use_cam else None,
            q_baselink_lidar=Q_BL, p_baselink_lidar=P_BL,
            imu_hz=imu_hz, camera_hz=cam_hz, lidar_hz=lidar_hz))
    if config_tweak is not None:
        config_tweak(cfg)  # controlled-experiment hook (diagnose_lvio.py)
    mapper = LocalMapper(cfg)

    def scan_from_pose(q_wb, p_wb):
        q_wl = lie.quat_mul(jnp.asarray(q_wb), jnp.asarray(Q_BL))
        p_wl = jnp.asarray(p_wb) + lie.quat_rotate(jnp.asarray(q_wb),
                                                   jnp.asarray(P_BL))
        xyz = lie.quat_rotate(lie.quat_conj(q_wl)[None, None],
                              scene.xyz - p_wl)
        return scene._replace(
            xyz=jnp.where(scene.valid[..., None], xyz, 0.0))

    def camera_obs(q_wb, p_wb):
        q_wc = lie.quat_mul(jnp.asarray(q_wb), jnp.asarray(Q_BC))
        p_wc = jnp.asarray(p_wb) + lie.quat_rotate(jnp.asarray(q_wb),
                                                   jnp.asarray(P_BC))
        X_c = lie.quat_rotate(lie.quat_conj(q_wc)[None],
                              jnp.asarray(lms) - p_wc)
        X_c = np.asarray(X_c)
        uv, valid = CAM.project(X_c)
        uv = np.asarray(uv)
        # range-gate + cap like a real tracker: keep the nearest 150 within
        # 12 m so the per-frame feature count stays bounded regardless of
        # how many corridor landmarks fall inside the frustum
        valid = np.asarray(valid) & (X_c[:, 2] < 12.0)
        ids = np.nonzero(valid)[0].astype(np.int64)
        if ids.size > 150:
            ids = ids[np.argsort(X_c[ids, 2])[:150]]
            ids = np.sort(ids)
        pix = uv[ids] + rng.standard_normal(
            (ids.size, 2)).astype(np.float32) * 0.3
        return ids, pix.astype(np.float32)

    # drive on the camera clock (or lidar clock for LIO)
    tick_hz = cam_hz if use_cam else lidar_hz
    dt_frame = 1.0 / tick_hz
    n_frames = int(duration_s * tick_hz)
    est: Dict[float, np.ndarray] = {}
    t_prev = 0.0
    t_wall0 = time.perf_counter()
    for k in range(1, n_frames + 1):
        t = k * dt_frame
        n_imu = max(int(imu_hz / tick_hz), 1)
        tm = t_prev + (np.arange(n_imu) + 0.5) * (t - t_prev) / n_imu
        s = traj.sample(jnp.asarray(tm, jnp.float32))
        for i in range(n_imu):
            mapper.on_imu(float(tm[i]), np.asarray(s.w_body[i]),
                          np.asarray(s.a_body[i]))
        gk = traj.sample(jnp.asarray([t], jnp.float32))
        q_gt, p_gt = gk.q[0], gk.p[0]
        if use_lidar and (not use_cam
                          or k % max(int(tick_hz / lidar_hz), 1) == 0):
            mapper.on_scan(round(t, 6), scan_from_pose(q_gt, p_gt))
        if not use_lidar:
            # external odometry for FRAMEINIT (noisy GT poses)
            qn = lie.quat_mul(jnp.asarray(q_gt), lie.so3_exp_quat(
                jnp.asarray(rng.standard_normal(3).astype(np.float32)
                            * 0.002)))
            mapper.on_pose(round(t, 6), np.asarray(qn),
                           np.asarray(p_gt)
                           + rng.standard_normal(3).astype(np.float32)
                           * 0.005)
        if use_cam and mapper.initialized:
            ids, pix = camera_obs(q_gt, p_gt)
            mapper.on_camera_measurement(
                CameraMeasurement(round(t, 6), ids, pix, pix))
        mapper.tick()
        if mapper.initialized:
            stamps = mapper.smoother.current_stamps()
            if stamps:
                st = mapper.smoother.get_state(stamps[-1])
                est[stamps[-1]] = st["p"].copy()
        if on_tick is not None:
            on_tick(mapper, t, traj)
        t_prev = t
    wall = time.perf_counter() - t_wall0

    if not mapper.initialized or len(est) < 5:
        raise RuntimeError(
            f"{mode} session failed to initialize/track ({len(est)} poses)")
    stamps_e = sorted(est.keys())
    est_p = np.stack([est[t] for t in stamps_e])
    gt_at = traj.sample(jnp.asarray(stamps_e, jnp.float32))
    rmse = float(ate_rmse(est_p, np.asarray(gt_at.p), align="se3"))
    sm = mapper.smoother
    return SessionResult(
        mode=mode, duration_s=duration_s, ate_rmse_m=rmse,
        n_poses=len(stamps_e), n_solves=sm.solve_count,
        mean_solve_ms=1e3 * sm.total_solve_time / max(sm.solve_count, 1),
        wall_s=wall, counters=dict(sm.counters))
