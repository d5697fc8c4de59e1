#!/usr/bin/env python
"""Full-pipeline session on the default JAX backend: frames/s, RTF and ATE.

Pre-generates the synthetic envelope sensor stream (200 Hz IMU, 20 Hz
camera, 10 Hz VLP-16 — the rates of the reference's
beam_slam_launch/config/calibration_params.yaml:11-13),
feeds it through the LocalMapper (plain or threaded runtime) as fast as
the pipeline can drain it, and reports:

  * frames/s     — sensor *frames* (camera frames for V*/LVIO, scans for
                   LIO) processed per wall second, steady state (second
                   half of the session, past compile warmup);
  * RTF          — real-time factor = session seconds / wall seconds;
  * ATE RMSE     — SE(3)-aligned against the analytic ground truth (the
                   run must stay ACCURATE while fast).

The reference envelope sustains 1/0.07 s ≈ 14.3 optimizer cycles/s on an
8-thread x86 CPU (lvio.yaml:2).

Usage:
  python tools/run_session.py [--mode LIO] [--duration 30]
      [--runtime threaded|sync] [--out sessions.md]
"""

import argparse
import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def run_session(mode: str, duration_s: float, runtime: str,
                lag_s: float, max_states: int, pipelined: bool = True,
                feed: str = None, skip_ticks: int = 0,
                max_iterations: int = 8):
    from beam_slam_tpu.models.slam_initialization import InitParams
    from beam_slam_tpu.pipeline.config import (CalibrationConfig,
                                               LocalMapperConfig)
    from beam_slam_tpu.pipeline.local_mapper import LocalMapper
    from beam_slam_tpu.pipeline.sim_session import (
        CAM, P_BC, P_BL, Q_BC, Q_BL, generate_session_events)
    from beam_slam_tpu.pipeline.threaded import ThreadedLocalMapper
    from beam_slam_tpu.utils.evaluation import ate_rmse

    use_cam = mode in ("VIO", "LVIO")
    print(f"generating {duration_s:.0f}s {mode} event stream...", flush=True)
    traj, events, n_frames = generate_session_events(
        mode=mode, duration_s=duration_s)

    cfg = LocalMapperConfig(
        mode=mode, lag_duration=lag_s, max_states=max_states,
        max_landmarks=256, max_reprojection_factors=4096,
        max_iterations=max_iterations,
        # device-resident registration map + 1-deep async pipeline: zero
        # blocking host<->device round trips per scan
        pipelined_registration=pipelined,
        # double-buffered solve: ticks dispatch without blocking (the
        # reference's optimizer-thread overlap)
        async_solve=(runtime != "sync_blocking"),
        # >0: let N ticks pass while a solve is in flight before the
        # blocking harvest — trades solve cadence for per-tick headroom
        async_max_skipped_ticks=skip_ticks,
        init=InitParams(mode="LIDAR" if mode != "VIO" else "FRAMEINIT",
                        min_trajectory_length_m=1.5, min_observability=0.1),
        calibration=CalibrationConfig(
            camera=CAM if use_cam else None,
            q_baselink_cam=Q_BC if use_cam else None,
            p_baselink_cam=P_BC if use_cam else None,
            q_baselink_lidar=Q_BL, p_baselink_lidar=P_BL))

    threaded = runtime == "threaded"
    # Feed semantics: 'drain' pushes the pre-generated stream as fast as the
    # pipeline consumes it (meaningful for the sync runtime, where the
    # producer IS the pipeline); 'realtime' paces events by their stamps —
    # the reference's live operating regime, and the only honest feed for
    # the threaded runtime (its producers are non-blocking with
    # drop-oldest queues, so a drain feed just floods the queues at t=0 and
    # measures nothing but the drop counter).
    if feed is None:
        feed = "realtime" if threaded else "drain"

    # WARMUP: run a short prefix through a throwaway SYNC mapper so every
    # jit executable (registration, preintegration buckets, the solve)
    # compiles before the timed run and compilation stays out of the
    # measurement. Sync mapper: same executables, deterministic drain.
    warm_t = min(4.0, duration_s / 2)
    print(f"warmup ({warm_t:.0f}s prefix)...", flush=True)
    warm = LocalMapper(cfg)
    for ev in events:
        kind = ev[0]
        t_ev = ev[1].stamp if kind == "cam" else ev[1]
        if t_ev > warm_t:
            break
        if kind == "imu":
            warm.on_imu(ev[1], ev[2], ev[3])
        elif kind == "scan":
            warm.on_scan(ev[1], ev[2])
        elif kind == "cam":
            warm.on_camera_measurement(ev[1])
        elif kind == "pose":
            warm.on_pose(ev[1], ev[2], ev[3])
        else:
            warm.tick()
    warm.smoother.flush()

    mapper = (ThreadedLocalMapper(cfg).start() if threaded
              else LocalMapper(cfg))

    est = {}

    def record(sm):
        """Graph-update hook: record every in-window stamp's current
        estimate (Path3DPublisher semantics). Each stamp's entry is
        overwritten until it leaves the window, so the scored value is the
        SMOOTHED estimate — what the reference publishes — not the seed of
        the newest state (which in async mode is one harvest stale)."""
        for s in sm.current_stamps():
            st = sm.try_get_state(s)  # optimizer may marginalize mid-walk
            if st is not None:
                est[s] = st["p"].copy()

    mapper.smoother.register_on_update(record)

    t_half_wall = None
    frames_seen = 0
    half_frames = 0
    print(f"feeding {len(events)} events ({n_frames} frames, "
          f"{feed} feed)...", flush=True)
    t0 = time.perf_counter()
    for ev in events:
        kind = ev[0]
        t_ev = ev[1].stamp if kind == "cam" else ev[1]
        if feed == "realtime":
            lead = t_ev - (time.perf_counter() - t0)
            if lead > 0:
                time.sleep(lead)
        if kind == "imu":
            mapper.on_imu(ev[1], ev[2], ev[3])
        elif kind == "scan":
            mapper.on_scan(ev[1], ev[2])
        elif kind == "cam":
            mapper.on_camera_measurement(ev[1])
        elif kind == "pose":
            mapper.on_pose(ev[1], ev[2], ev[3])
        else:  # tick
            frames_seen += 1
            if not threaded:
                mapper.tick()
            if ev[1] >= duration_s / 2 and t_half_wall is None:
                t_half_wall = time.perf_counter()
                half_frames = frames_seen
    if threaded:
        mapper.stop()
    else:
        mapper.flush()
    record(mapper.smoother)
    wall = time.perf_counter() - t0

    if not mapper.initialized or len(est) < 5:
        raise RuntimeError(f"{mode} session failed ({len(est)} poses)")
    stamps = sorted(est.keys())
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    est_p = np.stack([est[t] for t in stamps])
    gt_p = np.asarray(gt.p)
    ate = float(ate_rmse(est_p, gt_p, align="se3"))
    # per-10s-bucket UNALIGNED error (drift localization: where does a bad
    # run start diverging?)
    raw_err = np.linalg.norm(est_p - gt_p, axis=1)
    buckets = {}
    for t, e in zip(stamps, raw_err):
        buckets.setdefault(int(t // 10) * 10, []).append(e)
    err_by_10s = {f"{k}s": round(float(np.mean(v)), 4)
                  for k, v in sorted(buckets.items())}

    steady_wall = wall - (t_half_wall - t0)
    steady_frames = n_frames - half_frames
    sm = mapper.smoother
    return {
        "mode": mode,
        "runtime": runtime + ("/rt" if feed == "realtime" else ""),
        "backend": jax.default_backend(),
        "duration_s": duration_s,
        "n_frames": n_frames,
        "wall_s": round(wall, 2),
        "rtf": round(duration_s / wall, 3),
        "frames_per_s": round(n_frames / wall, 2),
        "steady_frames_per_s": round(steady_frames / max(steady_wall, 1e-9),
                                     2),
        "steady_rtf": round((duration_s / 2)
                            / max(steady_wall, 1e-9), 3),
        "ate_rmse_cm": round(100 * ate, 3),
        "raw_err_by_10s_m": err_by_10s,
        "n_solves": sm.solve_count,
        "dropped": dict(getattr(mapper, "dropped", {})),
        "counters": dict(sm.counters),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="LIO")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--runtime", default="threaded",
                    choices=["threaded", "sync", "sync_blocking"])
    ap.add_argument("--lag", type=float, default=4.0)
    ap.add_argument("--max-states", type=int, default=64)
    ap.add_argument("--pipelined", type=int, default=1,
                    help="device-resident pipelined scan registration")
    ap.add_argument("--feed", default=None, choices=["drain", "realtime"],
                    help="event pacing (default: drain for sync runtimes, "
                    "realtime for threaded)")
    ap.add_argument("--skip-ticks", type=int, default=0,
                    help="async_max_skipped_ticks (solve every N+1th tick)")
    ap.add_argument("--out", default=None,
                    help="append a markdown row to this file")
    args = ap.parse_args()

    from beam_slam_tpu.utils import compile_cache
    compile_cache.enable()
    r = run_session(args.mode, args.duration, args.runtime, args.lag,
                    args.max_states, pipelined=bool(args.pipelined),
                    feed=args.feed, skip_ticks=args.skip_ticks)
    print(json.dumps(r, indent=2))
    if args.out:
        exists = os.path.exists(args.out)
        with open(args.out, "a") as f:
            if not exists:
                f.write(
                    "# Full-pipeline sessions\n\n"
                    "Generated by tools/run_session.py — the stream is "
                    "pre-generated, so wall\ntime is pipeline-only. "
                    "'steady' = second half of the session (past compile\n"
                    "warmup). Reference envelope: 14.3 optimizer cycles/s "
                    "on 8-thread x86\n(lvio.yaml:2).\n\n"
                    "| date | mode | runtime | backend | dur | frames/s "
                    "(steady) | RTF (steady) | ATE | solves |\n"
                    "|---|---|---|---|---|---|---|---|---|\n")
            f.write(
                f"| {datetime.date.today().isoformat()} | {r['mode']} | "
                f"{r['runtime']} | {r['backend']} | {r['duration_s']:.0f} s "
                f"| {r['frames_per_s']} ({r['steady_frames_per_s']}) | "
                f"{r['rtf']} ({r['steady_rtf']}) | {r['ate_rmse_cm']:.2f} cm "
                f"| {r['n_solves']} |\n")
        print(f"appended to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
