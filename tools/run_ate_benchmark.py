#!/usr/bin/env python
"""Self-generated accuracy baseline: run LIO / VIO / LVIO full-pipeline
sessions at the reference envelope and write docs/ATE.md.

The reference publishes no accuracy numbers (BASELINE.md); its envelope is
implied by its configs: lag 4 s (LIO, lio.yaml:3) / 7 s (VIO, vio.yaml:3) /
10 s (LVIO, lvio.yaml:3), 200 Hz IMU, 20 Hz camera, 10 Hz VLP-16
(calibration_params.yaml:11-13). Usage:

    python tools/run_ate_benchmark.py [--duration 60] [--out docs/ATE.md]
"""

import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# CPU backend by default: the table is the deterministic XLA:CPU oracle.
# Export JAX_PLATFORMS=cuda to run the same sessions on the GPU.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

from beam_slam_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

from beam_slam_tpu.pipeline.sim_session import run_synthetic_session  # noqa


CONFIGS = [
    # (mode, lag_s from the reference config, max_states). The window must
    # hold lag x state-rate states: lidar adds ~10/s (per-scan states, like
    # the reference's per-scan pose variables), camera keyframes ~2/s —
    # LVIO at 10 s lag needs ~128 slots; LIO at 4 s lag fits in 64.
    ("LIO", 4.0, 64),
    ("VIO", 7.0, 64),
    ("LVIO", 10.0, 128),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--modes", default=None,
                    help="comma-separated subset of LIO,VIO,LVIO")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "docs", "ATE.md"))
    args = ap.parse_args()
    configs = CONFIGS
    if args.modes:
        want = {m.strip().upper() for m in args.modes.split(",")}
        configs = [c for c in CONFIGS if c[0] in want]

    rows = []
    for mode, lag, max_states in configs:
        print(f"running {mode} ({args.duration:.0f} s, lag {lag} s)...",
              flush=True)
        def _oracle(cfg):
            # deterministic sync oracle: the table scores each state's
            # NEWEST-tick estimate, and under async_solve that snapshot is
            # taken one tick before the solve covering it harvests — it
            # would measure the seed, not the estimator (a ~10x artifact).
            # The deployment (async) accuracy is scored on the smoothed
            # estimates by tools/run_session.py.
            cfg.async_solve = False
            cfg.pipelined_registration = False

        r = run_synthetic_session(mode=mode, duration_s=args.duration,
                                  lag_s=lag, max_states=max_states,
                                  config_tweak=_oracle)
        print(f"  ATE {r.ate_rmse_m*100:.2f} cm, {r.n_solves} solves, "
              f"{r.mean_solve_ms:.1f} ms/solve, wall {r.wall_s:.0f} s",
              flush=True)
        rows.append(r)

    stamp = datetime.date.today().isoformat()
    with open(args.out, "w") as f:
        f.write(
            "# ATE baseline (self-generated)\n\n"
            "The reference publishes no accuracy numbers (BASELINE.md); "
            "this table is the\nself-generated baseline: full-pipeline "
            "synthetic sessions (SLAM init +\nIMU/camera/lidar fusion in "
            "the fixed-lag smoother) at the reference envelope\n"
            "(200 Hz IMU, 20 Hz camera, 10 Hz lidar; per-config lags from "
            "lio/vio/lvio.yaml),\nevaluated as SE(3)-aligned ATE RMSE "
            "against the analytic ground truth.\n"
            f"Generated by tools/run_ate_benchmark.py on {stamp} "
            "(XLA:CPU backend).\n\n"
            "| Config | Lag | Window | Duration | ATE RMSE | Solves | "
            "ms/solve (CPU) |\n|---|---|---|---|---|---|---|\n")
        for r, (_, lag, max_states) in zip(rows, configs):
            f.write(f"| {r.mode} | {lag:.0f} s | {max_states} states | "
                    f"{r.duration_s:.0f} s | "
                    f"{r.ate_rmse_m*100:.2f} cm | {r.n_solves} | "
                    f"{r.mean_solve_ms:.1f} |\n")
        f.write(
            "\nThis table is the deterministic SYNC oracle (async_solve / "
            "pipelined\nregistration pinned off — see the _oracle note in "
            "tools/run_ate_benchmark.py).\nThe deployment defaults (async "
            "solve, pipelined registration) are scored on\nthe smoothed "
            "estimates by tools/run_session.py; chip_smoke.py runs a 20 s\n"
            "LVIO session that way on the GPU.\n\n"
            "CI asserts the same pipeline under tests/test_envelope_e2e.py"
            " (shorter\nduration, same envelope rates and capacities). The "
            "solve time of the\nflagship LVIO window is measured by "
            "bench.py.\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
