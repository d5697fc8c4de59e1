#!/usr/bin/env python
"""Diagnose the LVIO-worse-than-LIO accuracy inversion (round-2 verdict #6).

Runs an instrumented synthetic session (same stream as the ATE benchmark)
and records, per tick:

  * raw position error of the NEWEST state (the filtering estimate — this is
    what docs/ATE.md scores, since the benchmark records each stamp once);
  * the LAST estimate of every stamp before it leaves the window (the
    smoothed estimate — what the fixed-lag smoother actually promises);
  * per-factor-family chi^2 (sum of squared whitened residuals) + counts;
  * estimated-vs-true landmark error distribution (the synthetic session
    knows the true landmark positions);
  * VO validation gate fire counts and smoother robustness counters.

Writes a JSON report. Usage:
    python tools/diagnose_lvio.py [--mode LVIO] [--duration 60]
        [--out /tmp/lvio_diag.json]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS") == "cpu":
    # default: the deterministic CPU oracle backend; export
    # JAX_PLATFORMS=cuda to re-run the accuracy diagnosis on the GPU
    jax.config.update("jax_platforms", "cpu")

from beam_slam_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

FAMILY_NAMES = ("imu_rel", "imu_prior", "rel_pose", "abs_pose", "gravity",
                "reproj", "idp", "const_vel", "unicycle", "marginal")


def family_chi2(sm):
    """Per-family (chi2, n_active) at the smoother's current estimate."""
    window, families, _ = sm._build_device_problem()
    out = {}
    for name, fam in zip(FAMILY_NAMES, families):
        n = int(np.asarray(fam.active).sum())
        if n == 0:
            continue
        r = fam.residual_only(window)
        out[name] = dict(chi2=round(float(jnp.sum(r * r)), 3), n=n)
    return out


def landmark_errors(sm, lms_true):
    errs = []
    for lm_id, slot in sm.slot_of_lm_id.items():
        if not sm.lm_active[slot] or lm_id >= len(lms_true):
            continue
        errs.append(float(np.linalg.norm(sm.lm_pt[slot] - lms_true[lm_id])))
    if not errs:
        return {}
    e = np.asarray(errs)
    return dict(n=len(errs), mean=round(float(e.mean()), 4),
                p95=round(float(np.percentile(e, 95)), 4),
                max=round(float(e.max()), 4))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="LVIO")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--sample-every", type=float, default=2.0,
                    help="seconds between full chi2/landmark samples")
    ap.add_argument("--out", default="/tmp/lvio_diag.json")
    ap.add_argument("--lag", type=float, default=None,
                    help="override the per-mode default lag (controlled "
                    "experiments: e.g. LIO at the LVIO lag)")
    ap.add_argument("--max-states", type=int, default=None)
    ap.add_argument("--reproj-weight", type=float, default=None,
                    help="override the reprojection information weight")
    ap.add_argument("--lidar-weight", type=float, default=None,
                    help="lidar information weight w (covariance 1/w² — "
                    "the reference's lvio_information_weights.json uses "
                    "100.0)")
    ap.add_argument("--gravity-weight", type=float, default=None,
                    help="gravity information weight (reference: 10.0)")
    ap.add_argument("--async-solve", action="store_true",
                    help="double-buffered async optimizer tick (the "
                    "deployment runtime)")
    ap.add_argument("--marg-cov", type=float, default=None,
                    help="override marginalization_prior_cov")
    ap.add_argument("--iters", type=int, default=None,
                    help="override solver max_iterations")
    ap.add_argument("--ftol", type=float, default=None,
                    help="override solver function_tolerance (0 = always "
                    "run max_iterations)")
    ap.add_argument("--vo-standalone", action="store_true",
                    help="standalone-VO mode: private visual graph, only a "
                    "relative-pose factor to the main graph")
    args = ap.parse_args()

    from beam_slam_tpu.pipeline.sim_session import run_synthetic_session
    from beam_slam_tpu.utils.evaluation import ate_rmse

    lms_box = []
    samples = []
    smoothed = {}   # stamp -> last (most-smoothed) estimate seen in-window
    first = {}      # stamp -> first estimate (what ATE.md scores)
    state = dict(next_sample=0.0)

    def on_tick(mapper, t, traj):
        if not mapper.initialized:
            return
        sm = mapper.smoother
        stamps = sm.current_stamps()
        for s in stamps:
            p = sm.get_state(s)["p"].copy()
            smoothed[s] = p
            if s not in first:
                first[s] = p
        if t < state["next_sample"]:
            return
        state["next_sample"] = t + args.sample_every
        gt = traj.sample(jnp.asarray(stamps, jnp.float32))
        errs = np.linalg.norm(
            np.stack([smoothed[s] for s in stamps]) - np.asarray(gt.p),
            axis=1)
        row = dict(
            t=round(t, 2),
            newest_err_m=round(float(errs[-1]), 4),
            window_err_mean_m=round(float(errs.mean()), 4),
            window_err_max_m=round(float(errs.max()), 4),
            n_states=len(stamps),
            chi2=family_chi2(sm),
            landmarks=landmark_errors(sm, lms_box[0]),
            counters=dict(sm.counters),
        )
        if mapper.vo is not None:
            v = mapper.vo
            row["vo"] = {k: int(val) for k, val in
                         getattr(v, "counters", {}).items()}
            val_obj = getattr(v, "validation", None)
            if val_obj is not None:
                row["vo_validation"] = {
                    k: int(val) for k, val in
                    getattr(val_obj, "counters", {}).items()}
        samples.append(row)
        print(json.dumps(row), flush=True)

    lag = args.lag if args.lag is not None else \
        {"LIO": 4.0, "VIO": 7.0, "LVIO": 10.0}[args.mode]
    max_states = args.max_states if args.max_states is not None else \
        {"LIO": 64, "VIO": 64, "LVIO": 128}[args.mode]

    def tweak(cfg):
        if args.reproj_weight is not None:
            cfg.vo.reprojection_info_weight = args.reproj_weight
        if args.lidar_weight is not None:
            cfg.scan_registration.covariance_weight = \
                1.0 / (args.lidar_weight ** 2)
        if args.gravity_weight is not None:
            cfg.gravity_info_weight = args.gravity_weight
        if args.async_solve:
            cfg.async_solve = True
        if args.marg_cov is not None:
            cfg.marginalization_prior_cov = args.marg_cov
        if args.vo_standalone:
            cfg.vo.standalone = True
        if args.iters is not None:
            cfg.max_iterations = args.iters
        if args.ftol is not None:
            cfg.function_tolerance = args.ftol

    r = run_synthetic_session(
        mode=args.mode, duration_s=args.duration, lag_s=lag,
        max_states=max_states, on_tick=on_tick,
        true_landmarks_out=lms_box, config_tweak=tweak)

    # filtering vs smoothed ATE over the SAME stamps
    stamps = sorted(smoothed.keys())
    from beam_slam_tpu.utils import sim  # noqa: F401 (traj via session)
    # re-create the trajectory exactly as the session does
    traj = None
    import beam_slam_tpu.pipeline.sim_session as ss
    traj = ss.sim.AnalyticTrajectory(amp_p=(0.6, 0.5, 0.2),
                                     v_drift=(0.35, 0.05, 0.0),
                                     amp_r=(0.1, 0.1, 0.15))
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    gt_p = np.asarray(gt.p)
    ate_first = float(ate_rmse(
        np.stack([first[s] for s in stamps]), gt_p, align="se3"))
    ate_smoothed = float(ate_rmse(
        np.stack([smoothed[s] for s in stamps]), gt_p, align="se3"))

    report = dict(
        mode=args.mode, duration_s=args.duration,
        ate_benchmark_m=round(r.ate_rmse_m, 4),
        ate_first_estimate_m=round(ate_first, 4),
        ate_smoothed_m=round(ate_smoothed, 4),
        n_solves=r.n_solves, counters=r.counters,
        samples=samples)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nATE benchmark-style {100*r.ate_rmse_m:.2f} cm | "
          f"first-estimate {100*ate_first:.2f} cm | "
          f"smoothed {100*ate_smoothed:.2f} cm")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
