#!/usr/bin/env python
"""Per-stage profile of the flagship LVIO visual-inertial BA solve.

Per-stage numbers are measured with the same chained-``lax.scan`` dispatch
amortization bench.py uses for the headline cycle (utils/timing.py), so the
stage costs *sum* to ≈ the measured cycle and can rank kernels (single
un-amortized calls would measure dispatch, not kernels). Optionally
captures an XLA trace (--trace DIR) with jax.profiler for offline
inspection.

Usage:  python tools/profile_solver.py [--out chiprun_out/PROFILE.md]
            [--trace DIR]
"""

import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from beam_slam_tpu.utils.timing import (amortized_median_ms,  # noqa: E402
                                        chained_median_ms)

N_KF = 40
KF_DT = 0.25
N_LM = 256
OBS_PER_LM = 8
N_IDP = 64


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "chiprun_out", "PROFILE.md"))
    ap.add_argument("--trace", default=None,
                    help="directory for a jax.profiler trace")
    args = ap.parse_args()

    from beam_slam_tpu.solver import gauss_newton as gn
    from beam_slam_tpu.utils import synthetic

    backend = jax.default_backend()
    dev = jax.devices()[0]
    key = jax.random.PRNGKey(0)
    losses = (None, None, 1.0, 2.0, 2.0)
    build = jax.jit(lambda k: synthetic.build_lvio_window(
        k, n_kf=N_KF, kf_dt=KF_DT, with_vision=True, n_landmarks=N_LM,
        obs_per_lm=OBS_PER_LM, n_idp=N_IDP)[:2])
    window, families = jax.block_until_ready(build(key))

    rows = []

    # per-family linearization (the "small-op tail" suspects)
    for fam, loss in zip(families, losses):
        name = type(fam).__name__
        ms = amortized_median_ms(lambda w, fam=fam: fam.linearize(w)[:2],
                                 window)
        rows.append((f"linearize {name}", ms, True))

    ms_asm = amortized_median_ms(
        lambda w: gn._assemble(w, families, losses, "scatter"), window)
    rows.append(("assemble (all families + normal eqs)", ms_asm, True))

    assemble = jax.jit(lambda w: gn._assemble(w, families, losses, "scatter"))
    H, g, H_ll, g_l, W, _ = jax.block_until_ready(assemble(window))
    free = jnp.concatenate([window.dense_free_mask(),
                            jnp.zeros((1,), bool)])
    lm_free = window.landmarks.active & ~window.landmarks.held
    ms_schur = amortized_median_ms(
        lambda H, g, H_ll, g_l, W: gn._solve_damped(
            H, g, free, jnp.asarray(1e-4, H.dtype), H_ll, g_l, W, lm_free),
        H, g, H_ll, g_l, W)
    rows.append(("Schur-reduced damped solve (inv+matmul+Cholesky)",
                 ms_schur, True))

    ms_cost = amortized_median_ms(
        lambda w: gn.total_cost(w, families, losses), window)
    rows.append(("residual/cost pass (step accept/reject)", ms_cost, True))

    # one LM iteration ≈ assemble + schur solve + cost pass (+ bookkeeping)
    per_iter = ms_asm + ms_schur + ms_cost
    rows.append(("per-LM-iteration sum (assemble+solve+cost)", per_iter,
                 False))

    opt10 = gn.SolverOptions(max_iterations=10)
    ms_cycle = chained_median_ms(
        lambda w: gn.solve(w, families, losses, opt10)[0], window)
    rows.append(("full LM cycle, 10 fixed iterations", ms_cycle, False))
    rows.append(("  -> 10 x per-iteration sum (consistency check)",
                 10 * per_iter, False))

    warm = jax.block_until_ready(jax.jit(
        lambda w: gn.solve(w, families, losses, opt10)[0])(window))
    opt_ee = gn.SolverOptions(max_iterations=10, early_exit=True)
    ms_ee = chained_median_ms(
        lambda w: gn.solve(w, families, losses, opt_ee)[0], warm)
    rows.append(("LM cycle w/ early exit, near-converged input", ms_ee,
                 False))

    if args.trace:
        solve10 = jax.jit(lambda w: gn.solve(w, families, losses, opt10)[0])
        jax.block_until_ready(solve10(window))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(solve10(window))
        print(f"trace written to {args.trace}")

    coverage = 100.0 * 10 * per_iter / ms_cycle
    stamp = datetime.date.today().isoformat()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(
            "# Solver profile\n\n"
            f"Flagship LVIO VI-BA window ({N_KF} states, "
            f"{N_LM}+{N_IDP} landmarks, {N_LM*OBS_PER_LM} reprojection + "
            f"{N_IDP*(OBS_PER_LM-1)} IDP + {N_KF-1} IMU + {N_KF-1} lidar "
            "factors), per-stage medians.\n\n"
            f"Backend: **{backend}** "
            f"({dev.device_kind if hasattr(dev, 'device_kind') else dev}) — "
            f"generated {stamp} by tools/profile_solver.py.\n"
            "All stages are dispatch-amortized (chained lax.scan, "
            "utils/timing.py), so\nper-stage numbers are true kernel costs: "
            "10 x (assemble + solve + cost)\n"
            f"accounts for {coverage:.0f}% of the measured 10-iteration "
            "cycle.\n\n"
            "| Stage | median ms |\n|---|---|\n")
        for name, ms, _ in rows:
            f.write(f"| {name} | {ms:.3f} |\n")
        f.write("\nbench.py measures the chained steady-state cycle.\n")
    print(f"wrote {args.out}")
    for name, ms, _ in rows:
        print(f"{name:55s} {ms:9.3f} ms")
    print(f"stage-sum coverage of cycle: {coverage:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
