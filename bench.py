#!/usr/bin/env python
"""Flagship benchmark: full LVIO visual-inertial bundle-adjustment cycle.

The reference's headline claim is "real time, full visual-inertial bundle
adjustment" (/root/reference/README.md:46) under a 0.05 s per-cycle Ceres
budget on an 8-thread CPU (beam_slam_launch/config/lvio.yaml:13-14
max_solver_time_in_seconds: 0.05; see BASELINE.md). We measure the full LM
solve (10 iterations) of a window whose factor census matches an actual LVIO
tick at the reference envelope (lvio.yaml:3 lag 10 s, ~4 Hz keyframes):

  40 IMU states x 15 dof, 39 preintegrated IMU factors (200 Hz chain),
  39 lidar relative-pose factors with optimizable extrinsic (Cauchy loss),
  256 Euclidean landmarks x 8 observations = 2048 reprojection factors,
  64 inverse-depth landmarks x 7 = 448 IDP factors (Cauchy loss),
  landmarks Schur-eliminated on chip, window-start prior.

Steady-state (compiled), median over repeats, on one GPU. Exits nonzero
without printing a result when JAX's first device is not a GPU.

Prints one JSON line:
  {"metric": "lvio_vi_ba_cycle_ms", "value": ..., "unit": "ms",
   "vs_baseline": <50ms / value>, "device": {platform, kind, count},
   "extra": {stage breakdown, census}}
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

N_KF = 40
KF_DT = 0.25
N_LM = 256
OBS_PER_LM = 8
N_IDP = 64


def _median_ms(fn, perturb, *args, n_rep=8, inner=16):
    """Median per-call ms of fn, amortizing host->device dispatch by chaining
    ``inner`` calls inside one jitted lax.scan. ``perturb(args, acc)`` must
    make the inputs depend on the loop carry (an inert +0.0*acc is enough) so
    XLA cannot hoist fn out of the scan as loop-invariant."""

    @jax.jit
    def chained(*a):
        def body(acc, _):
            out = fn(*perturb(a, acc))
            first = jax.tree_util.tree_leaves(out)[0]
            return acc + 0.0 * jnp.sum(first.astype(jnp.float32)), None
        acc, _ = jax.lax.scan(body, jnp.zeros(()), None, length=inner)
        return acc

    jax.block_until_ready(chained(*args))  # compile + warm
    times = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        out = chained(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / inner)
    times.sort()
    return 1e3 * times[len(times) // 2]


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX's first device is "
              f"{dev.platform}", file=sys.stderr)
        return 2

    from beam_slam_tpu.solver import gauss_newton as gn
    from beam_slam_tpu.utils import compile_cache, synthetic

    compile_cache.enable()

    key = jax.random.PRNGKey(0)
    losses = (None, None, 1.0, 2.0, 2.0)
    build = jax.jit(lambda k: synthetic.build_lvio_window(
        k, n_kf=N_KF, kf_dt=KF_DT, with_vision=True, n_landmarks=N_LM,
        obs_per_lm=OBS_PER_LM, n_idp=N_IDP)[:2])
    window, families = jax.block_until_ready(build(key))
    options = gn.SolverOptions(max_iterations=10, scan_length=10)

    # ---- headline: full LM cycle, amortized over R chained solves.
    # Each consumes the previous output window (like successive smoother
    # ticks) so the per-call host->device dispatch is amortized out.
    R = 16

    @jax.jit
    def chained(win):
        def body(w, _):
            out, diag = gn.solve(w, families, losses, options)
            return out, diag.final_cost
        return jax.lax.scan(body, win, None, length=R)

    out, costs = jax.block_until_ready(chained(window))
    assert float(costs[-1]) < float(costs[0]) * 10, "solver diverged"
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        out, costs = chained(window)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    cycle_ms = 1e3 * times[len(times) // 2] / R

    # ---- steady-state cycle with convergence early-exit (the Ceres
    # behavior: iterate until function_tolerance). Chained solves consume
    # near-converged windows, so this is the sustained smoother-tick cost.
    options_ee = options._replace(early_exit=True, scan_length=None)

    @jax.jit
    def chained_ee(win):
        def body(w, _):
            out, diag = gn.solve(w, families, losses, options_ee)
            return out, diag.iterations
        return jax.lax.scan(body, win, None, length=R)

    out_ee, iters_ee = jax.block_until_ready(chained_ee(window))
    times_ee = []
    for _ in range(8):
        t0 = time.perf_counter()
        out_ee, iters_ee = chained_ee(window)
        jax.block_until_ready(out_ee)
        times_ee.append(time.perf_counter() - t0)
    times_ee.sort()
    ee_cycle_ms = 1e3 * times_ee[len(times_ee) // 2] / R
    ee_mean_iters = float(jnp.mean(iters_ee.astype(jnp.float32)))

    # ---- stage breakdown (each stage chained in its own jitted scan)
    def perturb_window(a, acc):
        w = a[0]
        return (w.replace(imu=w.imu.replace(p=w.imu.p + 0.0 * acc)),) + a[1:]

    def perturb_first(a, acc):
        return (a[0] + 0.0 * acc,) + a[1:]

    assemble = lambda w: gn._assemble(w, families, losses, "scatter")
    H, g, H_ll, g_l, W, _ = jax.block_until_ready(jax.jit(assemble)(window))
    assemble_ms = _median_ms(assemble, perturb_window, window)

    free = jnp.concatenate([window.dense_free_mask(),
                            jnp.zeros((1,), bool)])
    lm_free = window.landmarks.active & ~window.landmarks.held
    schur = lambda H, g, H_ll, g_l, W: gn._solve_damped(
        H, g, free, jnp.asarray(1e-4, H.dtype), H_ll, g_l, W, lm_free)
    schur_ms = _median_ms(schur, perturb_first, H, g, H_ll, g_l, W)
    cost_fn = lambda w: gn.total_cost(w, families, losses)
    cost_ms = _median_ms(cost_fn, perturb_window, window)

    # ---- secondary metric: LOAM scan-to-map registration kernel (the other
    # hot path: ~per-scan cost at 10 Hz; scan 2112 edges + 6144 surfs against
    # a 10-scan rolling map)
    from beam_slam_tpu.lidar import features as feat
    from beam_slam_tpu.lidar import registration as reg
    from beam_slam_tpu.lidar.cloud import synthetic_structured_scene
    from beam_slam_tpu.lidar.registration_map import RegistrationMap
    from beam_slam_tpu.core import lie

    world = synthetic_structured_scene(n_rings=16, width=504)
    fc = feat.extract_features(world)
    # production scan-to-map config: world map voxel-deduped at 0.1 m
    # (configs/registration/scan_to_map.json downsample_voxel_size)
    rmap = RegistrationMap(map_size=10, world_voxel=0.1)
    for s in range(10):
        rmap.add_scan(float(s), jnp.asarray([1.0, 0, 0, 0]),
                      jnp.asarray([0.1 * s, 0.0, 0.0]), fc)
    me, mev, ms, msv = rmap.world_frame()
    q0 = lie.so3_exp_quat(jnp.asarray([0.01, -0.01, 0.02]))
    p0 = jnp.asarray([0.05, -0.03, 0.02])
    reg_cfg = reg.LoamRegistrationConfig()

    def reg_fn(p_seed):
        r = reg.register_loam(fc, me, mev, ms, msv, q0, p_seed, reg_cfg)
        return r.q, r.p

    reg_ms = _median_ms(reg_fn, perturb_first, p0)

    # ---- single-card batched throughput: B independent flagship windows
    # through the shared-topology batched LM solve (the submap-refinement
    # workload — bs_models/src/lib/global_mapping/submap_refinement.cpp:
    # 24-162 is embarrassingly parallel per submap, with a shared
    # factor-graph template → solver/batched.py). B=1 is the latency-bound
    # real-time window.
    from beam_slam_tpu.solver import batched as bsv

    throughput = {}
    for B in (1, 8, 32, 64):
        keys = jax.random.split(jax.random.PRNGKey(1), B)
        wins_b, fams_b = jax.block_until_ready(
            jax.jit(jax.vmap(build))(keys))

        @jax.jit
        def chained_b(wins):
            def body(w, _):
                out, _ = bsv.solve_batched_shared(w, fams_b, losses,
                                                  options)
                return out, None
            out, _ = jax.lax.scan(body, wins, None, length=8)
            return out

        jax.block_until_ready(chained_b(wins_b))
        tb = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(chained_b(wins_b))
            tb.append((time.perf_counter() - t0) / 8)
        tb.sort()
        per_batch_s = tb[len(tb) // 2]
        throughput[B] = B / per_batch_s

    baseline_ms = 50.0  # reference per-cycle solver budget (lvio.yaml:14)
    # cycles/s the compiled solve sustains; the reference optimizer must
    # complete 1/0.07 ~= 14.3 cycles/s to keep up with a 20 Hz camera.
    cycles_per_s = 1e3 / cycle_ms
    print(json.dumps({
        "metric": "lvio_vi_ba_cycle_ms",
        "value": round(cycle_ms, 3),
        "unit": "ms",
        "vs_baseline": round(baseline_ms / cycle_ms, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {
            "n_states": N_KF,
            "n_landmarks": N_LM + N_IDP,
            "n_reprojection_factors": N_LM * OBS_PER_LM,
            "n_idp_factors": N_IDP * (OBS_PER_LM - 1),
            "n_imu_factors": N_KF - 1,
            "n_lidar_factors": N_KF - 1,
            "lm_iterations": 10,
            # standalone per-stage medians (each stage in its own jitted
            # scan); they carry per-step overhead the fused solve doesn't,
            # so they bound — not sum to — the cycle time
            "assemble_standalone_ms": round(assemble_ms, 3),
            "schur_solve_standalone_ms": round(schur_ms, 3),
            "residual_pass_standalone_ms": round(cost_ms, 3),
            "cycles_per_s": round(cycles_per_s, 1),
            "camera_fps_sustained": round(20.0 * cycles_per_s / 14.3, 1),
            "loam_registration_ms": round(reg_ms, 3),
            # while_loop early exit at function_tolerance (steady state:
            # consecutive ticks converge in ~1-2 iterations, like Ceres)
            "early_exit_cycle_ms": round(ee_cycle_ms, 3),
            "early_exit_mean_iterations": round(ee_mean_iters, 2),
            # batched single-chip throughput (submap-refinement workload)
            "windows_per_s_b1": round(throughput[1], 1),
            "windows_per_s_b8": round(throughput[8], 1),
            "windows_per_s_b32": round(throughput[32], 1),
            "windows_per_s_b64": round(throughput[64], 1),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
