#!/usr/bin/env python
"""Smoke test of beam_slam_tpu's main path on an NVIDIA GPU.

Drives the public entry points once at deployed sizes, compares every
phase with a plain reference computed in this same process on the CPU
device, and fails (nonzero exit, no ``ok`` line) if anything disagrees:

  device        JAX's first device must be a GPU; nothing carries on on CPU
  solve         flagship LVIO LM solve (solver/gauss_newton.solve) vs CPU
  registration  LOAM scan-to-map registration (lidar/registration) vs CPU
  batched       B=32 shared-topology batched solve (solver/batched) vs
                per-window CPU solves
  session       20 s LVIO LocalMapper session (sync runtime, async solve,
                pipelined registration) scored by SE(3)-aligned ATE

``--multichip`` runs only the three ``parallel/`` paths on four GPUs and
compares each with its one-card result.

Usage (from the repository root):
  python chip_smoke.py               # one GPU
  python chip_smoke.py --multichip   # four GPUs

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# The CPU device hosts the references; keep it visible when the launcher
# restricts JAX to the GPU platform.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))

# ---- tolerances. The GPU side runs at the package's matmul precision
# (beam_slam_tpu/__init__.py); every CPU reference runs at "highest".
# Flagship solve: final cost relative error, state positions (m).
SOLVE_COST_RTOL = 1e-3
SOLVE_POS_ATOL = 1e-4
# LOAM registration: translation (m), rotation (rad), inlier count (rel).
REG_TRANS_ATOL = 1e-3
REG_ROT_ATOL = 1e-3
REG_INLIER_RTOL = 0.01
# Batched refinement: positions (m) of every window vs its CPU solve.
BATCH_POS_ATOL = 1e-4
# Session ATE bound (m): twice the ATE of the identical 20 s session run
# on XLA:CPU (0.503 cm there, 195 solves; see CHANGES.md), capped at 5 cm.
SESSION_ATE_BOUND_M = min(2 * 0.00503, 0.05)
# Multichip: 4-card vs 1-card agreement (positions, m; cost, relative).
MULTI_POS_ATOL = 1e-3
MULTI_COST_RTOL = 1e-3

# ---- flagship window (bench.py's census)
N_KF, KF_DT, N_LM, OBS_PER_LM, N_IDP = 40, 0.25, 256, 8, 64
LOSSES = (None, None, 1.0, 2.0, 2.0)
BATCH = 32
PGO_POSES = 4096


class PhaseError(RuntimeError):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def _cpu():
    return jax.devices("cpu")[0]


def _on_cpu(tree):
    return jax.device_put(tree, _cpu())


def _timed(fn, *args):
    """(result, first-call seconds incl. compile, second-call seconds)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, t1 - t0, time.perf_counter() - t1


def flagship_window(key=0, n_kf=N_KF, n_lm=N_LM, obs_per_lm=OBS_PER_LM,
                    n_idp=N_IDP):
    from beam_slam_tpu.utils import synthetic
    build = jax.jit(lambda k: synthetic.build_lvio_window(
        k, n_kf=n_kf, kf_dt=KF_DT, with_vision=True, n_landmarks=n_lm,
        obs_per_lm=obs_per_lm, n_idp=n_idp)[:2])
    return build, jax.block_until_ready(build(jax.random.PRNGKey(key)))


def _solve_fn(n_iter=10):
    from beam_slam_tpu.solver import gauss_newton as gn
    options = gn.SolverOptions(max_iterations=n_iter, scan_length=n_iter)
    return lambda w, f: gn.solve(w, f, LOSSES, options)


def _cpu_solve(window, families, n_iter=10):
    with jax.default_device(_cpu()), \
            jax.default_matmul_precision("highest"):
        return jax.block_until_ready(
            _solve_fn(n_iter)(*_on_cpu((window, families))))


def phase_solve(**size):
    _, (window, families) = flagship_window(**size)
    (out, diag), t_first, t_run = _timed(_solve_fn(), window, families)
    ref, ref_diag = _cpu_solve(window, families)
    cost, ref_cost = float(diag.final_cost), float(ref_diag.final_cost)
    cost_err = abs(cost - ref_cost) / max(abs(ref_cost), 1e-20)
    pos_err = float(np.max(np.abs(np.asarray(out.imu.p)
                                  - np.asarray(ref.imu.p))))
    print(f"solve: first call {t_first:.2f} s, steady {1e3 * t_run:.3f} ms; "
          f"cost {cost:.6g} vs cpu {ref_cost:.6g} (rel {cost_err:.2e}, "
          f"tol {SOLVE_COST_RTOL:g}); max |dp| {pos_err:.2e} m "
          f"(tol {SOLVE_POS_ATOL:g})", flush=True)
    _check(np.isfinite(cost) and cost < float(diag.initial_cost),
           "solve: cost did not decrease")
    _check(cost_err <= SOLVE_COST_RTOL, "solve: final cost disagrees")
    _check(pos_err <= SOLVE_POS_ATOL, "solve: positions disagree")


def registration_problem(n_rings=16, width=504, map_size=10):
    """bench.py's LOAM shapes: 16x504 scan against a 10-scan map deduped
    at 0.1 m (configs/registration/scan_to_map.json)."""
    from beam_slam_tpu.core import lie
    from beam_slam_tpu.lidar import features as feat
    from beam_slam_tpu.lidar.cloud import synthetic_structured_scene
    from beam_slam_tpu.lidar.registration_map import RegistrationMap

    world = synthetic_structured_scene(n_rings=n_rings, width=width)
    fc = feat.extract_features(world)
    rmap = RegistrationMap(map_size=map_size, world_voxel=0.1)
    for s in range(map_size):
        rmap.add_scan(float(s), jnp.asarray([1.0, 0, 0, 0]),
                      jnp.asarray([0.1 * s, 0.0, 0.0]), fc)
    q0 = lie.so3_exp_quat(jnp.asarray([0.01, -0.01, 0.02]))
    p0 = jnp.asarray([0.05, -0.03, 0.02])
    return (fc,) + tuple(rmap.world_frame()) + (q0, p0)


def phase_registration(**size):
    from beam_slam_tpu.core import lie
    from beam_slam_tpu.lidar import registration as reg

    args = registration_problem(**size)
    cfg = reg.LoamRegistrationConfig()
    run = lambda *a: reg.register_loam(*a, cfg)  # noqa: E731
    r, t_first, t_run = _timed(run, *args)
    with jax.default_device(_cpu()), \
            jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(run(*_on_cpu(args)))
    dt = float(np.max(np.abs(np.asarray(r.p) - np.asarray(ref.p))))
    dq = lie.quat_mul(lie.quat_conj(np.asarray(ref.q, np.float64)),
                      np.asarray(r.q, np.float64))
    drot = float(np.linalg.norm(lie.so3_log(dq)))
    n, n_ref = int(r.n_inliers), int(ref.n_inliers)
    dn = abs(n - n_ref) / max(n_ref, 1)
    print(f"registration: first call {t_first:.2f} s, steady "
          f"{1e3 * t_run:.3f} ms; |dt| {dt:.2e} m (tol {REG_TRANS_ATOL:g}), "
          f"|drot| {drot:.2e} rad (tol {REG_ROT_ATOL:g}), inliers {n} vs "
          f"cpu {n_ref} (rel {dn:.3f}, tol {REG_INLIER_RTOL:g})", flush=True)
    _check(bool(r.converged), "registration: did not converge")
    _check(dt <= REG_TRANS_ATOL, "registration: translation disagrees")
    _check(drot <= REG_ROT_ATOL, "registration: rotation disagrees")
    _check(dn <= REG_INLIER_RTOL, "registration: inlier count disagrees")


def phase_batched(batch=BATCH, **size):
    from beam_slam_tpu.solver import batched as bsv
    from beam_slam_tpu.solver import gauss_newton as gn

    build, _ = flagship_window(**size)
    keys = jax.random.split(jax.random.PRNGKey(1), batch)
    wins, fams = jax.block_until_ready(jax.jit(jax.vmap(build))(keys))
    options = gn.SolverOptions(max_iterations=10, scan_length=10)
    run = lambda w, f: bsv.solve_batched_shared(  # noqa: E731
        w, f, LOSSES, options)
    (out, diag), t_first, t_run = _timed(run, wins, fams)
    p = np.asarray(out.imu.p)
    pos_err = 0.0
    for b in range(batch):
        one = jax.tree_util.tree_map(lambda x: x[b], (wins, fams))
        ref, _ = _cpu_solve(*one)
        pos_err = max(pos_err, float(np.max(np.abs(
            p[b] - np.asarray(ref.imu.p)))))
    decreased = np.asarray(diag.final_cost) < np.asarray(diag.initial_cost)
    print(f"batched: B={batch} first call {t_first:.2f} s, steady "
          f"{1e3 * t_run:.3f} ms ({batch / t_run:.1f} windows/s); max |dp| "
          f"vs per-window cpu {pos_err:.2e} m (tol {BATCH_POS_ATOL:g}); "
          f"cost decreased in {int(decreased.sum())}/{batch}", flush=True)
    _check(bool(decreased.all()), "batched: a window's cost did not drop")
    _check(pos_err <= BATCH_POS_ATOL, "batched: positions disagree")


def phase_session(duration_s=20.0):
    """LVIO at configs/lvio.yaml's 10 s lag and 10 iterations, with the
    capacities of the LVIO row of docs/ATE.md, the deployment defaults
    (async solve, pipelined device-resident registration) and the sync
    runtime."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from run_session import run_session

    r = run_session("LVIO", duration_s, "sync", lag_s=10.0, max_states=128,
                    pipelined=True, max_iterations=10)
    ate = r["ate_rmse_cm"] / 100.0
    dropped = (sum(r["dropped"].values())
               + r["counters"].get("dropped_transactions", 0))
    print(f"session: LVIO {duration_s:.0f} s, wall {r['wall_s']} s, RTF "
          f"{r['rtf']} (steady {r['steady_rtf']}), {r['n_solves']} solves, "
          f"dropped {dropped}, ATE {r['ate_rmse_cm']} cm "
          f"(bound {100 * SESSION_ATE_BOUND_M:g} cm)", flush=True)
    _check(r["n_solves"] > 0, "session: no solve ran")
    _check(dropped == 0, "session: events were dropped")
    _check(ate <= SESSION_ATE_BOUND_M, "session: ATE above bound")


# ---- four cards ---------------------------------------------------------

def _spans(x, n):
    """True when every leaf of ``x`` is spread over ``n`` devices."""
    return all(len(leaf.sharding.device_set) == n
               for leaf in jax.tree_util.tree_leaves(x))


def pgo_ring(n_poses=PGO_POSES, loop_every=16, drift=0.01, noise=0.005,
             seed=0):
    """Ring trajectory with drifted initials and noisy relative
    measurements; loop closures join pose i to i + N/2 every
    ``loop_every`` poses, so they cross every shard."""
    from beam_slam_tpu.core import lie
    from beam_slam_tpu.parallel import distributed_pgo as dpgo

    rng = np.random.default_rng(seed)
    N = n_poses
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    radius = N / (2 * np.pi) * 0.5          # 0.5 m between poses
    p_gt = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     0.2 * np.sin(3 * ang)], 1).astype(np.float32)
    q_gt = lie.so3_exp_quat(np.stack(
        [0 * ang, 0 * ang, ang], 1).astype(np.float32))
    p0 = p_gt + np.cumsum(rng.standard_normal((N, 3)) * drift,
                          axis=0).astype(np.float32)
    q0 = lie.quat_mul(q_gt, lie.so3_exp_quat(
        (rng.standard_normal((N, 3)) * 0.01).astype(np.float32)))
    p0[0], q0[0] = p_gt[0], q_gt[0]
    ii = np.arange(N - 1)
    loops = np.arange(0, N // 2, loop_every)
    i = np.concatenate([ii, loops]).astype(np.int32)
    j = np.concatenate([ii + 1, loops + N // 2]).astype(np.int32)
    qi_inv = lie.quat_conj(q_gt[i])
    F = len(i)
    dq = lie.quat_mul(lie.quat_mul(qi_inv, q_gt[j]), lie.so3_exp_quat(
        (rng.standard_normal((F, 3)) * noise / 5).astype(np.float32)))
    dp = (lie.quat_rotate(qi_inv, p_gt[j] - p_gt[i])
          + rng.standard_normal((F, 3)).astype(np.float32) * noise)
    fac = dpgo.PGOFactors(
        i=jnp.asarray(i), j=jnp.asarray(j),
        dq=jnp.asarray(dq), dp=jnp.asarray(dp),
        sqrt_info=jnp.tile(1e2 * jnp.eye(6), (F, 1, 1)),
        active=jnp.ones(F, bool))
    pri = dpgo.PGOPriors(
        slot=jnp.zeros((1,), jnp.int32), q0=jnp.asarray(q_gt[:1]),
        p0=jnp.asarray(p_gt[:1]), sqrt_info=1e3 * jnp.eye(6)[None],
        active=jnp.ones(1, bool))
    state = dpgo.PGOState(q=jnp.asarray(q0), p=jnp.asarray(p0),
                          free=jnp.ones(N, bool).at[0].set(False))
    return state, fac, pri


def multichip_pgo(n_dev=4, n_poses=PGO_POSES, n_iter=8):
    from jax.sharding import Mesh
    from beam_slam_tpu.parallel import distributed_pgo as dpgo

    state, fac, pri = pgo_ring(n_poses)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), (dpgo.AXIS,))
    run = lambda: dpgo.solve_distributed(  # noqa: E731
        mesh, state, fac, pri, n_iter=n_iter)
    (out, c0, cf), t_first, t_run = _timed(run)
    (out1, _, cf1), t1_first, t1_run = _timed(
        lambda: dpgo.solve_single(state, fac, pri, n_iter=n_iter))
    pos_err = float(np.max(np.abs(np.asarray(out.p) - np.asarray(out1.p))))
    cost_err = abs(float(cf) - float(cf1)) / max(abs(float(cf1)), 1e-20)
    print(f"multichip pgo: {n_poses} poses, {int(fac.i.shape[0])} factors, "
          f"{n_dev} cards {1e3 * t_run:.1f} ms vs 1 card "
          f"{1e3 * t1_run:.1f} ms (first calls {t_first:.1f} / "
          f"{t1_first:.1f} s); cost {float(c0):.6g} -> {float(cf):.6g}; "
          f"max |dp| {pos_err:.2e} m (tol {MULTI_POS_ATOL:g}), cost rel "
          f"{cost_err:.2e} (tol {MULTI_COST_RTOL:g})", flush=True)
    _check(_spans(out, n_dev), "multichip pgo: state not on every card")
    _check(float(cf) < float(c0), "multichip pgo: cost did not decrease")
    _check(pos_err <= MULTI_POS_ATOL, "multichip pgo: positions disagree")
    _check(cost_err <= MULTI_COST_RTOL, "multichip pgo: cost disagrees")


def multichip_ba(n_dev=4, **size):
    from beam_slam_tpu.parallel import distributed_ba as dba
    from beam_slam_tpu.solver import gauss_newton as gn

    _, (window, families) = flagship_window(**size)
    mesh = dba.make_mesh(n_dev)
    options = gn.SolverOptions(max_iterations=10, scan_length=10)
    # solve_distributed traces a fresh shard_map program on every call, so
    # its time here includes compilation.
    t0 = time.perf_counter()
    out, diag = jax.block_until_ready(dba.solve_distributed(
        mesh, window, families, LOSSES, options))
    t_first = time.perf_counter() - t0
    (out1, diag1), _, t1_run = _timed(_solve_fn(), window, families)
    pos_err = float(np.max(np.abs(np.asarray(out.imu.p)
                                  - np.asarray(out1.imu.p))))
    cf, cf1 = float(diag.final_cost), float(diag1.final_cost)
    cost_err = abs(cf - cf1) / max(abs(cf1), 1e-20)
    print(f"multichip ba: {n_dev} cards {t_first:.1f} s incl. compile; 1 "
          f"card steady {1e3 * t1_run:.3f} ms; max |dp| "
          f"{pos_err:.2e} m (tol {SOLVE_POS_ATOL:g}), cost rel "
          f"{cost_err:.2e} (tol {SOLVE_COST_RTOL:g})", flush=True)
    _check(_spans(out.imu.p, n_dev), "multichip ba: window not on every card")
    _check(pos_err <= SOLVE_POS_ATOL, "multichip ba: positions disagree")
    _check(cost_err <= SOLVE_COST_RTOL, "multichip ba: cost disagrees")


def multichip_refinement(n_dev=4, batch=BATCH, **size):
    from beam_slam_tpu.parallel import sharded
    from beam_slam_tpu.solver import gauss_newton as gn

    build, _ = flagship_window(**size)
    keys = jax.random.split(jax.random.PRNGKey(1), batch)
    wins, fams = jax.block_until_ready(jax.jit(jax.vmap(build))(keys))
    mesh = sharded.make_mesh(n_dev)
    options = gn.SolverOptions(max_iterations=10, scan_length=10)
    (out, diags, total), t_first, t_run = _timed(
        lambda: sharded.distributed_refinement_step(mesh, wins, fams,
                                                    LOSSES, options))
    (out1, diags1), _, t1_run = _timed(
        lambda: sharded.solve_batched(wins, fams, LOSSES, options))
    pos_err = float(np.max(np.abs(np.asarray(out.imu.p)
                                  - np.asarray(out1.imu.p))))
    shards = {s.device for s in out.imu.p.addressable_shards}
    print(f"multichip refinement: B={batch} {n_dev} cards "
          f"{1e3 * t_run:.3f} ms vs 1 card {1e3 * t1_run:.3f} ms (first "
          f"call {t_first:.1f} s); max |dp| {pos_err:.2e} m (tol "
          f"{BATCH_POS_ATOL:g}); batch shards on {len(shards)} cards",
          flush=True)
    _check(len(shards) == n_dev and out.imu.p.addressable_shards[0]
           .data.shape[0] == batch // n_dev,
           "multichip refinement: batch not split over every card")
    _check(float(total) <= float(jnp.sum(diags.initial_cost)),
           "multichip refinement: total cost did not decrease")
    _check(pos_err <= BATCH_POS_ATOL, "multichip refinement: positions "
           "disagree")


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the parallel/ paths on four GPUs")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"device: no GPU (JAX's first device is {dev.platform}); "
              "nothing runs on the CPU", file=sys.stderr)
        return 2
    n_dev = len(jax.devices())
    print(f"device: {dev.platform} {dev.device_kind} x{n_dev}", flush=True)
    print(f"gpu: {gpu_name_and_power_limit()}", flush=True)

    import beam_slam_tpu  # noqa: F401  (sets the package matmul precision)
    from beam_slam_tpu.ops.native import native_available
    from beam_slam_tpu.utils import compile_cache

    print(f"compile cache: {compile_cache.enable()}", flush=True)
    print(f"matmul precision: {jax.config.jax_default_matmul_precision}; "
          f"native host library: "
          f"{'loaded' if native_available() else 'not loaded'}", flush=True)

    if args.multichip:
        if n_dev < 4:
            print(f"--multichip needs 4 GPUs, found {n_dev}",
                  file=sys.stderr)
            return 2
        phases = [multichip_pgo, multichip_ba, multichip_refinement]

    else:
        phases = [phase_solve, phase_registration, phase_batched,
                  phase_session]

    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(f"phase {phase.__name__}: ok in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
