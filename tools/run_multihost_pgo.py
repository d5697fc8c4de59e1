#!/usr/bin/env python
"""Two-process multi-host PGO run on localhost (the multi-host deploy story,
SURVEY.md §7.8, executed as REAL separate processes).

Coordinator mode (default): spawns 2 worker processes of this same script,
each a separate jax runtime pinned to the CPU backend (4 virtual devices;
the workers never touch a GPU, so they cannot contend for one), joined via
``jax.distributed`` over a localhost coordination service. Each worker
builds the identical synthetic loop-closure ring problem, enters
``initialize_from_env`` → ``make_hybrid_mesh`` (the ``process_count() > 1``
branch) → ``solve_pgo_multihost``; process 0 additionally solves the same
problem serially on one local device and asserts agreement — validating
that the hierarchical hosts×shards reduction is exact across process
boundaries, not just across folded local devices.

Usage:
    python tools/run_multihost_pgo.py             # spawn + validate (PASS/FAIL)
    python tools/run_multihost_pgo.py --n-poses 64 --n-iter 20
"""

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker() -> int:
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from beam_slam_tpu.core import lie
    from beam_slam_tpu.parallel import distributed_pgo as dpgo
    from beam_slam_tpu.parallel import multihost as mh

    assert mh.initialize_from_env(), "jax.distributed did not initialize"
    pid = jax.process_index()
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.devices()
    assert jax.local_device_count() == 4

    n_poses = int(os.environ.get("MH_N_POSES", "64"))
    n_iter = int(os.environ.get("MH_N_ITER", "20"))

    # identical deterministic problem in every process (the contract of
    # multi-controller jax: same global values everywhere)
    ang = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    ang = ang.astype(np.float32)
    p_gt = np.stack([np.cos(ang), np.sin(ang), 0 * ang], 1)
    q_gt = np.stack([np.asarray(lie.so3_exp_quat(
        jnp.asarray([0, 0, a], jnp.float32))) for a in ang])
    rng = np.random.default_rng(7)
    p_init = p_gt + rng.standard_normal(p_gt.shape).astype(np.float32) * 0.05
    p_init[0] = p_gt[0]
    state = dpgo.PGOState(q=jnp.asarray(q_gt), p=jnp.asarray(p_init),
                          free=jnp.ones(n_poses, bool).at[0].set(False))

    def rel(i, j):
        dq = np.asarray(lie.quat_mul(lie.quat_conj(jnp.asarray(q_gt[i])),
                                     jnp.asarray(q_gt[j])))
        dp = np.asarray(lie.quat_rotate(lie.quat_conj(jnp.asarray(q_gt[i])),
                                        jnp.asarray(p_gt[j] - p_gt[i])))
        return dq, dp

    pairs = [(i, i + 1) for i in range(n_poses - 1)]
    pairs += [(0, n_poses // 2), (n_poses // 4, 3 * n_poses // 4)]
    fac = dpgo.PGOFactors.zeros(len(pairs))
    for k, (i, j) in enumerate(pairs):
        dq, dp = rel(i, j)
        fac = fac._replace(
            i=fac.i.at[k].set(i), j=fac.j.at[k].set(j),
            dq=fac.dq.at[k].set(jnp.asarray(dq)),
            dp=fac.dp.at[k].set(jnp.asarray(dp)),
            sqrt_info=fac.sqrt_info.at[k].set(1e2 * jnp.eye(6)),
            active=fac.active.at[k].set(True))
    pri = dpgo.PGOPriors.zeros(2)
    pri = pri._replace(
        q0=pri.q0.at[0].set(jnp.asarray(q_gt[0])),
        p0=pri.p0.at[0].set(jnp.asarray(p_gt[0])),
        sqrt_info=pri.sqrt_info.at[0].set(1e3 * jnp.eye(6)),
        active=pri.active.at[0].set(True))

    mesh = mh.make_hybrid_mesh()
    assert mesh.shape[mh.HOST_AXIS] == 2, mesh.shape
    out, _c0, cost = mh.solve_pgo_multihost(state, fac, pri,
                                            n_iter=n_iter, mesh=mesh)
    p_multi = jax.device_get(out.p)
    err_gt = float(np.sqrt(np.mean(np.sum((p_multi - p_gt) ** 2, -1))))

    result = {"process": pid, "rmse_vs_gt": err_gt,
              "final_cost": float(jax.device_get(cost))}
    if pid == 0:
        # serial reference on one LOCAL device (pure per-process compute)
        out_s, _c0s, _cost_s = dpgo.solve_single(state, fac, pri,
                                                 n_iter=n_iter)
        p_single = jax.device_get(out_s.p)
        result["max_abs_diff_vs_single"] = float(
            np.max(np.abs(p_multi - p_single)))
        result["rmse_single_vs_gt"] = float(
            np.sqrt(np.mean(np.sum((p_single - p_gt) ** 2, -1))))
    print("MHRESULT " + json.dumps(result), flush=True)
    return 0


def coordinator(args) -> int:
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith("JAX_")}
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "MH_N_POSES": str(args.n_poses),
            "MH_N_ITER": str(args.n_iter),
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO))
    outs = []
    rc = 0
    for p in procs:
        try:
            out, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[TIMEOUT]"
            rc = 1
        outs.append(out)
        rc |= p.returncode if p.returncode is not None else 1

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MHRESULT "):
                r = json.loads(line[len("MHRESULT "):])
                results[r["process"]] = r
    ok = (rc == 0 and len(results) == 2
          and results[0]["max_abs_diff_vs_single"] < 1e-4
          and results[0]["rmse_vs_gt"] < 0.02
          and abs(results[0]["final_cost"] - results[1]["final_cost"])
          <= 1e-6 * max(1.0, abs(results[0]["final_cost"])))
    print(json.dumps({"ok": ok, "results": results}, indent=2))
    if not ok:
        for i, out in enumerate(outs):
            sys.stderr.write(f"--- worker {i} output ---\n{out[-3000:]}\n")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--n-poses", type=int, default=64)
    ap.add_argument("--n-iter", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.worker:
        return worker()
    return coordinator(args)


if __name__ == "__main__":
    sys.exit(main())
