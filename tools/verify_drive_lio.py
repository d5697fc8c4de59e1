"""Verify drive: LIO session through the public API — FixedLagSmoother +
scan-to-map LOAM registration under per-keyframe seed noise (5 cm / 0.02 rad).

Calibrated healthy bar: MAXERR (max window-state position error vs ground
truth) ≲ 0.15 m. This drive is deliberately harsh — lidar-only, no IMU,
noisy seeds; the committed code at round-2 scores ~0.09-0.13 m depending on
corr_refits/voxel settings (A/B via DRIVE_REFITS / DRIVE_VOXEL env vars).
The accuracy gauge that matters is docs/ATE.md (full-pipeline, 60 s:
LIO 1.25 cm); use this drive for smoke + relative regressions only."""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar import features as feat
from beam_slam_tpu.lidar.cloud import synthetic_structured_scene
from beam_slam_tpu.lidar.scan_registration import (ScanRegistrationParams,
                                                   ScanToMapLoamRegistration)
from beam_slam_tpu.models.inertial_odometry import InertialOdometry
from beam_slam_tpu.solver.smoother import (FixedLagSmoother, SmootherConfig,
                                           Transaction)
from beam_slam_tpu.utils import sim

rng = np.random.default_rng(3)
traj = sim.AnalyticTrajectory()
SCENE = synthetic_structured_scene(n_rings=16, width=504)

def scan_at(q_wl, p_wl):
    xyz = lie.quat_rotate(lie.quat_conj(jnp.asarray(q_wl))[None, None],
                          SCENE.xyz - jnp.asarray(p_wl))
    return feat.extract_features(SCENE._replace(
        xyz=jnp.where(SCENE.valid[..., None], xyz, 0.0)))

sm = FixedLagSmoother(SmootherConfig(lag_duration=4.0, max_states=16,
                                     max_rel_pose_factors=16))
sm.register_extrinsic("lidar", np.array([1, 0, 0, 0], np.float32),
                      np.zeros(3, np.float32))
import os as _os
from beam_slam_tpu.lidar import registration as _lreg
_refits = int(_os.environ.get("DRIVE_REFITS", "2"))
_voxel = float(_os.environ.get("DRIVE_VOXEL", "0.1"))
reg = ScanToMapLoamRegistration(
    ScanRegistrationParams(fix_first_scan=True),
    reg_cfg=_lreg.LoamRegistrationConfig(iterations=8, corr_refits=_refits),
    map_size=10, downsample_voxel=_voxel)

kf_dt = 0.5
times = np.arange(0.0, 6.0 + 1e-9, kf_dt)
gt = traj.sample(jnp.asarray(times, jnp.float32))

txn = Transaction(stamp=0.0)
txn.add_imu_state(0.0, gt.q[0], gt.p[0], gt.v[0])
txn.add_imu_prior(0.0, gt.q[0], gt.p[0], gt.v[0], np.zeros(3), np.zeros(3),
                  1e3 * np.eye(15, dtype=np.float32))
reg.register_new_scan(0.0, scan_at(gt.q[0], gt.p[0]), gt.q[0], gt.p[0], txn)
sm.send_transaction(txn)
sm.run_once()

costs = []
for i in range(1, len(times)):
    t0, t1 = float(times[i - 1]), float(times[i])
    txn = Transaction(stamp=t1)
    dp = rng.standard_normal(3).astype(np.float32) * 0.05
    dth = rng.standard_normal(3).astype(np.float32) * 0.02
    q_seed = np.asarray(lie.quat_mul(jnp.asarray(gt.q[i]),
                                     lie.so3_exp_quat(jnp.asarray(dth))))
    p_seed = np.asarray(gt.p[i]) + dp
    txn.add_imu_state(t1, q_seed, p_seed, np.asarray(gt.v[i]))
    ok = reg.register_new_scan(t1, scan_at(gt.q[i], gt.p[i]),
                               q_seed, p_seed, txn)
    sm.send_transaction(txn)
    diag = sm.run_once()
    if diag is not None:
        costs.append(float(diag.final_cost))
    assert ok, f"registration failed at t={t1}"

# final drift vs ground truth
errs = []
for i, t in enumerate(times):
    try:
        st = sm.get_state(float(t))
    except KeyError:
        continue
    errs.append(np.linalg.norm(st["p"] - np.asarray(gt.p[i])))
errs = np.asarray(errs)
print("window stamps:", len(sm.current_stamps()), "max err (m):", errs.max(),
      "costs finite:", np.isfinite(costs).all())
print("MAXERR", errs.max())
assert len(sm.current_stamps()) <= 10
print("LIO DRIVE OK")
