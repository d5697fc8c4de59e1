"""Device-resident pipelined scan-to-map registration tests.

Covers the round-3 gap (`lidar/device_map.py` + PipelinedScanToMapRegistration
landed untested): the pipelined strategy must preserve the reference's
scan-to-map behavior (chained relative factors, first-scan prior, rolling
``map_size`` eviction, graph-update pose rewrites — bs_models/src/lib/
scan_registration/scan_to_map_registration.cpp:23-92 and
registration_map.h UpdateScanPosesFromGraphMsg/CorrectMapDriftFromGraphMsg),
with the only behavioral delta being one scan of factor latency.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar import features as feat
from beam_slam_tpu.lidar import device_map as dmap
from beam_slam_tpu.lidar.cloud import synthetic_structured_scene
from beam_slam_tpu.lidar.registration_map import RegistrationMap
from beam_slam_tpu.lidar.scan_registration import (
    PipelinedScanToMapRegistration, ScanRegistrationParams,
    ScanToMapLoamRegistration)
from beam_slam_tpu.solver.smoother import Transaction


def _scene():
    return synthetic_structured_scene(n_rings=16, width=504)


def _features_at(q, p):
    """Scene observed from pose (q, p): scan-frame points T⁻¹·world."""
    grid = _scene()
    xyz = lie.quat_rotate(lie.quat_conj(q)[None, None], grid.xyz - p)
    xyz = jnp.where(grid.valid[..., None], xyz, 0.0)
    return feat.extract_features(grid._replace(xyz=xyz))


POSES = [
    (lie.quat_identity(), jnp.zeros(3, jnp.float32)),
    (lie.so3_exp_quat(jnp.asarray([0, 0, 0.05], jnp.float32)),
     jnp.asarray([0.3, 0.0, 0.0], jnp.float32)),
    (lie.so3_exp_quat(jnp.asarray([0, 0, 0.1], jnp.float32)),
     jnp.asarray([0.6, 0.1, 0.0], jnp.float32)),
    (lie.so3_exp_quat(jnp.asarray([0.01, 0, 0.15], jnp.float32)),
     jnp.asarray([0.9, 0.25, 0.05], jnp.float32)),
    (lie.so3_exp_quat(jnp.asarray([0.02, -0.01, 0.2], jnp.float32)),
     jnp.asarray([1.2, 0.4, 0.1], jnp.float32)),
]

SEED_PERT = [
    (np.zeros(3), np.zeros(3)),
    (np.array([0.01, -0.01, 0.02]), np.array([0.05, -0.04, 0.02])),
    (np.array([-0.015, 0.01, -0.01]), np.array([-0.04, 0.06, -0.03])),
    (np.array([0.02, 0.005, 0.015]), np.array([0.03, 0.05, 0.04])),
    (np.array([-0.01, -0.02, 0.01]), np.array([-0.05, 0.02, -0.02])),
]


def _seed(i):
    q, p = POSES[i]
    dr, dt = SEED_PERT[i]
    q_s = lie.quat_mul(q, lie.so3_exp_quat(jnp.asarray(dr, jnp.float32)))
    p_s = p + jnp.asarray(dt, jnp.float32)
    return np.asarray(q_s, np.float32), np.asarray(p_s, np.float32)


def _run_strategy(strategy):
    """Feed the pose sequence; return the flat factor list after flush."""
    rels, abss = [], []
    for i in range(len(POSES)):
        fc = _features_at(*POSES[i])
        q_s, p_s = _seed(i)
        txn = Transaction(stamp=float(i) * 0.5)
        ok = strategy.register_new_scan(float(i) * 0.5, fc, q_s, p_s, txn)
        assert ok, f"scan {i} failed"
        rels.extend(txn.rel_poses)
        abss.extend(txn.abs_poses)
    if hasattr(strategy, "flush_pending"):
        txn = Transaction(stamp=99.0)
        strategy.flush_pending(txn)
        rels.extend(txn.rel_poses)
        abss.extend(txn.abs_poses)
    return rels, abss


def test_pipelined_matches_host_path():
    """Parity: the pipelined device-map strategy must emit the same chained
    relative factors as the synchronous host-map strategy (same scans, same
    seeds), one scan late."""
    sync = ScanToMapLoamRegistration(ScanRegistrationParams(), map_size=5)
    pipe = PipelinedScanToMapRegistration(ScanRegistrationParams(),
                                          map_size=5)
    rel_s, abs_s = _run_strategy(sync)
    rel_p, abs_p = _run_strategy(pipe)

    assert len(abs_s) == len(abs_p) == 1   # first-scan prior from both
    assert len(rel_s) == len(rel_p) == len(POSES) - 1
    for fs, fp in zip(rel_s, rel_p):
        assert fs.stamp_i == fp.stamp_i and fs.stamp_j == fp.stamp_j
        assert fs.sensor == fp.sensor == "lidar"
        # identical math modulo fused-kernel reassociation
        assert np.linalg.norm(np.asarray(fs.dp) - np.asarray(fp.dp)) < 2e-3
        dq = lie.quat_mul(lie.quat_conj(jnp.asarray(fs.dq)),
                          jnp.asarray(fp.dq))
        assert float(jnp.linalg.norm(lie.so3_log(dq))) < 2e-3


def test_pipelined_factors_match_ground_truth():
    """The emitted deltas must recover the ground-truth relative poses from
    perturbed seeds (the reference's perturbed-registration pattern)."""
    pipe = PipelinedScanToMapRegistration(ScanRegistrationParams(),
                                          map_size=5)
    rels, _ = _run_strategy(pipe)
    for i, f in enumerate(rels):
        q_a, p_a = POSES[i]
        q_b, p_b = POSES[i + 1]
        dq_gt = lie.quat_mul(lie.quat_conj(q_a), q_b)
        dp_gt = lie.quat_rotate(lie.quat_conj(q_a), p_b - p_a)
        assert np.linalg.norm(np.asarray(f.dp) - np.asarray(dp_gt)) < 0.03
        dth = lie.so3_log(lie.quat_mul(lie.quat_conj(jnp.asarray(f.dq)),
                                       dq_gt))
        assert float(jnp.linalg.norm(dth)) < 0.02


def test_pipelined_flush_semantics():
    """With a deep pipeline nothing blocks; factors still in flight at
    session end must all surface through flush_pending, in order."""
    pipe = PipelinedScanToMapRegistration(ScanRegistrationParams(),
                                          map_size=5, depth=8)
    inline_rels = []
    for i in range(len(POSES)):
        fc = _features_at(*POSES[i])
        q_s, p_s = _seed(i)
        txn = Transaction(stamp=float(i) * 0.5)
        assert pipe.register_new_scan(float(i) * 0.5, fc, q_s, p_s, txn)
        inline_rels.extend(txn.rel_poses)
    # depth=8 > n_scans: at most opportunistic harvests happened
    txn = Transaction(stamp=99.0)
    pipe.flush_pending(txn)
    assert not pipe.pending
    total = inline_rels + list(txn.rel_poses)
    assert len(total) == len(POSES) - 1
    stamps = [(f.stamp_i, f.stamp_j) for f in total]
    assert stamps == [(i * 0.5, (i + 1) * 0.5) for i in range(len(POSES) - 1)]


def test_pipelined_adopt_host_map():
    """Init-phase host map carried onto the device
    (SLAMInitialization::UpdateRegistrationMap analog): registration against
    the adopted map must succeed and chain from the provided prev pose."""
    host = RegistrationMap(map_size=5)
    for i in range(3):
        q, p = POSES[i]
        host.add_scan(float(i) * 0.5, np.asarray(q), np.asarray(p),
                      _features_at(q, p))
    pipe = PipelinedScanToMapRegistration(ScanRegistrationParams(),
                                          map_size=5)
    prev = (1.0, np.asarray(POSES[2][0], np.float32),
            np.asarray(POSES[2][1], np.float32))
    pipe.adopt_host_map(host, prev=prev)
    assert not pipe.empty
    assert pipe.last_ok_stamp == 1.0

    fc = _features_at(*POSES[3])
    q_s, p_s = _seed(3)
    txn = Transaction(stamp=1.5)
    assert pipe.register_new_scan(1.5, fc, q_s, p_s, txn)
    flush = Transaction(stamp=99.0)
    pipe.flush_pending(flush)
    rels = list(txn.rel_poses) + list(flush.rel_poses)
    assert len(rels) == 1
    f = rels[0]
    assert (f.stamp_i, f.stamp_j) == (1.0, 1.5)
    q_a, p_a = POSES[2]
    q_b, p_b = POSES[3]
    dp_gt = lie.quat_rotate(lie.quat_conj(q_a), p_b - p_a)
    assert np.linalg.norm(np.asarray(f.dp) - np.asarray(dp_gt)) < 0.03


def test_pipelined_update_pose_rewrites_device_slot():
    """Graph-update pose rewrite (UpdateScanPosesFromGraphMsg): moving a
    scan's map pose must move its world-frame points."""
    pipe = PipelinedScanToMapRegistration(ScanRegistrationParams(),
                                          map_size=3)
    fc = _features_at(*POSES[0])
    txn = Transaction(stamp=0.0)
    assert pipe.register_new_scan(0.0, fc, *(_seed(0)), txn)
    e0, ev0, _, _ = [np.asarray(x) for x in pipe.world_frame()]

    shift = np.array([5.0, 0.0, 0.0], np.float32)
    assert pipe.update_pose(0.0, np.array([1, 0, 0, 0], np.float32), shift)
    assert not pipe.update_pose(77.0, np.array([1, 0, 0, 0], np.float32),
                                shift)  # unknown stamp → False
    e1, ev1, _, _ = [np.asarray(x) for x in pipe.world_frame()]
    np.testing.assert_array_equal(ev0, ev1)
    moved = e1[ev1] - e0[ev0]
    np.testing.assert_allclose(moved, np.broadcast_to(shift, moved.shape),
                               atol=1e-5)


def test_pipelined_failed_registration_keeps_map_and_chain():
    """A scan whose seed violates the motion gate must not enter the map and
    must not break the factor chain: the next good scan chains to the last
    good stamp (the reference skips failed scans the same way)."""
    params = ScanRegistrationParams(max_motion_trans_m=0.5)
    pipe = PipelinedScanToMapRegistration(params, map_size=5)
    fc0 = _features_at(*POSES[0])
    txn = Transaction(stamp=0.0)
    assert pipe.register_new_scan(0.0, fc0, *(_seed(0)), txn)

    # scan at 1000 m violates max_motion_trans_m → device gate rejects
    fc_far = _features_at(POSES[1][0], POSES[1][1])
    q_far = np.array([1, 0, 0, 0], np.float32)
    p_far = np.array([1000.0, 0, 0], np.float32)
    txn = Transaction(stamp=0.5)
    pipe.register_new_scan(0.5, fc_far, q_far, p_far, txn)

    # good scan: must chain 0.0 → 1.0 (skipping the failed 0.5)
    fc2 = _features_at(*POSES[1])
    q_s, p_s = _seed(1)
    txn2 = Transaction(stamp=1.0)
    pipe.register_new_scan(1.0, fc2, q_s, p_s, txn2)
    flush = Transaction(stamp=99.0)
    pipe.flush_pending(flush)
    rels = (list(txn.rel_poses) + list(txn2.rel_poses)
            + list(flush.rel_poses))
    assert len(rels) == 1
    assert (rels[0].stamp_i, rels[0].stamp_j) == (0.0, 1.0)
    assert pipe.failures == 0  # reset by the subsequent success
    # device map holds exactly the two good scans
    assert int(np.asarray(pipe.state.used).sum()) == 2


def test_pipelined_ring_eviction():
    """Rolling map_size semantics: the (map_size+1)-th scan evicts slot 0."""
    pipe = PipelinedScanToMapRegistration(ScanRegistrationParams(),
                                          map_size=3)
    for i in range(5):
        fc = _features_at(*POSES[i])
        q_s, p_s = _seed(i)
        txn = Transaction(stamp=float(i) * 0.5)
        assert pipe.register_new_scan(float(i) * 0.5, fc, q_s, p_s, txn)
    pipe.flush_pending(Transaction(stamp=99.0))
    used = np.asarray(pipe.state.used)
    assert used.all()
    assert int(pipe.state.next_slot) == 5
    # slot stamps hold the 3 newest scans
    live = sorted(s for s in pipe.slot_stamps if not np.isnan(s))
    assert live == [1.0, 1.5, 2.0]


def test_device_map_correct_drift():
    """CorrectMapDriftFromGraphMsg: a rigid ΔT applied on device must move
    every world point and the chained prev pose by ΔT."""
    state = dmap.init_device_map(map_size=2, edge_cap=64, surf_cap=64)
    fc = _features_at(*POSES[0])
    state = dmap.add_scan(state, fc, jnp.asarray([1.0, 0, 0, 0]),
                          jnp.asarray([1.0, 2.0, 3.0]))
    dq = lie.so3_exp_quat(jnp.asarray([0.0, 0.0, 0.1], jnp.float32))
    dp = jnp.asarray([0.5, -0.5, 0.2], jnp.float32)
    out = dmap.correct_drift_device(state, dq, dp)
    q_exp = lie.quat_mul(dq, jnp.asarray([1.0, 0, 0, 0]))
    p_exp = lie.quat_rotate(dq, jnp.asarray([1.0, 2.0, 3.0])) + dp
    np.testing.assert_allclose(np.asarray(out.q[0]), np.asarray(q_exp),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.p[0]), np.asarray(p_exp),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.prev_p), np.asarray(p_exp),
                               atol=1e-6)


def test_local_mapper_lio_session_pipelined():
    """Full LIO session through the LocalMapper with
    ``pipelined_registration=True``: init-map adoption, pipelined factors,
    flush at session end — ATE must match the sync path's bound (the
    deployment configuration, tools/run_session.py)."""
    from beam_slam_tpu.models.slam_initialization import InitParams
    from beam_slam_tpu.pipeline.config import LocalMapperConfig
    from beam_slam_tpu.pipeline.local_mapper import LocalMapper
    from beam_slam_tpu.utils import sim
    from beam_slam_tpu.utils.evaluation import ate_rmse

    traj = sim.AnalyticTrajectory(amp_p=(0.5, 0.4, 0.1),
                                  v_drift=(0.25, 0.0, 0.0),
                                  amp_r=(0.05, 0.05, 0.1))
    imu_rate, scan_rate, T = 200.0, 5.0, 5.0
    cfg = LocalMapperConfig(
        mode="LIO", lag_duration=4.0, max_states=32,
        pipelined_registration=True,
        init=InitParams(mode="LIDAR", min_trajectory_length_m=1.0,
                        min_observability=0.1))
    mapper = LocalMapper(cfg)
    assert isinstance(mapper.lo.registration,
                      PipelinedScanToMapRegistration)

    scene = _scene()
    n = int(T * imu_rate)
    tm = (np.arange(n) + 0.5) / imu_rate
    s = traj.sample(jnp.asarray(tm, jnp.float32))
    w_b, a_b = np.asarray(s.w_body), np.asarray(s.a_body)
    scan_i = 1
    for i in range(n):
        mapper.on_imu(float(tm[i]), w_b[i], a_b[i])
        t_scan = scan_i / scan_rate
        if tm[i] >= t_scan:
            g = traj.sample(jnp.asarray([t_scan], jnp.float32))
            xyz = lie.quat_rotate(lie.quat_conj(g.q[0])[None, None],
                                  scene.xyz - g.p[0])
            xyz = jnp.where(scene.valid[..., None], xyz, 0.0)
            mapper.on_scan(round(t_scan, 6), scene._replace(xyz=xyz))
            mapper.tick()
            scan_i += 1
    mapper.flush()
    assert mapper.initialized
    stamps = mapper.smoother.current_stamps()
    assert len(stamps) >= 5
    est = np.stack([mapper.smoother.get_state(t)["p"] for t in stamps])
    gt = traj.sample(jnp.asarray(stamps, jnp.float32))
    ate = ate_rmse(est, np.asarray(gt.p), align="se3")
    assert ate < 0.05, ate
