"""Scan registration strategies producing factor-graph measurements.

Re-implements the reference's scan_registration library (SURVEY.md §2.4):
  * ScanToMapLoamRegistration (bs_models/src/lib/scan_registration/
    scan_to_map_registration.cpp): register each scan against the rolling
    RegistrationMap, chain a relative-pose factor to the previous scan pose
    (measured in the lidar frame → with-extrinsics factor), first-scan prior.
  * MultiScanRegistration (multi_scan_registration.cpp): register the new
    scan against each of the last N reference scans, one relative factor per
    successful match.
  * RegistrationValidation (registration_validation.cpp): sanity gates on the
    registration result vs the initial estimate.

All heavy math happens in the jitted LOAM kernel
(:mod:`beam_slam_tpu.lidar.registration`); this module is thin host
orchestration emitting :class:`~beam_slam_tpu.solver.smoother.Transaction`
entries.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional, Union

import numpy as np

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar import matchers as gm
from beam_slam_tpu.lidar import registration as reg
from beam_slam_tpu.lidar.cloud import FeatureCloud, RingGrid
from beam_slam_tpu.lidar.registration_map import RegistrationMap
from beam_slam_tpu.solver.smoother import Transaction

LIDAR_SENSOR = "lidar"


@dataclasses.dataclass
class ScanRegistrationParams:
    """Mirrors ScanRegistrationParamsBase (scan_registration_base.h:22-48)."""

    min_motion_trans_m: float = 0.0
    min_motion_rot_deg: float = 0.0
    max_motion_trans_m: float = 10.0
    fix_first_scan: bool = True
    # validation gates (RegistrationValidation): registered-vs-seed limits.
    # NOTE: the seed comes from IMU odometry anchored to the *graph*, while
    # registration is anchored to the *map*; slow graph-vs-map divergence
    # shows up here as a growing "correction" even when registration is
    # perfectly healthy — so these bounds must be generous (they only catch
    # true divergence), unlike registration-quality gates (inliers/residual)
    # which live in LoamRegistrationConfig.
    max_correction_trans_m: float = 2.0
    max_correction_rot_deg: float = 45.0
    # measurement covariance: fixed diagonal (reference 'use fixed covariance'
    # option) or derived from the GN information when None
    fixed_covariance: Optional[float] = 1e-4
    covariance_weight: float = 1.0


def _pose_delta(q_a, p_a, q_b, p_b):
    """T_A⁻¹·T_B as (dq, dp)."""
    dq = lie.quat_mul(lie.quat_conj(q_a), q_b)
    dp = lie.quat_rotate(lie.quat_conj(q_a), p_b - p_a)
    return dq, dp


def _validate(q_seed, p_seed, q_reg, p_reg, params: ScanRegistrationParams):
    dq, dp = _pose_delta(q_seed, p_seed, q_reg, p_reg)
    trans = float(np.linalg.norm(np.asarray(dp)))
    rot = float(np.rad2deg(np.linalg.norm(np.asarray(lie.so3_log(dq)))))
    return (trans < params.max_correction_trans_m
            and rot < params.max_correction_rot_deg)


def _sqrt_info_6(params: ScanRegistrationParams, information) -> np.ndarray:
    if params.fixed_covariance is not None:
        w = 1.0 / np.sqrt(params.fixed_covariance * params.covariance_weight)
        return (w * np.eye(6)).astype(np.float32)
    A = reg.sqrt_info_from_information(
        information, scale=1.0 / params.covariance_weight)
    return np.asarray(A, np.float32)


class ScanToMapLoamRegistration:
    """Register scans against the rolling local map; emit chained relative
    pose factors (scan_to_map_registration.cpp:23-92).

    Frames: seeds and priors are **baselink** poses (ScanPose stores the pose
    baselink→reference, scan_pose.h:21); registration itself runs in the
    lidar frame through the T_BASELINK_LIDAR extrinsic, and the emitted
    relative factor is measured in the lidar frame (with-extrinsics factor).
    """

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(),
                 map_size: int = 10, q_bl=None, p_bl=None,
                 downsample_voxel: float = 0.0):
        self.params = params
        self.reg_cfg = reg_cfg
        # downsample_voxel mirrors the reference's downsample_voxel_size
        # (config/registration/scan_to_map.json): voxel-dedup the assembled
        # world map before the correspondence k-NN
        self.map = RegistrationMap(map_size=map_size,
                                   world_voxel=downsample_voxel)
        # T_BASELINK_LIDAR extrinsic (identity when the lidar is the baselink)
        self.q_bl = np.asarray([1.0, 0, 0, 0] if q_bl is None else q_bl,
                               np.float32)
        self.p_bl = np.asarray([0.0, 0, 0] if p_bl is None else p_bl,
                               np.float32)
        self.prev: Optional[tuple] = None  # (stamp, q, p) lidar in map frame
        self.failures = 0

    def _lidar_from_baselink(self, q_wb, p_wb):
        q = lie.quat_mul(q_wb, self.q_bl)
        p = p_wb + lie.quat_rotate(q_wb, self.p_bl)
        return q, p

    def _baselink_from_lidar(self, q_wl, p_wl):
        q_lb = lie.quat_conj(self.q_bl)
        p_lb = -lie.quat_rotate(q_lb, self.p_bl)
        q = lie.quat_mul(q_wl, q_lb)
        p = p_wl + lie.quat_rotate(q_wl, p_lb)
        return q, p

    def register_new_scan(self, stamp: float, features: FeatureCloud,
                          q_seed_bl, p_seed_bl, txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        """q_seed_bl/p_seed_bl: initial T_MAP_BASELINK estimate
        (frame-initializer). On success appends a relative-pose factor (lidar
        frame, extrinsic ``LIDAR_SENSOR``) between the previous and new
        stamps to ``txn`` and returns True; the first scan gets a prior on
        the baselink pose instead."""
        q_seed, p_seed = self._lidar_from_baselink(
            np.asarray(q_seed_bl, np.float32),
            np.asarray(p_seed_bl, np.float32))

        if self.prev is None and self.map.empty:
            self.map.add_scan(stamp, q_seed, p_seed, features)
            if self.params.fix_first_scan:
                # near-perfect prior (1e-9 covariance,
                # scan_registration_base.cpp) on the *baselink* pose;
                # sqrt-info 1/√cov ≈ 3.2e4 stays inside f32 dynamic range
                txn.add_abs_pose(stamp, np.asarray(q_seed_bl, np.float32),
                                 np.asarray(p_seed_bl, np.float32),
                                 (1.0 / np.sqrt(1e-9))
                                 * np.eye(6, dtype=np.float32))
            self.prev = (stamp, q_seed, p_seed)
            return True

        # motion gating vs previous registered pose
        if self.prev is not None:
            _, q_prev, p_prev = self.prev
            dq, dp = _pose_delta(q_prev, p_prev, q_seed, p_seed)
            trans = float(np.linalg.norm(np.asarray(dp)))
            rot_deg = float(np.rad2deg(np.linalg.norm(
                np.asarray(lie.so3_log(dq)))))
            if trans > self.params.max_motion_trans_m:
                self.failures += 1
                return False
            if (self.params.min_motion_trans_m > 0
                    or self.params.min_motion_rot_deg > 0):
                if (trans < self.params.min_motion_trans_m
                        and rot_deg < self.params.min_motion_rot_deg):
                    return False  # too little motion: skip (not a failure)

        me, mev, ms, msv = self.map.world_frame()
        result = reg.register_loam(features, me, mev, ms, msv,
                                   q_seed, p_seed, self.reg_cfg)
        # ONE batched device->host pull for everything the host needs: each
        # scalar bool()/np.asarray() on a device value is its own blocking
        # round trip
        q_reg, p_reg, information, converged = jax.device_get(
            (result.q, result.p, result.information, result.converged))
        if not bool(converged) or not _validate(
                q_seed, p_seed, q_reg, p_reg, self.params):
            self.failures += 1
            return False
        self.failures = 0

        prev_stamp, q_prev, p_prev = self.prev
        dq, dp = _pose_delta(q_prev, p_prev, q_reg, p_reg)
        txn.add_relative_pose(
            prev_stamp, stamp, np.asarray(dq), np.asarray(dp),
            _sqrt_info_6(self.params, information),
            sensor=LIDAR_SENSOR)

        self.map.add_scan(stamp, q_reg, p_reg, features)
        self.prev = (stamp, q_reg, p_reg)
        return True


@functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("reg_cfg", "max_corr_trans", "max_corr_rot_rad",
                     "max_motion_trans", "world_voxel", "we_cap", "ws_cap"))
def _pipelined_step(state, fc: FeatureCloud, q_seed, p_seed, *,
                    reg_cfg, max_corr_trans, max_corr_rot_rad,
                    max_motion_trans, world_voxel, we_cap, ws_cap):
    """ONE fused device step: assemble world map → register → validate →
    conditional map insert. Everything the sync path does with 2 blocking
    host round trips per scan (register pull + map add pull) runs on device;
    the caller harvests the small result tuple asynchronously."""
    from beam_slam_tpu.lidar import device_map as dmap

    me, mev, ms, msv = dmap.assemble_world_traced(
        state, world_voxel, we_cap, ws_cap)
    res = reg.register_loam(fc, me, mev, ms, msv, q_seed, p_seed, reg_cfg)
    # RegistrationValidation vs the seed (scan_registration_base params)
    dq_c = lie.quat_mul(lie.quat_conj(q_seed), res.q)
    dp_c = lie.quat_rotate(lie.quat_conj(q_seed), res.p - p_seed)
    corr_ok = ((jnp.linalg.norm(dp_c) < max_corr_trans)
               & (jnp.linalg.norm(lie.so3_log(dq_c)) < max_corr_rot_rad))
    # motion gate: seed vs previous registered pose (max_motion_trans_m)
    dp_m = lie.quat_rotate(lie.quat_conj(state.prev_q),
                           p_seed - state.prev_p)
    motion_ok = jnp.linalg.norm(dp_m) <= max_motion_trans
    ok = res.converged & corr_ok & motion_ok
    # chained relative factor: prev registered pose → this registered pose
    dq = lie.quat_mul(lie.quat_conj(state.prev_q), res.q)
    dp = lie.quat_rotate(lie.quat_conj(state.prev_q), res.p - state.prev_p)
    new_state = dmap.add_scan_traced(state, fc, res.q, res.p, enable=ok)
    return new_state, (res.q, res.p, dq, dp, res.information, ok)


class PipelinedScanToMapRegistration:
    """ScanToMapLoamRegistration with a device-resident map and a 1-deep
    async pipeline: scan k's registration result is harvested (and its
    relative-pose factor emitted) when scan k+1 arrives, so the per-scan
    path has ZERO blocking host↔device round trips in steady state.

    Same factor semantics as the sync strategy (chained relative poses in
    the lidar frame, first-scan prior — scan_to_map_registration.cpp:23-92);
    the only behavioral difference is one scan of factor latency, the async
    analog of the reference's decoupled registration/optimizer threads.
    """

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(),
                 map_size: int = 10, q_bl=None, p_bl=None,
                 downsample_voxel: float = 0.0, depth: int = 1,
                 edge_cap: int = 2112, surf_cap: int = 4096):
        from beam_slam_tpu.lidar import device_map as dmap
        self.params = params
        self.reg_cfg = reg_cfg
        self.map_size = map_size
        self.depth = max(1, depth)
        self.world_voxel = float(downsample_voxel)
        self.we_cap = max(map_size * edge_cap // 2, 1024)
        self.ws_cap = max(map_size * surf_cap // 2, 1024)
        self.state = dmap.init_device_map(map_size, edge_cap, surf_cap)
        self.q_bl = np.asarray([1.0, 0, 0, 0] if q_bl is None else q_bl,
                               np.float32)
        self.p_bl = np.asarray([0.0, 0, 0] if p_bl is None else p_bl,
                               np.float32)
        # host mirrors (device decides; host follows one harvest later)
        self.slot_stamps = np.full(map_size, np.nan)
        self._next_slot = 0
        self.last_ok_stamp: Optional[float] = None
        self.prev: Optional[tuple] = None  # (stamp, q, p) after harvest
        self.pending: list = []            # [(stamp, out_tuple), ...] FIFO
        self.failures = 0
        self.map = self  # update_pose/empty adapter for LidarOdometry

    # -- map-adapter surface (subset of RegistrationMap) --------------------
    @property
    def empty(self) -> bool:
        return self.last_ok_stamp is None

    def update_pose(self, stamp: float, q, p) -> bool:
        from beam_slam_tpu.lidar import device_map as dmap
        hit = np.where(np.isclose(self.slot_stamps, stamp, atol=1e-9))[0]
        if len(hit) == 0:
            return False
        self.state = dmap.update_pose_device(
            self.state, int(hit[0]), np.asarray(q, np.float32),
            np.asarray(p, np.float32))
        return True

    def world_frame(self):
        """Assembled world-frame map as device arrays (same contract as
        RegistrationMap.world_frame; used by consumers like LidarTracker)."""
        from beam_slam_tpu.lidar import device_map as dmap
        return dmap.assemble_world(
            self.state, self.world_voxel, self.we_cap, self.ws_cap)

    def adopt_host_map(self, host_map: RegistrationMap, prev=None):
        """Carry an init-phase host map over onto the device
        (SLAMInitialization::UpdateRegistrationMap analog)."""
        from beam_slam_tpu.lidar import device_map as dmap
        pq = pp = None
        if prev is not None:
            _, pq, pp = prev
        self.state = dmap.from_host_map(host_map, pq, pp)
        self.slot_stamps = host_map.stamps.copy()
        self._next_slot = host_map._next
        if prev is not None:
            self.prev = prev
            self.last_ok_stamp = prev[0]

    # -- registration --------------------------------------------------------
    def _lidar_from_baselink(self, q_wb, p_wb):
        q = lie.quat_mul(q_wb, self.q_bl)
        p = p_wb + lie.quat_rotate(q_wb, self.p_bl)
        return q, p

    def _harvest(self, txn: Transaction, block: bool):
        """Emit factors for finished pipeline entries (FIFO). ``block``
        forces the oldest entry to completion (backpressure/flush)."""
        while self.pending:
            stamp, out = self.pending[0]
            if not block and not all(
                    x.is_ready() for x in jax.tree_util.tree_leaves(out)):
                return
            q_reg, p_reg, dq, dp, information, ok = jax.device_get(out)
            self.pending.pop(0)
            block = False  # only force the oldest
            if not bool(ok):
                self.failures += 1
                continue
            self.failures = 0
            txn.add_relative_pose(
                self.last_ok_stamp, stamp, np.asarray(dq), np.asarray(dp),
                _sqrt_info_6(self.params, information), sensor=LIDAR_SENSOR)
            self.last_ok_stamp = stamp
            self.prev = (stamp, q_reg, p_reg)
            self.slot_stamps[self._next_slot] = stamp
            self._next_slot = (self._next_slot + 1) % self.map_size

    def flush_pending(self, txn: Transaction):
        """Block-harvest everything in flight (session shutdown)."""
        while self.pending:
            self._harvest(txn, block=True)

    def register_new_scan(self, stamp: float, features: FeatureCloud,
                          q_seed_bl, p_seed_bl, txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        from beam_slam_tpu.lidar import device_map as dmap
        q_seed, p_seed = self._lidar_from_baselink(
            np.asarray(q_seed_bl, np.float32),
            np.asarray(p_seed_bl, np.float32))

        if self.last_ok_stamp is None and not self.pending:
            # first scan: seed the map, optional near-perfect prior on the
            # baselink pose (scan_registration_base.cpp fix_first_scan)
            self.state = dmap.add_scan(self.state, features,
                                       jnp.asarray(q_seed),
                                       jnp.asarray(p_seed))
            if self.params.fix_first_scan:
                txn.add_abs_pose(stamp, np.asarray(q_seed_bl, np.float32),
                                 np.asarray(p_seed_bl, np.float32),
                                 (1.0 / np.sqrt(1e-9))
                                 * np.eye(6, dtype=np.float32))
            self.last_ok_stamp = stamp
            self.prev = (stamp, np.asarray(q_seed), np.asarray(p_seed))
            self.slot_stamps[self._next_slot] = stamp
            self._next_slot = (self._next_slot + 1) % self.map_size
            return True

        # backpressure: bound in-flight work, then opportunistic harvest
        self._harvest(txn, block=len(self.pending) >= self.depth)

        self.state, out = _pipelined_step(
            self.state, features, jnp.asarray(q_seed), jnp.asarray(p_seed),
            reg_cfg=self.reg_cfg,
            max_corr_trans=float(self.params.max_correction_trans_m),
            max_corr_rot_rad=float(np.deg2rad(
                self.params.max_correction_rot_deg)),
            max_motion_trans=float(self.params.max_motion_trans_m),
            world_voxel=self.world_voxel, we_cap=self.we_cap,
            ws_cap=self.ws_cap)
        for leaf in jax.tree_util.tree_leaves(out):
            leaf.copy_to_host_async()
        self.pending.append((stamp, out))
        return True


class MultiScanLoamRegistration:
    """Register the new scan against each of the last ``num_neighbors``
    reference scans; one relative factor per match
    (multi_scan_registration.cpp)."""

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 reg_cfg: reg.LoamRegistrationConfig = reg.LoamRegistrationConfig(),
                 num_neighbors: int = 3, lag_duration: float = 10.0,
                 q_bl=None, p_bl=None):
        self.params = params
        self.reg_cfg = reg_cfg
        self.num_neighbors = num_neighbors
        self.lag_duration = lag_duration
        self.q_bl = np.asarray([1.0, 0, 0, 0] if q_bl is None else q_bl,
                               np.float32)
        self.p_bl = np.asarray([0.0, 0, 0] if p_bl is None else p_bl,
                               np.float32)
        self.refs: list = []  # (stamp, q, p, features) newest-last
        self.failures = 0

    def register_new_scan(self, stamp: float, features: FeatureCloud,
                          q_seed_bl, p_seed_bl, txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        """Seeds are baselink poses (same frame conventions as
        ScanToMapLoamRegistration)."""
        q_wb = jnp.asarray(q_seed_bl, jnp.float32)
        p_wb = jnp.asarray(p_seed_bl, jnp.float32)
        q_seed = lie.quat_mul(q_wb, self.q_bl)
        p_seed = p_wb + lie.quat_rotate(q_wb, self.p_bl)
        # prune by lag
        self.refs = [r for r in self.refs
                     if stamp - r[0] <= self.lag_duration]

        if not self.refs:
            if self.params.fix_first_scan:
                # prior on the baselink pose (ScanPose frame convention)
                txn.add_abs_pose(stamp, np.asarray(q_wb), np.asarray(p_wb),
                                 (1.0 / np.sqrt(1e-9))
                                 * np.eye(6, dtype=np.float32))
            self.refs.append((stamp, q_seed, p_seed, features))
            return True

        n_ok = 0
        q_reg, p_reg = q_seed, p_seed
        for (r_stamp, r_q, r_p, r_feat) in self.refs[-self.num_neighbors:]:
            ref_world = r_feat.transform(r_q, r_p)
            me = ref_world.edge_strong
            mev = r_feat.edge_strong_valid
            me = jnp.concatenate([me, ref_world.edge_weak])
            mev = jnp.concatenate([mev, r_feat.edge_weak_valid])
            ms = jnp.concatenate([ref_world.surf_strong, ref_world.surf_weak])
            msv = jnp.concatenate([r_feat.surf_strong_valid,
                                   r_feat.surf_weak_valid])
            result = reg.register_loam(features, me, mev, ms, msv,
                                       q_seed, p_seed, self.reg_cfg)
            if not bool(result.converged) or not _validate(
                    q_seed, p_seed, result.q, result.p, self.params):
                continue
            dq, dp = _pose_delta(r_q, r_p, result.q, result.p)
            txn.add_relative_pose(
                r_stamp, stamp, np.asarray(dq), np.asarray(dp),
                _sqrt_info_6(self.params, result.information),
                sensor=LIDAR_SENSOR)
            q_reg, p_reg = result.q, result.p
            n_ok += 1

        if n_ok == 0:
            self.failures += 1
            return False
        self.failures = 0
        self.refs.append((stamp, q_reg, p_reg, features))
        return True


# ---------------------------------------------------------------------------
# Generic-matcher multi-scan registration (ICP / GICP / NDT)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("kind", "cfg"))
def _run_matcher(kind: str, src, sv, tgt, tv, q0, p0,
                 cfg: gm.MatcherConfig):
    if kind == "ICP":
        return gm.icp_point_to_point(src, sv, tgt, tv, q0, p0, cfg)
    if kind == "GICP":
        return gm.gicp_point_to_plane(src, sv, tgt, tv, q0, p0, cfg)
    if kind == "NDT":
        return gm.ndt_voxel_gaussian(src, sv, tgt, tv, q0, p0, cfg)
    raise ValueError(kind)


def raw_points_from_grid(grid: RingGrid, max_points: int = 4096,
                         voxel: float = 0.2):
    """Host-side: valid grid points → voxel-downsampled fixed-capacity cloud
    (pts [max_points, 3], valid [max_points])."""
    pts = np.asarray(grid.xyz).reshape(-1, 3)
    ok = np.asarray(grid.valid).reshape(-1)
    pts = pts[ok]
    if len(pts) and voxel > 0:
        cells = np.floor(pts / voxel).astype(np.int64)
        _, first = np.unique(
            cells[:, 0] * 73856093 + cells[:, 1] * 19349663
            + cells[:, 2] * 83492791, return_index=True)
        pts = pts[np.sort(first)]
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    out = np.zeros((max_points, 3), np.float32)
    valid = np.zeros(max_points, bool)
    out[:len(pts)] = pts
    valid[:len(pts)] = True
    return jnp.asarray(out), jnp.asarray(valid)


class MultiScanMatcherRegistration:
    """MultiScanRegistration with a generic matcher (ICP | GICP | NDT) on
    raw downsampled clouds — the reference's non-LOAM variants
    (multi_scan_registration.cpp + beam_matching Matchers.h; selected by the
    ``matcher_type`` of the matcher JSON, scan_registration_base.cpp:75-97).

    Same frame conventions and factor emission as MultiScanLoamRegistration;
    requires the raw scan (``grid=``) in register_new_scan.
    """

    def __init__(self, params: ScanRegistrationParams = ScanRegistrationParams(),
                 matcher_type: str = "ICP",
                 matcher_cfg: gm.MatcherConfig = gm.MatcherConfig(),
                 num_neighbors: int = 3, lag_duration: float = 10.0,
                 max_points: int = 4096, downsample_voxel: float = 0.2,
                 q_bl=None, p_bl=None):
        assert matcher_type in ("ICP", "GICP", "NDT"), matcher_type
        self.params = params
        self.matcher_type = matcher_type
        self.matcher_cfg = matcher_cfg
        self.num_neighbors = num_neighbors
        self.lag_duration = lag_duration
        self.max_points = max_points
        self.downsample_voxel = downsample_voxel
        self.q_bl = np.asarray([1.0, 0, 0, 0] if q_bl is None else q_bl,
                               np.float32)
        self.p_bl = np.asarray([0.0, 0, 0] if p_bl is None else p_bl,
                               np.float32)
        self.refs: list = []  # (stamp, q, p, pts, valid) newest-last
        self.failures = 0

    def register_new_scan(self, stamp: float, features, q_seed_bl, p_seed_bl,
                          txn: Transaction,
                          grid: Optional[RingGrid] = None) -> bool:
        assert grid is not None, "matcher registration needs the raw scan"
        q_wb = jnp.asarray(q_seed_bl, jnp.float32)
        p_wb = jnp.asarray(p_seed_bl, jnp.float32)
        q_seed = lie.quat_mul(q_wb, self.q_bl)
        p_seed = p_wb + lie.quat_rotate(q_wb, self.p_bl)
        pts, valid = raw_points_from_grid(grid, self.max_points,
                                          self.downsample_voxel)
        self.refs = [r for r in self.refs
                     if stamp - r[0] <= self.lag_duration]

        if not self.refs:
            if self.params.fix_first_scan:
                txn.add_abs_pose(stamp, np.asarray(q_wb), np.asarray(p_wb),
                                 (1.0 / np.sqrt(1e-9))
                                 * np.eye(6, dtype=np.float32))
            self.refs.append((stamp, q_seed, p_seed, pts, valid))
            return True

        n_ok = 0
        q_reg, p_reg = q_seed, p_seed
        for (r_stamp, r_q, r_p, r_pts, r_valid) in \
                self.refs[-self.num_neighbors:]:
            tgt = lie.quat_rotate(r_q[None, :], r_pts) + r_p[None, :]
            result = _run_matcher(self.matcher_type, pts, valid, tgt,
                                  r_valid, q_seed, p_seed, self.matcher_cfg)
            if not bool(result.converged) or not _validate(
                    q_seed, p_seed, result.q, result.p, self.params):
                continue
            dq, dp = _pose_delta(r_q, r_p, result.q, result.p)
            txn.add_relative_pose(
                r_stamp, stamp, np.asarray(dq), np.asarray(dp),
                _sqrt_info_6(self.params, result.information),
                sensor=LIDAR_SENSOR)
            q_reg, p_reg = result.q, result.p
            n_ok += 1

        if n_ok == 0:
            self.failures += 1
            return False
        self.failures = 0
        self.refs.append((stamp, q_reg, p_reg, pts, valid))
        return True


# ---------------------------------------------------------------------------
# Config factory (scan_registration_base.cpp:40-97 Create)
# ---------------------------------------------------------------------------


def _load_json(source: Union[str, dict], config_root: Optional[str]) -> dict:
    if isinstance(source, dict):
        return source
    path = source
    if config_root is not None and not os.path.isabs(path):
        path = os.path.join(config_root, path)
    with open(path) as f:
        return json.load(f)


def _base_params(rcfg: dict) -> ScanRegistrationParams:
    return ScanRegistrationParams(
        min_motion_trans_m=float(rcfg.get("min_motion_trans_m", 0.0)),
        min_motion_rot_deg=float(rcfg.get("min_motion_rot_deg", 0.0)),
        max_motion_trans_m=float(rcfg.get("max_motion_trans_m", 10.0)),
        fix_first_scan=bool(rcfg.get("fix_first_scan", True)))


def loam_feature_config(mcfg: dict) -> "object":
    """LOAM matcher JSON → feature-extraction config (same keys as
    matchers/loam_vlp16.json where the concept carries over)."""
    from beam_slam_tpu.lidar import features as feat
    return feat.LoamConfig(
        n_sectors=int(mcfg.get("n_feature_regions", 6)),
        neighbors=int(mcfg.get("curvature_region", 5)),
        edge_strong_per_sector=int(mcfg.get("max_corner_sharp", 2)),
        edge_weak_per_sector=int(mcfg.get("max_corner_less_sharp", 20)),
        surf_strong_per_sector=int(mcfg.get("max_surface_flat", 4)),
        edge_curvature_min=float(
            mcfg.get("surface_curvature_threshold", 0.1)),
        surf_curvature_max=float(
            mcfg.get("surface_curvature_threshold", 0.1)))


def create_scan_registration(registration_config: Union[str, dict],
                             matcher_config: Union[str, dict],
                             config_root: Optional[str] = None,
                             q_bl=None, p_bl=None):
    """Factory mirroring ``ScanRegistrationBase::Create``
    (scan_registration_base.cpp:40-97): selects the registration strategy
    from ``registration_type`` (SCANTOMAP | MULTISCAN) × the matcher from
    ``matcher_type`` (LOAM | ICP | GICP | NDT). JSON schemas follow
    beam_slam_launch/config/{registration,matchers}/*.json.

    Returns (strategy, loam_feature_cfg_or_None).
    """
    rcfg = _load_json(registration_config, config_root)
    mcfg = _load_json(matcher_config, config_root)
    rtype = rcfg["registration_type"].upper()
    mtype = mcfg["matcher_type"].upper()
    params = _base_params(rcfg)

    if mtype == "LOAM":
        # max_correspondence_iterations scales the GN budget (libbeam
        # LoamMatcher's refit count), but every GN step refits its
        # correspondences: >1 fixed-correspondence steps overshoot stale
        # matches into false minima on this engine's fixed-step GN (see
        # LoamRegistrationConfig.corr_refits; round-3 replay-LIO
        # regression). The +3 floor keeps small configured counts usable
        # as seeds-from-IMU warm paths.
        mc_iters = max(int(mcfg.get("max_correspondence_iterations", 5)), 1)
        if not mcfg.get("iterate_correspondences", True):
            mc_iters = 1
        reg_cfg = reg.LoamRegistrationConfig(
            iterations=mc_iters + 3,
            corr_refits=0,
            max_corr_dist=float(
                mcfg.get("max_correspondence_distance", 0.5)),
            min_inliers=int(mcfg.get("min_number_measurements", 30)))
        feat_cfg = loam_feature_config(mcfg)
        if rtype == "SCANTOMAP":
            return ScanToMapLoamRegistration(
                params, reg_cfg, map_size=int(rcfg.get("map_size", 10)),
                q_bl=q_bl, p_bl=p_bl,
                downsample_voxel=float(
                    rcfg.get("downsample_voxel_size", 0.0))), feat_cfg
        if rtype == "MULTISCAN":
            return MultiScanLoamRegistration(
                params, reg_cfg,
                num_neighbors=int(rcfg.get("num_neighbors", 3)),
                lag_duration=float(rcfg.get("lag_duration", 10.0)),
                q_bl=q_bl, p_bl=p_bl), feat_cfg
        raise ValueError(f"registration type {rtype} not implemented")

    if rtype != "MULTISCAN":
        # reference: non-LOAM matchers only exist for MULTISCAN
        # (scan_registration_base.cpp:75: "only multi scan is implemented")
        raise ValueError(f"{rtype} with matcher {mtype} not implemented")

    if mtype == "ICP":
        mc = gm.MatcherConfig(
            iterations=min(int(mcfg.get("max_iter", 50)), 20),
            max_corr_dist=float(mcfg.get("max_corr", 1.0)))
        voxel = float(mcfg.get("res", 0.0)) or 0.2
    elif mtype == "GICP":
        mc = gm.MatcherConfig(
            iterations=min(int(mcfg.get("max_iter", 100)), 20),
            k_normal=max(int(mcfg.get("corr_rand", 10)), 4),
            max_corr_dist=float(mcfg.get("max_corr", 1.0)))
        voxel = float(mcfg.get("res", 0.1)) or 0.2
    elif mtype == "NDT":
        mc = gm.MatcherConfig(
            iterations=min(int(mcfg.get("max_iter", 100)), 20),
            max_corr_dist=float(mcfg.get("res", 1.0)))
        voxel = max(float(mcfg.get("min_res", 0.05)), 0.05)
    else:
        raise ValueError(f"unknown matcher_type {mtype}")
    return MultiScanMatcherRegistration(
        params, matcher_type=mtype, matcher_cfg=mc,
        num_neighbors=int(rcfg.get("num_neighbors", 3)),
        lag_duration=float(rcfg.get("lag_duration", 10.0)),
        downsample_voxel=voxel, q_bl=q_bl, p_bl=p_bl), None
