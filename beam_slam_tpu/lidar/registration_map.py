"""Rolling local feature map — replaces the reference's RegistrationMap
singleton (bs_models/src/lib/scan_registration/registration_map.{h,cpp}):
a ring buffer of the last ``map_size`` scans' LOAM features keyed by stamp,
each stored in its own scan frame with a map-frame pose, assembled on demand
into flat world-frame point sets for the registration kernel.

Unlike the reference singleton, this is an explicit state object threaded
through the pipeline (SURVEY.md §2.7 'Singletons → explicit state objects').
Pose updates from graph optimization (UpdateScanPosesFromGraphMsg /
CorrectMapDriftFromGraphMsg, registration_map.h) are plain pose rewrites here;
the world-frame assembly always reflects the latest poses.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar.cloud import FeatureCloud


@jax.jit
def _assemble(edges, edges_valid, surfs, surfs_valid, qs, ps, slot_used):
    """[S,Ce,3]×[S] poses → world-frame flat arrays ([S*Ce,3], mask)."""
    def tf(pts, valid):
        w = lie.quat_rotate(qs[:, None, :], pts) + ps[:, None, :]
        ok = valid & slot_used[:, None]
        return (w.reshape(-1, 3), ok.reshape(-1))
    e, ev = tf(edges, edges_valid)
    s, sv = tf(surfs, surfs_valid)
    return e, ev, s, sv


@functools.partial(jax.jit, static_argnames=("cap",))
def _voxel_dedup(pts, valid, voxel, cap: int):
    """First-point-per-voxel dedup to a fixed capacity, on device.

    The reference voxel-downsamples the assembled scan-to-map registration
    map (beam_slam_launch/config/registration/scan_to_map.json
    ``downsample_voxel_size``, applied by ScanToMapLoamRegistration) —
    overlapping scans at 10 Hz make the raw map ~S× redundant, and the
    correspondence k-NN cost is linear in map size. Static shapes: hash the
    voxel id, sort, keep the first point of each voxel (an actual surface
    sample — for correspondence *targets* as good as PCL's centroid), and
    stably compact keepers to the front of a [cap, 3] output.
    """
    big = jnp.iinfo(jnp.int32).max
    cell = jnp.floor(pts / voxel).astype(jnp.int32)
    h = ((cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663)
         ^ (cell[:, 2] * 83492791))
    h = jnp.where(valid, h, big)
    order = jnp.argsort(h)
    hs = h[order]
    first = jnp.concatenate([jnp.ones((1,), bool), hs[1:] != hs[:-1]])
    keep = first & (hs != big)
    rank = jnp.argsort(~keep)          # stable: keepers first, hash order
    sel = order[rank[:cap]]
    return pts[sel], keep[rank[:cap]]


class RegistrationMap:
    def __init__(self, map_size: int = 10, edge_cap: int = 2112,
                 surf_cap: int = 4096, world_voxel: float = 0.0,
                 world_edge_cap: Optional[int] = None,
                 world_surf_cap: Optional[int] = None):
        self.map_size = map_size
        self.edge_cap = edge_cap
        self.surf_cap = surf_cap
        # world-frame map downsampling (reference: downsample_voxel_size,
        # config/registration/scan_to_map.json). 0 disables. Capacities
        # bound the deduped map (static kernel shapes); overlapping-scan
        # redundancy makes half the raw size a comfortable default.
        self.world_voxel = float(world_voxel)
        self.world_edge_cap = int(world_edge_cap
                                  or max(map_size * edge_cap // 2, 1024))
        self.world_surf_cap = int(world_surf_cap
                                  or max(map_size * surf_cap // 2, 1024))
        S = map_size
        self.edges = np.zeros((S, edge_cap, 3), np.float32)
        self.edges_valid = np.zeros((S, edge_cap), bool)
        self.surfs = np.zeros((S, surf_cap, 3), np.float32)
        self.surfs_valid = np.zeros((S, surf_cap), bool)
        self.q = np.tile(np.array([1, 0, 0, 0], np.float32), (S, 1))
        self.p = np.zeros((S, 3), np.float32)
        self.used = np.zeros(S, bool)
        self.stamps = np.full(S, np.nan)
        self._next = 0
        self._cache = None

    def __len__(self):
        return int(self.used.sum())

    @property
    def empty(self) -> bool:
        return not self.used.any()

    def _pack(self, pts: np.ndarray, valid: np.ndarray, cap: int):
        out = np.zeros((cap, 3), np.float32)
        ok = np.zeros(cap, bool)
        sel = np.asarray(valid)
        pts = np.asarray(pts)[sel][:cap]
        out[: len(pts)] = pts
        ok[: len(pts)] = True
        return out, ok

    def add_scan(self, stamp: float, q, p, features: FeatureCloud):
        """Insert a scan's features (scan frame) with its map-frame pose,
        evicting the oldest slot (AddScanToMap / rolling map_size,
        scan_to_map_registration.cpp)."""
        s = self._next
        self._next = (self._next + 1) % self.map_size
        # one batched pull for all 8 feature arrays (per-array np.asarray on
        # device buffers is a blocking transfer each)
        (es, ew, esv, ewv, ss, sw, ssv, swv) = jax.device_get(
            (features.edge_strong, features.edge_weak,
             features.edge_strong_valid, features.edge_weak_valid,
             features.surf_strong, features.surf_weak,
             features.surf_strong_valid, features.surf_weak_valid))
        e = np.concatenate([es, ew])
        ev = np.concatenate([esv, ewv])
        f = np.concatenate([ss, sw])
        fv = np.concatenate([ssv, swv])
        self.edges[s], self.edges_valid[s] = self._pack(e, ev, self.edge_cap)
        self.surfs[s], self.surfs_valid[s] = self._pack(f, fv, self.surf_cap)
        self.q[s] = np.asarray(q, np.float32)
        self.p[s] = np.asarray(p, np.float32)
        self.used[s] = True
        self.stamps[s] = stamp
        self._cache = None

    def update_pose(self, stamp: float, q, p) -> bool:
        """Graph-update pose correction for one scan
        (UpdateScanPosesFromGraphMsg equivalent)."""
        hit = np.isclose(self.stamps, stamp, atol=1e-9) & self.used
        if not hit.any():
            return False
        self.q[hit] = np.asarray(q, np.float32)
        self.p[hit] = np.asarray(p, np.float32)
        self._cache = None
        return True

    def correct_drift(self, dq, dp):
        """Rigidly move the whole map (CorrectMapDriftFromGraphMsg):
        T_new = ΔT · T_old for every scan pose."""
        dq = np.asarray(dq, np.float32)
        dp = np.asarray(dp, np.float32)
        for s in range(self.map_size):
            if not self.used[s]:
                continue
            q_new = np.asarray(lie.quat_mul(jnp.asarray(dq),
                                            jnp.asarray(self.q[s])))
            p_new = np.asarray(lie.quat_rotate(jnp.asarray(dq),
                                               jnp.asarray(self.p[s]))) + dp
            self.q[s], self.p[s] = q_new, p_new
        self._cache = None

    def world_frame(self):
        """Assembled world-frame map: (edges [S*Ce,3], mask, surfs [S*Cs,3],
        mask) as device arrays — input to register_loam. Cached until the map
        changes."""
        if self._cache is None:
            e, ev, s, sv = _assemble(
                jnp.asarray(self.edges), jnp.asarray(self.edges_valid),
                jnp.asarray(self.surfs), jnp.asarray(self.surfs_valid),
                jnp.asarray(self.q), jnp.asarray(self.p),
                jnp.asarray(self.used))
            if self.world_voxel > 0:
                v = jnp.asarray(self.world_voxel, jnp.float32)
                e, ev = _voxel_dedup(e, ev, v, cap=self.world_edge_cap)
                s, sv = _voxel_dedup(s, sv, v, cap=self.world_surf_cap)
            self._cache = (e, ev, s, sv)
        return self._cache
