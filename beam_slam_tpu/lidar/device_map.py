"""Device-resident rolling registration map.

The host :class:`~beam_slam_tpu.lidar.registration_map.RegistrationMap`
mirrors the reference's RegistrationMap singleton with numpy storage — every
``add_scan`` pulls the scan's feature arrays to the host and every
``world_frame`` re-uploads the whole map: one blocking round trip plus
~1 MB of transfers *per scan*.

This module keeps the map ON DEVICE as a ring buffer of jnp arrays
(reference behavior: AddScanToMap / rolling ``map_size``,
bs_models/src/lib/scan_registration/scan_to_map_registration.cpp:23-92) so
the whole scan→register→map-update step runs as one fused jit call with no
host round trip. Host code keeps only stamp/slot bookkeeping.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from beam_slam_tpu.core import lie
from beam_slam_tpu.lidar.cloud import FeatureCloud
from beam_slam_tpu.lidar.registration_map import _voxel_dedup


class DeviceMapState(NamedTuple):
    """Ring buffer of the last S scans' LOAM features (scan frame) + poses.

    ``prev_q/prev_p``: map-frame pose of the last successfully registered
    scan — the "from" pose of the next chained relative factor
    (scan_to_map_registration.cpp keeps the same chain through
    ``last_scan_pose_``)."""

    edges: jnp.ndarray        # [S, Ce, 3]
    edges_valid: jnp.ndarray  # [S, Ce] bool
    surfs: jnp.ndarray        # [S, Cs, 3]
    surfs_valid: jnp.ndarray  # [S, Cs] bool
    q: jnp.ndarray            # [S, 4]
    p: jnp.ndarray            # [S, 3]
    used: jnp.ndarray         # [S] bool
    next_slot: jnp.ndarray    # i32 scalar
    prev_q: jnp.ndarray       # [4]
    prev_p: jnp.ndarray       # [3]


def init_device_map(map_size: int = 10, edge_cap: int = 2112,
                    surf_cap: int = 4096) -> DeviceMapState:
    S = map_size
    return DeviceMapState(
        edges=jnp.zeros((S, edge_cap, 3), jnp.float32),
        edges_valid=jnp.zeros((S, edge_cap), bool),
        surfs=jnp.zeros((S, surf_cap, 3), jnp.float32),
        surfs_valid=jnp.zeros((S, surf_cap), bool),
        q=jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (S, 1)),
        p=jnp.zeros((S, 3), jnp.float32),
        used=jnp.zeros(S, bool),
        next_slot=jnp.zeros((), jnp.int32),
        prev_q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
        prev_p=jnp.zeros(3, jnp.float32))


def _compact(pts: jnp.ndarray, valid: jnp.ndarray, cap: int):
    """Stable valid-first compaction of [N,3]+[N] to fixed [cap,3]+[cap].
    Pads with invalid zero rows when N < cap (small scans)."""
    n = pts.shape[0]
    if n < cap:
        pts = jnp.concatenate(
            [pts, jnp.zeros((cap - n, 3), pts.dtype)], axis=0)
        valid = jnp.concatenate(
            [valid, jnp.zeros((cap - n,), bool)], axis=0)
    order = jnp.argsort(~valid, stable=True)
    sel = order[:cap]
    return pts[sel], valid[sel]


def _features_packed(fc: FeatureCloud, edge_cap: int, surf_cap: int):
    e = jnp.concatenate([fc.edge_strong, fc.edge_weak], axis=0)
    ev = jnp.concatenate([fc.edge_strong_valid, fc.edge_weak_valid], axis=0)
    s = jnp.concatenate([fc.surf_strong, fc.surf_weak], axis=0)
    sv = jnp.concatenate([fc.surf_strong_valid, fc.surf_weak_valid], axis=0)
    e, ev = _compact(e, ev, edge_cap)
    s, sv = _compact(s, sv, surf_cap)
    return e, ev, s, sv


def add_scan_traced(state: DeviceMapState, fc: FeatureCloud, q, p,
                    enable) -> DeviceMapState:
    """Conditionally insert a scan (features in scan frame, pose = map-frame
    lidar pose) into ``next_slot``. ``enable`` is a traced bool: when False
    the state is returned unchanged (used to gate on device-side
    registration convergence). Trace-time shapes only — call under jit."""
    slot = state.next_slot % state.used.shape[0]
    e, ev, s, sv = _features_packed(fc, state.edges.shape[1],
                                    state.surfs.shape[1])
    q = jnp.asarray(q, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    new = DeviceMapState(
        edges=state.edges.at[slot].set(e),
        edges_valid=state.edges_valid.at[slot].set(ev),
        surfs=state.surfs.at[slot].set(s),
        surfs_valid=state.surfs_valid.at[slot].set(sv),
        q=state.q.at[slot].set(q),
        p=state.p.at[slot].set(p),
        used=state.used.at[slot].set(True),
        next_slot=state.next_slot + 1,
        prev_q=q, prev_p=p)
    enable = jnp.asarray(enable, bool)
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            enable.reshape((1,) * a.ndim), b, a), state, new)


add_scan = jax.jit(partial(add_scan_traced, enable=True))


def assemble_world_traced(state: DeviceMapState, world_voxel: float,
                          world_edge_cap: int, world_surf_cap: int):
    """World-frame flat point sets (edges, mask, surfs, mask) for
    register_loam; optional on-device voxel dedup (the reference's
    ``downsample_voxel_size``)."""
    def tf(pts, valid):
        w = lie.quat_rotate(state.q[:, None, :], pts) + state.p[:, None, :]
        ok = valid & state.used[:, None]
        return w.reshape(-1, 3), ok.reshape(-1)

    e, ev = tf(state.edges, state.edges_valid)
    s, sv = tf(state.surfs, state.surfs_valid)
    if world_voxel > 0:
        v = jnp.asarray(world_voxel, jnp.float32)
        e, ev = _voxel_dedup(e, ev, v, cap=world_edge_cap)
        s, sv = _voxel_dedup(s, sv, v, cap=world_surf_cap)
    return e, ev, s, sv


assemble_world = jax.jit(assemble_world_traced, static_argnums=(1, 2, 3))


@partial(jax.jit, donate_argnums=(0,))
def update_pose_device(state: DeviceMapState, slot, q, p) -> DeviceMapState:
    """Rewrite one scan's map-frame pose (UpdateScanPosesFromGraphMsg)."""
    return state._replace(q=state.q.at[slot].set(jnp.asarray(q, jnp.float32)),
                          p=state.p.at[slot].set(jnp.asarray(p, jnp.float32)))


@partial(jax.jit, donate_argnums=(0,))
def correct_drift_device(state: DeviceMapState, dq, dp) -> DeviceMapState:
    """Rigidly move the whole map: T_new = ΔT·T_old per scan pose
    (CorrectMapDriftFromGraphMsg)."""
    dq = jnp.asarray(dq, jnp.float32)
    dp = jnp.asarray(dp, jnp.float32)
    q_new = lie.quat_mul(dq[None, :], state.q)
    p_new = lie.quat_rotate(dq[None, :], state.p) + dp[None, :]
    pq = lie.quat_mul(dq, state.prev_q)
    pp = lie.quat_rotate(dq, state.prev_p) + dp
    return state._replace(q=q_new, p=p_new, prev_q=pq, prev_p=pp)


def from_host_map(host_map, prev_q=None, prev_p=None) -> DeviceMapState:
    """Lift a host RegistrationMap (e.g. the init-phase map) onto the
    device, preserving the ring layout."""
    S = host_map.map_size
    return DeviceMapState(
        edges=jnp.asarray(host_map.edges),
        edges_valid=jnp.asarray(host_map.edges_valid),
        surfs=jnp.asarray(host_map.surfs),
        surfs_valid=jnp.asarray(host_map.surfs_valid),
        q=jnp.asarray(host_map.q),
        p=jnp.asarray(host_map.p),
        used=jnp.asarray(host_map.used),
        next_slot=jnp.asarray(host_map._next % S, jnp.int32),
        prev_q=jnp.asarray(np.asarray(
            [1.0, 0, 0, 0] if prev_q is None else prev_q, np.float32)),
        prev_p=jnp.asarray(np.asarray(
            [0.0, 0, 0] if prev_p is None else prev_p, np.float32)))
