"""Multi-host deployment tier.

SURVEY.md §7.8's scale story: submaps (contiguous keyframe ranges) are
distributed across *hosts* over the host network, while each host fans
factor linearization out over its local GPUs, joined all to all by NVLink.
Three pieces:

* :func:`initialize_from_env` — ``jax.distributed.initialize`` wiring for a
  real multi-process launch (coordinator address / process id from the
  standard env vars). A no-op in single-process runs, so the same binary
  serves laptop tests and pod deployment.
* :func:`make_hybrid_mesh` — a 2D ``Mesh`` with axes ``("hosts",
  "shards")``: the slow host-network axis × the fast NVLink axis. In a real
  multi-host run each row holds one process's devices; single-process
  (tests, the virtual-CPU dry run) it simulates the topology by folding the
  local devices.
* :func:`order_factors_by_owner` — the locality-preserving factor
  permutation: each host owns a contiguous keyframe range, factors live on
  the host owning their first endpoint. Odometry-chain factors thus never
  cross hosts during assembly; loop closures are the only cross-host edges,
  and they need no special casing (the global state is replicated — only
  the normal-equation reduction is collective: one [D,D] all-reduce per LM
  iteration).

The solve itself is :func:`beam_slam_tpu.parallel.distributed_pgo.
solve_distributed_hybrid`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh

from beam_slam_tpu.parallel import distributed_pgo as dpgo

HOST_AXIS = "hosts"
SHARD_AXIS = dpgo.AXIS  # "shards"


def initialize_from_env() -> bool:
    """Initialize ``jax.distributed`` from the standard launcher env
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, the
    names jax.distributed.initialize itself documents). Returns True when a
    multi-process runtime was initialized, False for single-process (no
    env, or already initialized)."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    if not addr or not nproc or int(nproc) <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(nproc),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
        return True
    except RuntimeError:
        return False  # already initialized


def make_hybrid_mesh(n_hosts: Optional[int] = None,
                     devices_per_host: Optional[int] = None) -> Mesh:
    """2D ``("hosts", "shards")`` mesh.

    Real multi-process runtime: one row per process, so each row's devices
    live on one host and the inner axis stays on NVLink. Single process:
    fold the local device list into [n_hosts, devices_per_host] — a
    faithful simulation for the CPU-mesh tests and the virtual-device dry
    run."""
    devs = jax.devices()
    if jax.process_count() > 1:
        per = devices_per_host or jax.local_device_count()
        hosts = n_hosts or jax.process_count()
        by_proc = sorted(devs, key=lambda d: (d.process_index, d.id))
        arr = np.asarray(by_proc[:hosts * per]).reshape(hosts, per)
        return Mesh(arr, (HOST_AXIS, SHARD_AXIS))
    if n_hosts is None:
        n_hosts = 2 if len(devs) >= 2 else 1
    if devices_per_host is None:
        devices_per_host = max(len(devs) // n_hosts, 1)
    n = n_hosts * devices_per_host
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    arr = np.asarray(devs[:n]).reshape(n_hosts, devices_per_host)
    return Mesh(arr, (HOST_AXIS, SHARD_AXIS))


def keyframe_ranges(n_poses: int, n_hosts: int) -> Sequence[Tuple[int, int]]:
    """Contiguous [start, end) keyframe ranges, one per host — the submap
    distribution (SlamChunk subtrajectories map to hosts in order)."""
    bounds = np.linspace(0, n_poses, n_hosts + 1).astype(int)
    return [(int(bounds[h]), int(bounds[h + 1])) for h in range(n_hosts)]


def owner_of(pose_idx: np.ndarray, n_poses: int, n_hosts: int) -> np.ndarray:
    """Host owning each pose index (the range partition above)."""
    bounds = np.linspace(0, n_poses, n_hosts + 1).astype(int)
    return np.clip(np.searchsorted(bounds, pose_idx, side="right") - 1,
                   0, n_hosts - 1)


def order_factors_by_owner(factors: dpgo.PGOFactors, n_poses: int,
                           n_hosts: int) -> dpgo.PGOFactors:
    """Permute factors so that, after padding + equal-split sharding over
    the flattened (hosts, shards) axes, each host's slice holds (almost
    only) factors whose FIRST endpoint it owns.

    Equal splits cannot honor an arbitrary owner histogram exactly —
    factors are balanced: each host's overflow beyond its fair share
    spills to the globally emptiest host (state is replicated, so a
    spilled factor is still correct, just assembled off-owner; the spill
    only costs host locality for the few factors past the imbalance)."""
    i_host = np.asarray(factors.i)
    owner = owner_of(i_host, n_poses, n_hosts)
    owner = np.where(np.asarray(factors.active), owner, n_hosts - 1)
    F = len(owner)
    fair = -(-F // n_hosts)
    buckets = [list(np.nonzero(owner == h)[0]) for h in range(n_hosts)]
    # spill overflow to the emptiest buckets
    overflow = []
    for h in range(n_hosts):
        if len(buckets[h]) > fair:
            overflow += buckets[h][fair:]
            buckets[h] = buckets[h][:fair]
    for idx in overflow:
        h = int(np.argmin([len(b) for b in buckets]))
        buckets[h].append(idx)
    perm = np.concatenate([np.asarray(b, int) for b in buckets]) \
        if F else np.zeros(0, int)
    return jax.tree_util.tree_map(lambda x: x[perm], factors)


def solve_pgo_multihost(state: dpgo.PGOState, factors: dpgo.PGOFactors,
                        priors: dpgo.PGOPriors, n_iter: int = 20,
                        mesh: Optional[Mesh] = None):
    """End-to-end multi-host PGO: build (or take) the hybrid mesh, apply
    the owner-locality factor order, run the coupled hierarchical solve."""
    mesh = mesh or make_hybrid_mesh()
    n_hosts = mesh.shape[HOST_AXIS]
    n_poses = int(state.q.shape[0])
    factors = order_factors_by_owner(factors, n_poses, n_hosts)
    return dpgo.solve_distributed_hybrid(mesh, state, factors, priors,
                                         n_iter)
