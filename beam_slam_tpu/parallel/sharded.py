"""Multi-chip parallelism: submap-sharded batched window solves.

The reference is a single-host ROS system (SURVEY.md §2.7); its only
"distribution" is the local-mapper/global-mapper process split. The
scaling story here (SURVEY.md §7.8) shards *submaps* across devices of a
``jax.sharding.Mesh``: each device owns a batch of independent sliding-window
problems (submap refinement is embarrassingly parallel per submap —
global_map_refinement.h:37-144), solves them with the same batched LM used by
the online smoother, and global quantities (total cost, shared-extrinsic
normal equations) are reduced across devices with ``psum``-style
collectives.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from beam_slam_tpu.solver import gauss_newton as gn

SUBMAP_AXIS = "submaps"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(devices, (SUBMAP_AXIS,))


def shard_batch(tree, mesh: Mesh):
    """Place a leading-batch pytree with the batch axis sharded over the
    submap mesh axis."""
    sharding = NamedSharding(mesh, P(SUBMAP_AXIS))
    return jax.device_put(tree, sharding)


@functools.partial(jax.jit, static_argnums=(2, 3))
def solve_batched(windows, families, losses, options: gn.SolverOptions):
    """vmap of the window LM solve over a leading batch axis. When inputs are
    sharded over the submap mesh axis, XLA partitions the whole solve with no
    cross-device communication (each submap's BA is independent)."""
    return jax.vmap(lambda w, f: gn.solve(w, f, losses, options))(
        windows, families)


@functools.partial(jax.jit, static_argnums=(2, 3))
def global_cost(windows, families, losses, mesh_axis: Optional[str] = None):
    """Total robustified cost over all submaps. Under shard_map this becomes
    a psum over the mesh; under jit+sharded inputs XLA inserts the
    collective."""
    costs = jax.vmap(lambda w, f: gn.total_cost(w, f, losses))(
        windows, families)
    return jnp.sum(costs)


def distributed_refinement_step(mesh: Mesh, windows, families, losses,
                                options: gn.SolverOptions):
    """One step of distributed submap refinement: shard the submap batch over
    the mesh, solve each submap's window in parallel, and reduce the summed
    final cost across devices (the convergence signal the offline refinement
    loop monitors — global_map_refinement.cpp pattern).

    Returns (solved windows, diagnostics, total final cost scalar).
    """
    windows = shard_batch(windows, mesh)
    families = shard_batch(families, mesh)
    out_windows, diags = solve_batched(windows, families, losses, options)
    total = jnp.sum(diags.final_cost)
    return out_windows, diags, total
