"""Device mesh construction and canonical shardings.

One mesh axis, ``'d'``, carries both parallel structures of the workload:

* the TSDF grid is split into contiguous SLABS along the voxel i-axis
  (``PartitionSpec('d', None, None)`` on every grid leaf) — fusion and
  meshing then touch only local voxels (SURVEY.md P2/P3);
* tracking reduces per-shard partial normal equations with ``psum`` over
  ``'d'`` (SURVEY.md P1) — pixels are replicated, grid queries are answered
  by the slab that owns them (plus a one-plane halo), so the full grid is
  never gathered.

Multi-host: `jax.distributed.initialize()` before `make_mesh()` makes
`jax.devices()` span all hosts; nothing else changes (XLA routes the psum
over the hosts' interconnect).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tracking_sdf_tpu.grid.grid import TSDFGrid


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis_name: str = "d"
) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (axis_name,))


def grid_sharding(mesh: Mesh, axis_name: str = "d") -> NamedSharding:
    """Slab sharding for (m, m, m) grid leaves: split along the i (x) axis."""
    return NamedSharding(mesh, P(axis_name, None, None))


def put_sharded(x, s: NamedSharding):
    """`jax.device_put(x, s)`, multi-PROCESS-safe.

    Cross-process device_put runs a value-equality check across ranks
    (dispatch.py multihost_utils.assert_equal) that is NaN-hostile — the
    NaN-masked D leaves (brickmajor storage invariant) always fail it.
    When `s` spans other processes, build the global array from the local
    value instead (every rank passes the same deterministic value — the
    same contract device_put's check enforces, minus the NaN false
    positive)."""
    if all(d.process_index == jax.process_index() for d in s.device_set):
        return jax.device_put(x, s)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_grid(grid: TSDFGrid, mesh: Mesh, axis_name: str = "d") -> TSDFGrid:
    """Place every grid leaf slab-sharded on the mesh."""
    s = grid_sharding(mesh, axis_name)
    return jax.tree.map(lambda x: put_sharded(x, s), grid)
