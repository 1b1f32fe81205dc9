"""TSDF voxel grid storage and world<->voxel coordinate transforms.

The reference stores six dense float arrays D, W, R, G, B, Color_W of m^3
entries (sdf.cpp:10-17) with row-major index idx = m^2*i + m*j + k
(sdf.h:113-127) — i.e. i (the x axis) is the slowest dimension and k (z) the
fastest. A JAX array of shape (m, m, m) indexed [i, j, k] has exactly that
memory layout, so the grid here is a NamedTuple pytree of (m, m, m) float32
arrays. Being a pytree, it shards transparently: PartitionSpec('bricks',
None, None) on every leaf splits the volume into slabs along i across
devices with zero code changes in fusion (which is purely per-voxel).

Deltas vs the reference, by design:
  * Sign: D is positive in FREE SPACE (see package docstring); the reference
    stores the negation.
  * Color scale: R/G/B are fused in [0, 1] rather than the reference's
    0..255 (sdf.cpp:302-304) — its interpolate_color divides by 255 on
    output (sdf.cpp:213-216), so end-to-end colors agree.
  * The reference precomputes per-voxel world coordinates into a 3*m^3
    array (sdf.cpp:40-41). Here coordinates are recomputed from iota on
    the fly — XLA fuses the iota into consumers so nothing is materialized,
    saving 3x the grid's device-memory footprint and bandwidth.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from tracking_sdf_tpu.config import GridParams


class TSDFGrid(NamedTuple):
    """Pytree of dense (m, m, m) arrays. Axis order [i=x, j=y, k=z]."""

    D: jnp.ndarray  # truncated signed distance, meters, +free space
    W: jnp.ndarray  # fusion weight; W == 0 means never observed
    R: jnp.ndarray  # color in [0, 1]
    G: jnp.ndarray
    B: jnp.ndarray
    Wc: jnp.ndarray  # color fusion weight (reference Color_W)


def empty_grid(params: GridParams, dtype=jnp.float32) -> TSDFGrid:
    """Fresh grid: D = width+height+depth (far free space), W = 0, grey color.

    Mirrors SDF::SDF init (sdf.cpp:28-34): D = w+h+d, W = 0, R=G=B = 0.4.
    """
    m = params.m
    shape = (m, m, m)
    far = params.width + params.height + params.depth
    return TSDFGrid(
        D=jnp.full(shape, far, dtype=dtype),
        W=jnp.zeros(shape, dtype=dtype),
        R=jnp.full(shape, 0.4, dtype=dtype),
        G=jnp.full(shape, 0.4, dtype=dtype),
        B=jnp.full(shape, 0.4, dtype=dtype),
        Wc=jnp.zeros(shape, dtype=dtype),
    )


def world_to_voxel(params: GridParams, x: jnp.ndarray) -> jnp.ndarray:
    """World points (..., 3) -> continuous voxel coords (..., 3).

    Exact reference semantics (sdf.h:143-147):
    i = (x - origin_x) * m/width - 0.5 (voxel centers land on integers).
    """
    origin = jnp.asarray(params.origin, dtype=x.dtype)
    scale = jnp.asarray(
        [params.m / params.width, params.m / params.height, params.m / params.depth],
        dtype=x.dtype,
    )
    return (x - origin) * scale - 0.5


def voxel_to_world(params: GridParams, ijk: jnp.ndarray) -> jnp.ndarray:
    """Voxel coords (..., 3) -> world coords of voxel centers (sdf.h:153-157)."""
    origin = jnp.asarray(params.origin, dtype=jnp.result_type(ijk, jnp.float32))
    vsize = jnp.asarray(
        [params.width / params.m, params.height / params.m, params.depth / params.m],
        dtype=origin.dtype,
    )
    return vsize * (ijk + 0.5) + origin


def voxel_centers_world(params: GridParams, dtype=jnp.float32,
                        i_offset=0, mi=None):
    """(i, j, k) iota planes broadcastable to (mi, m, m), as world coords.

    Returned as three broadcast-shaped arrays rather than a packed (m,m,m,3)
    tensor so XLA keeps them as fused iotas (no materialization).
    ``i_offset``/``mi`` address an SPMD i-slab: local plane index 0 maps to
    global voxel i = i_offset (i_offset may be traced).
    """
    m = params.m
    mi = m if mi is None else mi
    i = (jnp.arange(mi, dtype=dtype)
         + jnp.asarray(i_offset, dtype)).reshape(mi, 1, 1)
    j = jnp.arange(m, dtype=dtype).reshape(1, m, 1)
    k = jnp.arange(m, dtype=dtype).reshape(1, 1, m)
    ox, oy, oz = params.origin
    x = (params.width / m) * (i + 0.5) + ox
    y = (params.height / m) * (j + 0.5) + oy
    z = (params.depth / m) * (k + 0.5) + oz
    return x, y, z
