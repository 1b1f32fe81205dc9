"""Sharded (SPMD) raycast rendering over a 1-D device mesh.

Serves the BASELINE.md axis "renderer rays/s: 1 chip -> 1 host -> N
hosts". Reference context: the render/viz path is the async half of the
reference (sdf.cpp:317-391, single-threaded marching cubes + RViz); ours is
a sphere-tracing raycaster (render/raycast.py).

Design — RAY sharding over a replicated march field, not grid-slab
sharding of the march:

* A ray's samples span the whole volume, so slab-owned marching would need
  either a halo per STEP (per-step collectives, latency-bound) or per-slab
  sub-marches stitched by a psum-min (different sample trajectories -> hit
  sets diverge on grazing rays; not testable as equality). Instead each
  device all-gathers the (compact) SDF leaves ONCE per render and marches
  an equal block of rays to completion locally — ZERO further
  collectives, perfectly balanced, and the same per-ray program as the
  single-device renderer. On the CPU test mesh the results are bitwise
  equal (tests/test_parallel.py::test_sharded_raycast_matches_single). On
  GPUs each device compiles the march for its own block, which may fuse
  differently from the full-image program: hits agree on all but 0.1% of
  rays and hit depths within RaycastConfig.hit_epsilon
  (__graft_entry__.dryrun_multichip).

* Cost model: the gather moves (n_dev-1)/n_dev of D+W once per render
  (~134 MB at 256^3 f32 over NVLink) while the march's serial sample chain
  shrinks n_dev-fold. Not measured on H100s.

* The image's ray grid (pixel_rays of the FULL camera) is computed
  replicated, split row-blocks-of-rays over the mesh via shard_map, and
  each block enters raycast() through its ``dirs_cam`` override as a
  (1, n_blk, 3) single-row image; outputs re-assemble by concatenation
  along the ray axis and reshape back to (H, W).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tracking_sdf_tpu.config import GridParams, RaycastConfig
from tracking_sdf_tpu.core.camera import PinholeCamera, pixel_rays
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.grid.grid import TSDFGrid
from tracking_sdf_tpu.render.raycast import RenderResult, raycast


def sharded_raycast(
    mesh: Mesh,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: RaycastConfig = RaycastConfig(),
    stride: int = 1,
    with_color: bool = False,
):
    """Build the jitted SPMD render step for ``mesh``.

    Returns fn(grid_slab_sharded, pose) -> RenderResult with full-image
    leaves, the per-ray program of raycast() on the gathered grid. The grid
    argument is the i-slab-sharded dense TSDFGrid the SPMD pipeline already
    carries (parallel.shard_grid / the sharded fuse outputs)."""
    n_dev = mesh.devices.size
    if params.m % n_dev != 0:
        raise ValueError(f"grid m={params.m} not divisible by mesh {n_dev}")

    dirs_full, _ = pixel_rays(cam, stride)  # (H, W, 3) replicated
    Hs, Ws = dirs_full.shape[:2]
    N = Hs * Ws
    # pin the per-block phase structure to the FULL image's auto decision:
    # a ray must take the identical program path it would single-device,
    # regardless of block size
    if getattr(cfg, "two_phase", "auto") == "auto":
        cfg = cfg._replace(two_phase="on" if N >= 4096 else "off")
    n_pad = -(-N // n_dev) * n_dev  # pad rays to an even split
    dirs_flat = jnp.concatenate(
        [dirs_full.reshape(N, 3),
         jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dirs_full.dtype),
                          (n_pad - N, 3))], axis=0)
    # INTERLEAVE rays across devices (ray i -> device i % n_dev) instead
    # of contiguous row blocks: grazing-recovery survivors cluster at
    # silhouettes, which cluster in image rows — contiguous blocks
    # concentrate them in one device's compaction capacity (measured
    # overflow drops on scenes the single-device path renders drop-free).
    # Interleaving spreads survivors ~uniformly; per-ray results are
    # unchanged (each ray still runs the identical program).
    dirs_flat = (dirs_flat.reshape(-1, n_dev, 3).transpose(1, 0, 2)
                 .reshape(n_pad, 3))

    def local(D_slab, W_slab, R_slab, G_slab, B_slab, Wc_slab, pose,
              dirs_blk):
        # one all-gather per render; the march then runs fully local
        D = lax.all_gather(D_slab, "d", axis=0, tiled=True)
        W = lax.all_gather(W_slab, "d", axis=0, tiled=True)
        if with_color:
            R = lax.all_gather(R_slab, "d", axis=0, tiled=True)
            G = lax.all_gather(G_slab, "d", axis=0, tiled=True)
            B = lax.all_gather(B_slab, "d", axis=0, tiled=True)
            Wc = lax.all_gather(Wc_slab, "d", axis=0, tiled=True)
        else:  # color leaves unused: keep slabs (no gather traffic)
            R, G, B, Wc = R_slab, G_slab, B_slab, Wc_slab
        grid = TSDFGrid(D=D, W=W, R=R, G=G, B=B, Wc=Wc)
        res = raycast(grid, pose, params=params, cam=cam, cfg=cfg,
                      with_color=with_color,
                      dirs_cam=dirs_blk[None])  # (1, n_blk, 3) image
        # flatten the (1, n_blk) leaves to (n_blk,) for concat re-assembly
        flat = jax.tree.map(
            lambda l: (l.reshape(-1, 3) if l.ndim == 3 else l.reshape(-1)),
            res._replace(dropped=res.dropped[None]
                         if getattr(res.dropped, "ndim", 0) == 0
                         else res.dropped))
        return flat

    rspec = RenderResult(
        depth=P("d"), range_t=P("d"), hit=P("d"),
        normal_world=P("d", None), normal_cam=P("d", None),
        rgb=P("d", None) if with_color else None,
        steps=P("d"), dropped=P("d"))
    shmapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("d", None, None),) * 6 + (Pose(P(), P()), P("d", None)),
        out_specs=rspec,
        check_vma=False,
    )

    @jax.jit
    def fn(grid: TSDFGrid, pose: Pose) -> RenderResult:
        out = shmapped(grid.D, grid.W, grid.R, grid.G, grid.B, grid.Wc,
                       pose, dirs_flat)

        def unflat(l):  # invert the interleave, drop padding, reshape
            if l.ndim == 2:
                l = (l.reshape(n_dev, -1, 3).transpose(1, 0, 2)
                     .reshape(n_pad, 3))
                return l[:N].reshape(Hs, Ws, 3)
            l = l.reshape(n_dev, -1).transpose(1, 0).reshape(n_pad)
            return l[:N].reshape(Hs, Ws)

        return RenderResult(
            depth=unflat(out.depth),
            range_t=unflat(out.range_t),
            hit=unflat(out.hit),
            normal_world=unflat(out.normal_world),
            normal_cam=unflat(out.normal_cam),
            rgb=(unflat(out.rgb) if with_color else None),
            steps=unflat(out.steps),
            dropped=jnp.sum(out.dropped),
        )

    return fn
