"""SPMD distribution layer: device meshes, shardings, and sharded kernels.

The reference's parallelism is OpenMP threads + serial partial-sum reduction
inside one address space (SURVEY.md §2 P1-P5). Here the same structures map
onto a `jax.sharding.Mesh`:

* grid SLABS along the voxel i-axis  <-> OpenMP voxel parallel-for (P2, P3)
* per-shard (JᵀJ, Jᵀr) + `psum`      <-> per-thread partials + serial reduce (P1)
* XLA collectives (NCCL on GPUs)      <-> shared memory (P5)
"""
from tracking_sdf_tpu.parallel.mesh import (
    make_mesh,
    grid_sharding,
    replicated_sharding,
    shard_grid,
)
from tracking_sdf_tpu.parallel.render import sharded_raycast
from tracking_sdf_tpu.parallel.sharded import (
    shard_brick_grid,
    sharded_fuse_frame,
    sharded_fuse_frame_bricked,
    sharded_fuse_frame_brickmajor,
    sharded_track_frame,
    sharded_track_frame_brickmajor,
    sharded_track_frame_masked,
    make_sharded_step,
)

__all__ = [
    "make_mesh",
    "grid_sharding",
    "replicated_sharding",
    "shard_grid",
    "shard_brick_grid",
    "sharded_raycast",
    "sharded_fuse_frame",
    "sharded_fuse_frame_bricked",
    "sharded_fuse_frame_brickmajor",
    "sharded_track_frame",
    "sharded_track_frame_brickmajor",
    "sharded_track_frame_masked",
    "make_sharded_step",
]
