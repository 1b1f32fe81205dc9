"""Multi-PROCESS SPMD worker: one rank of a 2-process CPU 'pod'.

Executes the jax.distributed path that single-process virtual-mesh tests
cannot reach: `jax.distributed.initialize()` (the
code behind `cli.py --multihost`), a mesh spanning BOTH processes' devices,
the sharded brickmajor fuse + zero-relayout tracking step across the
process boundary (ppermute halo crosses ranks), and
`marching_cubes_sharded` with its cross-process halo-plane collective
(render/marching_cubes._cross_host_halo_planes) — the branch that
previously dropped an (m-1)^2 cell plane.

Launched by tests/test_multiprocess.py and scripts/run_multiprocess_check.py:

    python scripts/mp_worker.py COORD_ADDR NUM_PROCS PROC_ID OUTDIR

with JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_device_count=N
in the environment. Each rank writes OUTDIR/out_{pid}.npz containing the
replicated-gathered fused grid, the tracked pose, and the rank's local
triangle slab; the launcher concatenates ranks' triangles (ascending pid ==
ascending slab i) and compares everything against a single-process run.

Reference context: the reference is single-process shared-memory
(sdf_reconstruction.cpp:89-91); this is the SURVEY §4.6 multi-host tier.
"""
from __future__ import annotations

import sys

import numpy as np

# deterministic workload, shared with the launcher's reference computation
M = 48
BS = (2, 8, 16)
CAP = 96  # per shard


def build_workload():
    """Scene + camera + two deterministic frames (pose, pts, normals, rgb).

    Kept import-light so the launcher (single-process pytest) can call it
    too; everything derives from fixed constants — both ranks and the
    reference compute bit-identical inputs."""
    import jax.numpy as jnp

    from tracking_sdf_tpu.config import (
        FusionConfig, GridParams, TrackingConfig)
    from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
    from tracking_sdf_tpu.core.lie import pose_compose, se3_exp
    from tracking_sdf_tpu.data import (
        CuboidScene, SphereScene, look_at, render_scene_depth)
    from tracking_sdf_tpu.tracking import estimate_normals

    params = GridParams(m=M, width=2.0, height=2.0, depth=2.0,
                        origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5,
                        width=96, height=72)
    sphere = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
    box = CuboidScene(min_corner=(-0.75, -0.4, -0.55),
                      max_corner=(-0.35, 0.4, 0.15))

    class Scene:
        def sdf(self, x):
            return jnp.minimum(sphere.sdf(x), box.sdf(x))

        def color(self, x):
            return sphere.color(x)

        def intersect(self, o, d):
            ta, tb = sphere.intersect(o, d), box.intersect(o, d)
            return jnp.where(jnp.isnan(ta), tb,
                             jnp.where(jnp.isnan(tb), ta,
                                       jnp.minimum(ta, tb)))

    scene = Scene()
    pose0 = look_at((0.0, -1.5, 0.25), (0.0, 0.0, 0.0))
    xi = jnp.asarray([0.01, -0.008, 0.012, 0.008, -0.006, 0.01], jnp.float32)
    pose1 = pose_compose(pose0, se3_exp(xi))

    frames = []
    for pose in (pose0, pose1):
        depth = render_scene_depth(scene, cam, pose)
        pts = backproject(cam, depth)
        nrm = estimate_normals(pts)
        rgb = jnp.full(pts.shape, 0.5, jnp.float32)
        frames.append((pose, np.asarray(pts), np.asarray(nrm),
                       np.asarray(rgb)))

    fcfg = FusionConfig(fuse_color=True, brick_shape=BS)
    tcfg = TrackingConfig(jacobian="analytic", max_iterations=30)
    return params, cam, fcfg, tcfg, frames


def reference_outputs():
    """Single-device dense reference, mirroring the worker's schedule
    exactly: fuse frame 0 at gt, track frame 1 from pose0 (against the
    1-frame grid), fuse frame 1 at ITS GT POSE (not the tracked one, so
    the grids stay comparable at f32-reassociation tolerance independent
    of the tracked pose's psum noise)."""
    from tracking_sdf_tpu.fusion.fuse import fuse_frame
    from tracking_sdf_tpu.grid.grid import empty_grid
    from tracking_sdf_tpu.tracking import strided_points, track_frame

    params, cam, fcfg, tcfg, frames = build_workload()
    pose0, pts0, nrm0, rgb0 = frames[0]
    pose1, pts1, nrm1, rgb1 = frames[1]
    grid = fuse_frame(empty_grid(params), pose0, pts0, nrm0, rgb0,
                      params=params, cam=cam, cfg=fcfg)
    points = strided_points(pts1, 2).reshape(-1, 3)
    res = track_frame(grid, pose0, points, params=params, cfg=tcfg)
    grid = fuse_frame(grid, pose1, pts1, nrm1, rgb1,
                      params=params, cam=cam, cfg=fcfg)
    return grid, res


def main(addr: str, n_procs: int, pid: int, outdir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=n_procs, process_id=pid)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense, dense_from_brick_grid)
    from tracking_sdf_tpu.grid.grid import TSDFGrid, empty_grid
    from tracking_sdf_tpu.parallel import (
        make_mesh,
        sharded_fuse_frame_brickmajor,
        sharded_track_frame_brickmajor,
    )
    from tracking_sdf_tpu.render.marching_cubes import marching_cubes_sharded
    from tracking_sdf_tpu.tracking import strided_points

    assert jax.process_count() == n_procs, jax.process_count()
    n_dev = jax.device_count()
    params, cam, fcfg, tcfg, frames = build_workload()
    mesh = make_mesh()

    def put_global(x, spec):
        x = np.asarray(x)
        s = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

    # global sharded brick grid (both ranks build the identical empty grid
    # locally; make_array_from_callback slices out each device's rows)
    bg_local = brick_grid_from_dense(empty_grid(params), BS)
    bg = jax.tree.map(lambda l: put_global(l, P("d", None)), bg_local)

    fuse = sharded_fuse_frame_brickmajor(
        mesh, params=params, cam=cam, cfg=fcfg, bs=BS, cap=CAP,
        emit_dm=False)
    track = sharded_track_frame_brickmajor(
        mesh, params=params, cfg=tcfg, bs=BS)

    # frame 0: fuse at groundtruth; frame 1: track from pose0 (crosses the
    # process boundary via the ppermute halo + Gloo psum), then fuse at the
    # GT pose (keeps grids deterministic for the launcher's comparison —
    # see reference_outputs)
    pose0, pts0, nrm0, rgb0 = frames[0]
    bg, _, stats = fuse(bg, pose0, pts0, nrm0, rgb0)
    pose1, pts1, nrm1, rgb1 = frames[1]
    points = strided_points(jnp.asarray(pts1), 2).reshape(-1, 3)
    res = track(bg.D, pose0, np.asarray(points))
    bg, _, stats = fuse(bg, pose1, pts1, nrm1, rgb1)

    # dense global grid (sharded P('d', None, None)) for sharded meshing
    dense_fn = jax.jit(
        lambda b: dense_from_brick_grid(b, params, BS),
        out_shardings=TSDFGrid(*([NamedSharding(mesh, P("d", None, None))]
                                 * 6)))
    grid = dense_fn(bg)
    mesh_out = marching_cubes_sharded(grid, params=params, with_colors=True)

    # replicated gather of the fused grid for the launcher's comparison
    rep = NamedSharding(mesh, P())
    gather = jax.jit(lambda x: x, out_shardings=rep)
    np.savez(
        f"{outdir}/out_{pid}.npz",
        **{name: np.asarray(gather(getattr(grid, name)))
           for name in grid._fields},
        pose_R=np.asarray(res.pose.R),
        pose_t=np.asarray(res.pose.t),
        num_valid=int(res.num_valid),
        n_full=int(stats.n_full),
        overflow=int(stats.overflow),
        tris=mesh_out.vertices,
        cols=mesh_out.colors,
        dropped=mesh_out.dropped_cells,
        n_dev=n_dev,
        n_procs=jax.process_count(),
    )
    print(f"pid={pid} ok: {mesh_out.num_triangles} local tris, "
          f"n_full={int(stats.n_full)}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, "/root/repo")
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
