"""Sharded-vs-unsharded equivalence on the virtual 8-device CPU mesh.

This is the distributed test tier the reference never had (SURVEY.md §4.6):
the SPMD kernels must produce the same numbers as the dense single-device
path — fusion bitwise-identical per voxel (it is purely local), tracking
allclose (the psum changes f32 summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracking_sdf_tpu.config import FusionConfig, GridParams, TrackingConfig
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.core.lie import pose_compose, pose_inverse, se3_exp, se3_log
from tracking_sdf_tpu.data import (
    CuboidScene,
    SphereScene,
    grid_from_scene,
    look_at,
    render_scene_depth,
)
from tracking_sdf_tpu.fusion.fuse import fuse_frame
from tracking_sdf_tpu.grid.grid import empty_grid
from tracking_sdf_tpu.parallel import (
    make_mesh,
    make_sharded_step,
    shard_grid,
    sharded_fuse_frame,
    sharded_track_frame,
)
from tracking_sdf_tpu.tracking import estimate_normals, strided_points, track_frame

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SCENE_A = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
SCENE_B = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))


class TwoScenes:
    def sdf(self, x):
        return jnp.minimum(SCENE_A.sdf(x), SCENE_B.sdf(x))

    def color(self, x):
        return SCENE_A.color(x)

    def intersect(self, origins, dirs):
        ta = SCENE_A.intersect(origins, dirs)
        tb = SCENE_B.intersect(origins, dirs)
        return jnp.where(jnp.isnan(ta), tb, jnp.where(jnp.isnan(tb), ta, jnp.minimum(ta, tb)))


SCENE = TwoScenes()
TRUE_POSE = look_at((0.0, -1.5, 0.25), (0.0, 0.0, 0.0))


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8, "conftest must provide 8 virtual devices"
    return make_mesh()


@pytest.fixture(scope="module")
def frame():
    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    pts = backproject(CAM, depth)
    normals = estimate_normals(pts)
    rgb = jnp.full(pts.shape, 0.5, dtype=jnp.float32)
    return pts, normals, rgb


def test_sharded_fusion_matches_dense(mesh, frame):
    pts, normals, rgb = frame
    cfg = FusionConfig()
    g_dense = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, normals, rgb,
                         params=PARAMS, cam=CAM, cfg=cfg)
    fuse_sh = sharded_fuse_frame(mesh, params=PARAMS, cam=CAM, cfg=cfg)
    g_sh = fuse_sh(shard_grid(empty_grid(PARAMS), mesh), TRUE_POSE, pts, normals, rgb)
    for name in TSDF_FIELDS:
        a = np.asarray(getattr(g_dense, name))
        b = np.asarray(getattr(g_sh, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=0, err_msg=name)


TSDF_FIELDS = ("D", "W", "R", "G", "B", "Wc")


def test_sharded_bricked_fusion_matches_dense(mesh, frame):
    """Per-slab brick classification + compaction (i_offset path) must equal
    the dense fusion's geometry exactly — the brick-sharded fusion of the
    BASELINE north star, zero collectives."""
    from tracking_sdf_tpu.parallel import sharded_fuse_frame_bricked

    pts, normals, rgb = frame
    cfg = FusionConfig(fuse_color=False, brick_shape=(1, 8, 16))
    g_dense = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, normals, None,
                         params=PARAMS, cam=CAM, cfg=cfg)
    fuse_sh = sharded_fuse_frame_bricked(
        mesh, params=PARAMS, cam=CAM, cfg=cfg, cap=224)
    g_sh, stats = fuse_sh(shard_grid(empty_grid(PARAMS), mesh),
                          TRUE_POSE, pts, normals)
    assert int(stats.overflow) == 0
    assert int(stats.n_full) > 0
    np.testing.assert_allclose(np.asarray(g_sh.W), np.asarray(g_dense.W),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_sh.D), np.asarray(g_dense.D),
                               atol=1e-5)


def test_sharded_tracking_matches_dense(mesh):
    grid = grid_from_scene(PARAMS, SCENE)
    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    points = strided_points(backproject(CAM, depth), 2)

    xi = jnp.asarray([0.03, -0.02, 0.04, 0.02, -0.03, 0.02], dtype=jnp.float32)
    pose0 = pose_compose(se3_exp(xi), TRUE_POSE)
    cfg = TrackingConfig(jacobian="analytic", max_iterations=30)

    r_dense = track_frame(grid, pose0, points, params=PARAMS, cfg=cfg)
    track_sh = sharded_track_frame(mesh, params=PARAMS, cfg=cfg)
    r_sh = track_sh(shard_grid(grid, mesh), pose0, points)

    # same pixels contribute (ownership partitions the owned set exactly)
    assert int(r_sh.num_valid) == int(r_dense.num_valid)
    # pose equality up to f32 reduction-order noise amplified by ~10 GN iters
    np.testing.assert_allclose(np.asarray(r_sh.pose.R), np.asarray(r_dense.pose.R),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(r_sh.pose.t), np.asarray(r_dense.pose.t),
                               atol=5e-5)
    # and it actually converged to the true pose
    delta = pose_compose(pose_inverse(r_sh.pose), TRUE_POSE)
    err = np.asarray(se3_log(delta))
    assert np.linalg.norm(err[:3]) < 0.004
    assert np.linalg.norm(err[3:]) < 0.004


def test_sharded_full_step(mesh, frame):
    """track + fuse end-to-end on the mesh (the dryrun_multichip path)."""
    pts, normals, rgb = frame
    grid0 = grid_from_scene(PARAMS, SCENE)
    step = make_sharded_step(mesh, params=PARAMS, cam=CAM)
    xi = jnp.asarray([0.01, -0.01, 0.01, 0.005, -0.005, 0.005], dtype=jnp.float32)
    pose0 = pose_compose(se3_exp(xi), TRUE_POSE)
    grid1, pose1, res = step(shard_grid(grid0, mesh), pose0, pts, normals, rgb)
    assert res is not None and int(res.iterations) >= 1
    assert float(jnp.sum(grid1.W)) > float(jnp.sum(grid0.W))
    delta = pose_compose(pose_inverse(pose1), TRUE_POSE)
    err = np.asarray(se3_log(delta))
    assert np.linalg.norm(err[:3]) < 0.01


def test_sharded_brickmajor_fusion_and_masked_tracking(mesh, frame):
    """Sharded BRICK-MAJOR fusion (contiguous brick-row slabs, zero
    collectives) == single-device brickmajor == dense fusion; the emitted
    per-slab masked Dm drives sharded_track_frame_masked to the same pose
    as dense tracking."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        dense_from_brick_grid,
        fuse_frame_brickmajor,
    )
    from tracking_sdf_tpu.grid.interp import masked_view
    from tracking_sdf_tpu.parallel import (
        shard_brick_grid,
        sharded_fuse_frame_brickmajor,
        sharded_track_frame_masked,
    )

    pts, normals, rgb = frame
    bs = (2, 8, 16)  # slab = 48/8 = 6 voxels -> 3 bricks of i-extent 2
    cfg = FusionConfig(fuse_color=True, brick_shape=bs)
    g_dense = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, normals, rgb,
                         params=PARAMS, cam=CAM, cfg=cfg)

    fuse_sh = sharded_fuse_frame_brickmajor(
        mesh, params=PARAMS, cam=CAM, cfg=cfg, cap=96)
    bg0 = shard_brick_grid(brick_grid_from_dense(empty_grid(PARAMS), bs), mesh)
    bg, Dm_sh, stats = fuse_sh(bg0, TRUE_POSE, pts, normals, rgb)
    assert int(stats.overflow) == 0
    assert int(stats.n_full) > 0

    # fused grid == dense fusion (geometry everywhere, color where fused)
    g_sh = dense_from_brick_grid(bg, PARAMS, bs)
    np.testing.assert_allclose(np.asarray(g_sh.W), np.asarray(g_dense.W),
                               atol=1e-5)
    ok = np.asarray(g_dense.W) > 0
    np.testing.assert_allclose(np.asarray(g_sh.D)[ok],
                               np.asarray(g_dense.D)[ok], atol=1e-5)
    fused_c = np.asarray(g_sh.Wc) > 0
    assert fused_c.sum() > 100
    np.testing.assert_allclose(np.asarray(g_sh.R)[fused_c],
                               np.asarray(g_dense.R)[fused_c], atol=1e-5)

    # the emitted slab-sharded Dm is exactly the masked view of the result
    Dm_ref = np.asarray(masked_view(g_sh.D, g_sh.W))
    np.testing.assert_array_equal(np.isnan(np.asarray(Dm_sh)),
                                  np.isnan(Dm_ref))
    okm = ~np.isnan(Dm_ref)
    np.testing.assert_allclose(np.asarray(Dm_sh)[okm], Dm_ref[okm], atol=0)

    # masked tracking from the sharded Dm == dense tracking
    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    points = strided_points(backproject(CAM, depth), 2)
    xi = jnp.asarray([0.02, -0.015, 0.02, 0.01, -0.015, 0.01],
                     dtype=jnp.float32)
    pose0 = pose_compose(se3_exp(xi), TRUE_POSE)
    tcfg = TrackingConfig(jacobian="analytic", max_iterations=30)
    r_dense = track_frame(g_dense, pose0, points, params=PARAMS, cfg=tcfg)
    track_sh = sharded_track_frame_masked(mesh, params=PARAMS, cfg=tcfg)
    r_sh = track_sh(Dm_sh, pose0, points)
    assert int(r_sh.num_valid) == int(r_dense.num_valid)
    np.testing.assert_allclose(np.asarray(r_sh.pose.t),
                               np.asarray(r_dense.pose.t), atol=5e-5)
    np.testing.assert_allclose(np.asarray(r_sh.pose.R),
                               np.asarray(r_dense.pose.R), atol=5e-5)


def test_sharded_brickmajor_hier_classify_matches_dense(mesh, frame):
    """Per-SLAB hierarchical classification (round 4: the SPMD path now
    runs the super-brick OUT/FREE/OCCLUDED pruning too) must stay
    conservative-exact: sharded hier fusion == dense fusion, and == the
    sharded flat-classify result bitwise."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense, dense_from_brick_grid)
    from tracking_sdf_tpu.parallel import (
        shard_brick_grid, sharded_fuse_frame_brickmajor)

    pts, normals, rgb = frame
    bs = (2, 8, 16)  # slab 6 voxels -> nbi_local=3; factor 3 divides 3/6/3
    base = FusionConfig(fuse_color=False, brick_shape=bs)
    out = {}
    for key, cfg in (("flat", base),
                     ("hier", base._replace(hier_classify=3, cap_mixed=64))):
        fuse_sh = sharded_fuse_frame_brickmajor(
            mesh, params=PARAMS, cam=CAM, cfg=cfg, cap=96, emit_dm=False)
        bg0 = shard_brick_grid(
            brick_grid_from_dense(empty_grid(PARAMS), bs), mesh)
        bg, _, stats = fuse_sh(bg0, TRUE_POSE, pts, normals, None)
        assert int(stats.overflow) == 0
        assert int(stats.overflow_active) == 0
        assert int(stats.overflow_mixed) == 0
        assert int(stats.n_full) > 0
        out[key] = (dense_from_brick_grid(bg, PARAMS, bs), stats)
    # hier == flat bitwise (same proofs, same per-voxel math)
    for name in ("D", "W"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out["hier"][0], name)),
            np.asarray(getattr(out["flat"][0], name)), err_msg=name)
    assert int(out["hier"][1].n_full) == int(out["flat"][1].n_full)
    # and == dense
    g_dense = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, normals, None,
                         params=PARAMS, cam=CAM,
                         cfg=FusionConfig(fuse_color=False))
    np.testing.assert_allclose(np.asarray(out["hier"][0].W),
                               np.asarray(g_dense.W), atol=1e-5)
    okm = np.asarray(g_dense.W) > 0
    np.testing.assert_allclose(np.asarray(out["hier"][0].D)[okm],
                               np.asarray(g_dense.D)[okm], atol=1e-5)


def test_sharded_brickview_tracking_matches_dense(mesh, frame):
    """Zero-relayout SPMD tracking (sharded_track_frame_brickmajor) gathers
    corners straight from the sharded brick-major D rows with one
    ppermute'd brick-layer halo — and must land on the SAME pose as dense
    tracking, with the same valid-pixel count. Also pins that
    emit_dm=False sharded fusion updates the brick rows identically to
    emit_dm=True (Dm is the only difference)."""
    from tracking_sdf_tpu.fusion.brickmajor import brick_grid_from_dense
    from tracking_sdf_tpu.parallel import (
        shard_brick_grid,
        sharded_fuse_frame_brickmajor,
        sharded_track_frame_brickmajor,
    )

    pts, normals, rgb = frame
    bs = (2, 8, 16)
    cfg = FusionConfig(fuse_color=False, brick_shape=bs)
    g_dense = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, normals, None,
                         params=PARAMS, cam=CAM, cfg=cfg)

    fuse_nodm = sharded_fuse_frame_brickmajor(
        mesh, params=PARAMS, cam=CAM, cfg=cfg, cap=96, emit_dm=False)
    bg0 = shard_brick_grid(brick_grid_from_dense(empty_grid(PARAMS), bs), mesh)
    bg, Dm_none, stats = fuse_nodm(bg0, TRUE_POSE, pts, normals, None)
    assert Dm_none is None
    assert int(stats.overflow) == 0

    fuse_dm = sharded_fuse_frame_brickmajor(
        mesh, params=PARAMS, cam=CAM, cfg=cfg, cap=96, emit_dm=True)
    bg0b = shard_brick_grid(brick_grid_from_dense(empty_grid(PARAMS), bs), mesh)
    bg_b, _, _ = fuse_dm(bg0b, TRUE_POSE, pts, normals, None)
    for a, b in zip(jax.tree.leaves(bg), jax.tree.leaves(bg_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    points = strided_points(backproject(CAM, depth), 2)
    xi = jnp.asarray([0.02, -0.015, 0.02, 0.01, -0.015, 0.01],
                     dtype=jnp.float32)
    pose0 = pose_compose(se3_exp(xi), TRUE_POSE)
    tcfg = TrackingConfig(jacobian="analytic", max_iterations=30)
    r_dense = track_frame(g_dense, pose0, points, params=PARAMS, cfg=tcfg)
    track_bv = sharded_track_frame_brickmajor(
        mesh, params=PARAMS, cfg=tcfg, bs=bs)
    r_bv = track_bv(bg.D, pose0, points)
    assert int(r_bv.num_valid) == int(r_dense.num_valid)
    np.testing.assert_allclose(np.asarray(r_bv.pose.t),
                               np.asarray(r_dense.pose.t), atol=5e-5)
    np.testing.assert_allclose(np.asarray(r_bv.pose.R),
                               np.asarray(r_dense.pose.R), atol=5e-5)


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_runner_distributed_brickmajor(mesh, tmp_path_factory, sdt):
    """Full Reconstruction with mesh + mode='brickmajor' (both storage
    dtypes): tracks an orbit like the single-device brickmajor runner and
    reports stats."""
    import dataclasses

    from tracking_sdf_tpu.config import PipelineConfig
    from tracking_sdf_tpu.pipeline import Reconstruction

    tmp = tmp_path_factory.mktemp("dist_bm")
    fcfg = FusionConfig(mode="brickmajor", brick_shape=(2, 8, 16),
                        brick_cap=512, storage_dtype=sdt)
    cfg = PipelineConfig(
        grid=PARAMS, tracking=TrackingConfig(max_iterations=20),
        fusion=fcfg, trajectory_path=str(tmp / "traj.txt"),
        bilateral_filter=False,
    )
    r_sh = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE, mesh=mesh)
    r_1d = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE)
    n = 4
    for i in range(n):
        ang = 0.06 * i
        eye = (1.5 * np.sin(ang), -1.5 * np.cos(ang), 0.25)
        pose = look_at(eye, (0.0, 0.0, 0.0))
        depth = render_scene_depth(SCENE, CAM, pose)
        r_sh.process_frame(depth, timestamp=float(i))
        r_1d.process_frame(depth, timestamp=float(i))
        # any overflow would silently desync the two capacity layouts
        assert int(r_sh.last_fuse_stats.overflow) == 0
        assert int(r_sh.last_fuse_stats.overflow_active) == 0
        assert int(r_1d.last_fuse_stats.overflow) == 0
        assert int(r_1d.last_fuse_stats.overflow_active) == 0
    r_sh.close()
    r_1d.close()
    assert int(r_sh.last_fuse_stats.n_full) > 0
    # same trajectory as the single-device (same-dtype) brickmajor runner
    np.testing.assert_allclose(np.asarray(r_sh.pose.t),
                               np.asarray(r_1d.pose.t), atol=1e-4)
    # dense materialization agrees (W exact-ish in both dtypes: weights
    # stay f32; D carries bf16 store rounding in that mode)
    gs, g1 = r_sh.grid, r_1d.grid
    np.testing.assert_allclose(np.asarray(gs.W), np.asarray(g1.W), atol=1e-3)
    ok = np.asarray(g1.W) > 0
    np.testing.assert_allclose(np.asarray(gs.D)[ok], np.asarray(g1.D)[ok],
                               atol=1e-3 if sdt == "float32" else 1e-2)

    # checkpoint roundtrip through the dense view restores the brick rows
    # bitwise and keeps them sharded
    ckpt = str(tmp / "dist.ckpt")
    r_sh.save_checkpoint(ckpt)
    r_2 = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE, mesh=mesh)
    r_2.restore_checkpoint(ckpt)
    assert r_2.frame_num == r_sh.frame_num
    # compare in f32: numpy's NaN-aware equality doesn't support the
    # ml_dtypes bfloat16 arrays the bf16 mode stores
    np.testing.assert_array_equal(np.asarray(r_2._bgrid.D, np.float32),
                                  np.asarray(r_sh._bgrid.D, np.float32))
    assert len(r_2._bgrid.D.sharding.device_set) == mesh.devices.size


def test_sharded_process_chunk_matches_per_frame(mesh):
    """SPMD chunked processing (round 4): N frames per dispatch with the
    shard-mapped fuse/track inside ONE jitted fori_loop — must land on the
    same trajectory and grid as the per-frame sharded loop (the same
    fixed-cap reassociation tolerance as the single-device chunk test).
    color_every=2 exercises the lax.cond color-cadence gate around the
    shard_maps."""
    from tracking_sdf_tpu.config import PipelineConfig
    from tracking_sdf_tpu.pipeline import Reconstruction

    fcfg = FusionConfig(mode="brickmajor", brick_shape=(2, 8, 16),
                        brick_cap=768, fuse_color=True, color_every=2)
    cfg = PipelineConfig(
        grid=PARAMS, tracking=TrackingConfig(max_iterations=20),
        fusion=fcfg, trajectory_path=None, bilateral_filter=False)
    r_pf = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE, mesh=mesh)
    r_ch = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE, mesh=mesh)
    frames = []
    for i in range(5):
        ang = 0.05 * i
        eye = (1.5 * np.sin(ang), -1.5 * np.cos(ang), 0.25)
        depth = render_scene_depth(SCENE, CAM, look_at(eye, (0.0, 0.0, 0.0)))
        rgb = np.full(depth.shape + (3,), 0.5, np.float32)
        frames.append((np.asarray(depth), rgb))
    # frame 0 bootstraps both runners identically
    r_pf.process_frame(frames[0][0], frames[0][1], timestamp=0.0)
    r_ch.process_frame(frames[0][0], frames[0][1], timestamp=0.0)
    for i, (d, c) in enumerate(frames[1:], start=1):
        r_pf.process_frame(d, c, timestamp=float(i))
    stats = r_ch.process_chunk(
        np.stack([d for d, _ in frames[1:]]),
        np.stack([c for _, c in frames[1:]]),
        timestamps=[float(i) for i in range(1, 5)])
    assert len(stats) == 4 and not any(s.rejected for s in stats)
    assert r_ch.frame_num == r_pf.frame_num == 5
    # misaligned tail chunk (3 % color_every != 0): exercises the lax.cond
    # cadence branch (aligned chunks take the static-unroll path)
    extra = []
    for i in range(5, 8):
        ang = 0.05 * i
        eye = (1.5 * np.sin(ang), -1.5 * np.cos(ang), 0.25)
        depth = render_scene_depth(SCENE, CAM, look_at(eye, (0.0, 0.0, 0.0)))
        extra.append((np.asarray(depth),
                      np.full(depth.shape + (3,), 0.5, np.float32)))
    for i, (d, c) in enumerate(extra, start=5):
        r_pf.process_frame(d, c, timestamp=float(i))
    r_ch.process_chunk(np.stack([d for d, _ in extra]),
                       np.stack([c for _, c in extra]),
                       timestamps=[float(i) for i in range(5, 8)])
    np.testing.assert_allclose(np.asarray(r_ch.pose.t),
                               np.asarray(r_pf.pose.t), atol=2e-4)
    g_pf, g_ch = r_pf.grid, r_ch.grid
    np.testing.assert_allclose(np.asarray(g_ch.W), np.asarray(g_pf.W),
                               atol=1e-3)
    okc = np.asarray(g_pf.W) > 0
    np.testing.assert_allclose(np.asarray(g_ch.D)[okc],
                               np.asarray(g_pf.D)[okc], atol=2e-3)
    # color fused on the cadence frames only, identically in both paths
    np.testing.assert_allclose(np.asarray(g_ch.Wc), np.asarray(g_pf.Wc),
                               atol=1e-3)
    r_pf.close()
    r_ch.close()


def test_sharded_marching_cubes_matches_dense(mesh, frame):
    """Per-slab meshing + concat (reference P3, marching_cubes_sdf.cpp:
    264-284) must produce exactly the unsharded mesher's triangles (same
    order: slabs ascend in i, row-major within) and colors."""
    from tracking_sdf_tpu.render.marching_cubes import (
        marching_cubes, marching_cubes_sharded)

    pts, normals, rgb = frame
    cfg = FusionConfig(fuse_color=True)
    grid = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, normals, rgb,
                      params=PARAMS, cam=CAM, cfg=cfg)
    ref = marching_cubes(grid, params=PARAMS, with_colors=True)
    assert ref.num_triangles > 300
    sh = marching_cubes_sharded(shard_grid(grid, mesh), params=PARAMS,
                                with_colors=True)
    assert sh.num_triangles == ref.num_triangles
    assert sh.dropped_cells == 0
    np.testing.assert_allclose(sh.vertices, ref.vertices, atol=1e-6)
    np.testing.assert_allclose(sh.colors, ref.colors, atol=1e-6)


def test_sharded_raycast_matches_single(mesh):
    """Ray-sharded SPMD renderer == single-device raycast BITWISE: each
    device all-gathers the grid once and marches its ray block with the
    identical program (VERDICT r4 item 4)."""
    from tracking_sdf_tpu.parallel import sharded_raycast
    from tracking_sdf_tpu.render.raycast import raycast
    from tracking_sdf_tpu.config import RaycastConfig
    from tracking_sdf_tpu.tracking import estimate_normals

    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    pts = backproject(CAM, depth)
    nrm = estimate_normals(pts)
    rgb = jnp.stack([jnp.full(depth.shape, 0.6), jnp.full(depth.shape, 0.3),
                     jnp.full(depth.shape, 0.2)], -1).astype(jnp.float32)
    grid = fuse_frame(empty_grid(PARAMS), TRUE_POSE, pts, nrm, rgb,
                      params=PARAMS, cam=CAM, cfg=FusionConfig())

    pose = look_at((0.1, -1.7, 0.5), (0.0, 0.0, 0.0))
    for with_color, cfg in ((False, RaycastConfig()),
                            (True, RaycastConfig(far_field="chamfer"))):
        fn = sharded_raycast(mesh, params=PARAMS, cam=CAM, cfg=cfg,
                             with_color=with_color)
        r_sh = fn(shard_grid(grid, mesh), pose)
        r_1 = raycast(grid, pose, params=PARAMS, cam=CAM, cfg=cfg,
                      with_color=with_color)
        for name, a, b in zip(r_sh._fields, r_sh, r_1):
            if a is None or name == "dropped":
                continue
            aa, bb = np.asarray(a), np.asarray(b)
            same = (aa == bb) | (np.isnan(aa.astype(np.float64))
                                 & np.isnan(bb.astype(np.float64))) \
                if aa.dtype.kind == "f" else (aa == bb)
            assert np.asarray(same).all(), (
                f"{name}: {np.count_nonzero(~np.asarray(same))} mismatches "
                f"(with_color={with_color})")
        assert np.asarray(r_sh.hit).sum() > 300


def test_runner_distributed_brickmajor_pyramid(mesh):
    """With a coarse-to-fine pyramid the sharded runner must track the way
    the single-device runner does (same levels, same per-level configs) —
    per frame and chunked — so one preset gives one trajectory on one
    device or a mesh."""
    from tracking_sdf_tpu.config import PipelineConfig
    from tracking_sdf_tpu.pipeline import Reconstruction

    fcfg = FusionConfig(mode="brickmajor", brick_shape=(2, 8, 16),
                        brick_cap=768, fuse_color=False)
    cfg = PipelineConfig(
        grid=PARAMS, tracking=TrackingConfig(max_iterations=20,
                                             min_iterations=2),
        fusion=fcfg, trajectory_path=None, bilateral_filter=False,
        pyramid_levels=(2, 1))
    r_sh = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE, mesh=mesh)
    r_ch = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE, mesh=mesh)
    r_ch.chunk_phase_metrics = False
    r_1d = Reconstruction(CAM, cfg, initial_pose=TRUE_POSE)
    depths = []
    for i in range(5):
        ang = 0.06 * i
        eye = (1.5 * np.sin(ang), -1.5 * np.cos(ang), 0.25)
        depths.append(np.asarray(render_scene_depth(
            SCENE, CAM, look_at(eye, (0.0, 0.0, 0.0)))))
    iters_sh, iters_1d = [], []
    for i, d in enumerate(depths):
        iters_sh.append(r_sh.process_frame(d, timestamp=float(i))
                        .gn_iterations)
        iters_1d.append(r_1d.process_frame(d, timestamp=float(i))
                        .gn_iterations)
    r_ch.process_frame(depths[0], timestamp=0.0)
    r_ch.process_chunk(np.stack(depths[1:]),
                       timestamps=[float(i) for i in range(1, 5)])
    # the fine level's iteration count (min_iterations applies there)
    assert iters_sh == iters_1d
    for r in (r_sh, r_ch):
        np.testing.assert_allclose(np.asarray(r.pose.t),
                                   np.asarray(r_1d.pose.t), atol=1e-4)
        np.testing.assert_allclose(np.asarray(r.pose.R),
                                   np.asarray(r_1d.pose.R), atol=1e-4)
    for r in (r_sh, r_ch, r_1d):
        r.close()
