"""Brick-compacted fusion vs the dense reference path: exact equivalence.

The bricked path's classification is conservative-exact: OUT/FREE bricks
produce exactly the per-voxel numbers of the dense path, FULL bricks run the
identical math on compacted voxels. Geometry (D, W) must therefore match the
dense path everywhere (up to f32 association in the merge); color matches
inside FULL bricks (the bricked path deliberately fuses color only there).
"""
import jax.numpy as jnp
import pytest
import numpy as np

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene,
    SphereScene,
    look_at,
    render_scene_depth,
)
from tracking_sdf_tpu.fusion.brick import fuse_frame_bricked
from tracking_sdf_tpu.fusion.fuse import fuse_frame
from tracking_sdf_tpu.grid.grid import empty_grid
from tracking_sdf_tpu.tracking import estimate_normals

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
BS = (8, 8, 16)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
# Backdrop wall filling the whole FOV: dense valid depth like a real indoor
# TUM frame, so free-space (FREE) bricks actually occur.
WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))


class Scene:
    def sdf(self, x):
        return jnp.minimum(jnp.minimum(SPHERE.sdf(x), BOX.sdf(x)), WALL.sdf(x))

    def color(self, x):
        return SPHERE.color(x)

    def intersect(self, o, d):
        t = SPHERE.intersect(o, d)
        for s in (BOX, WALL):
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb,
                          jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


SCENE = Scene()
TSDF_FIELDS = ("D", "W", "R", "G", "B", "Wc")
POSES = [
    look_at((0.0, -1.5, 0.25), (0.0, 0.0, 0.0)),
    look_at((0.4, -1.4, 0.1), (0.0, 0.0, 0.0)),
]


def _frame(pose):
    depth = render_scene_depth(SCENE, CAM, pose)
    pts = backproject(CAM, depth)
    normals = estimate_normals(pts)
    rgb = jnp.stack([
        jnp.full(depth.shape, 0.7), jnp.full(depth.shape, 0.4),
        jnp.full(depth.shape, 0.2)], axis=-1).astype(jnp.float32)
    return pts, normals, rgb


def test_bricked_matches_dense_geometry_two_frames():
    cfg = FusionConfig(fuse_color=False)
    gd = empty_grid(PARAMS)
    gb = empty_grid(PARAMS)
    for pose in POSES:
        pts, normals, _ = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, None,
                        params=PARAMS, cam=CAM, cfg=cfg)
        gb, stats = fuse_frame_bricked(gb, pose, pts, normals, None,
                                       params=PARAMS, cam=CAM, cfg=cfg,
                                       bs=BS, cap=128)
        assert int(stats.overflow) == 0
        assert int(stats.n_full) > 0
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)


def test_free_bricks_classified_and_exact_on_wall_scene():
    """A flat far wall: near-camera bricks are provably free space and must
    take the FREE fast path while still producing the dense path's numbers."""
    cfg = FusionConfig(fuse_color=False)
    pose = look_at((0.0, -1.5, 0.0), (0.0, 1.0, 0.0))
    wall_only = WALL
    depth = render_scene_depth(wall_only, CAM, pose)
    pts = backproject(CAM, depth)
    normals = estimate_normals(pts)
    gd = fuse_frame(empty_grid(PARAMS), pose, pts, normals, None,
                    params=PARAMS, cam=CAM, cfg=cfg)
    gb, stats = fuse_frame_bricked(empty_grid(PARAMS), pose, pts, normals, None,
                                   params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=128)
    assert int(stats.n_free) > 0, "wall scene must produce FREE bricks"
    assert int(stats.overflow) == 0
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)


def test_bricked_color_matches_dense_in_band():
    cfg = FusionConfig(fuse_color=True)
    pts, normals, rgb = _frame(POSES[0])
    gd = fuse_frame(empty_grid(PARAMS), POSES[0], pts, normals, rgb,
                    params=PARAMS, cam=CAM, cfg=cfg)
    gb, _ = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals, rgb,
                               params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=128)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    # wherever the bricked path fused color, it matches the dense path
    fused_c = np.asarray(gb.Wc) > 0
    assert fused_c.sum() > 100
    np.testing.assert_allclose(np.asarray(gb.Wc)[fused_c],
                               np.asarray(gd.Wc)[fused_c], atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.R)[fused_c],
                               np.asarray(gd.R)[fused_c], atol=1e-5)
    # and the near-surface band (where renders read color) is fully covered
    near = (np.abs(np.asarray(gd.D)) < PARAMS.delta / 2) & (np.asarray(gd.Wc) > 0)
    assert near.sum() > 0
    assert (fused_c | ~near).all()


def test_bricked_overflow_reported_and_grid_still_valid():
    cfg = FusionConfig(fuse_color=False)
    pts, normals, _ = _frame(POSES[0])
    gb, stats = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals,
                                   None, params=PARAMS, cam=CAM, cfg=cfg,
                                   bs=BS, cap=2)
    assert int(stats.overflow) > 0
    assert bool(jnp.isfinite(gb.D).all())
    # dropped bricks simply keep their old values; FREE updates still applied
    assert float(gb.W.sum()) > 0


def test_rows_merge_matches_xla_merge():
    """The row-granular gather/scatter-set tail must produce the XLA
    scatter+accumulator tail's numbers exactly (incl. FREE-brick updates,
    color, padding, and the no-free-bricks case)."""
    for fuse_color in (False, True):
        cfg = FusionConfig(fuse_color=fuse_color)
        gx = empty_grid(PARAMS)
        gr = empty_grid(PARAMS)
        for pose in POSES:
            pts, normals, rgb = _frame(pose)
            rgb_in = rgb if fuse_color else None
            gx, sx = fuse_frame_bricked(
                gx, pose, pts, normals, rgb_in, params=PARAMS, cam=CAM,
                cfg=cfg, bs=BS, cap=128, merge="xla")
            gr, sr = fuse_frame_bricked(
                gr, pose, pts, normals, rgb_in, params=PARAMS, cam=CAM,
                cfg=cfg, bs=BS, cap=128, merge="rows")
            assert int(sr.overflow_active) == 0
            assert int(sr.n_free) == int(sx.n_free)
        for name in TSDF_FIELDS:
            np.testing.assert_allclose(
                np.asarray(getattr(gx, name)), np.asarray(getattr(gr, name)),
                atol=1e-5, err_msg=f"{name} color={fuse_color}")


def test_rows_merge_free_overflow_reported():
    """cap_free smaller than the FREE count: overflow_active reports the
    dropped bricks and the grid stays finite."""
    cfg = FusionConfig(fuse_color=False)
    pose = look_at((0.0, -1.5, 0.0), (0.0, 1.0, 0.0))
    depth = render_scene_depth(WALL, CAM, pose)
    pts = backproject(CAM, depth)
    normals = estimate_normals(pts)
    gr, sr = fuse_frame_bricked(empty_grid(PARAMS), pose, pts, normals, None,
                                params=PARAMS, cam=CAM, cfg=cfg, bs=BS,
                                cap=128, merge="rows", cap_free=1)
    assert int(sr.n_free) > 1
    assert int(sr.overflow_active) == int(sr.n_free) - 1
    assert bool(jnp.isfinite(gr.D).all())


def test_pixel_share_close_to_exact():
    """pixel_share=2 (approximate fast mode) must stay within a few mm of
    the exact path away from silhouettes, and keep identical W support."""
    for share in (2, 4):
        cfg1 = FusionConfig(fuse_color=False)
        cfg2 = FusionConfig(fuse_color=False, pixel_share=share)
        pts, normals, _ = _frame(POSES[0])
        g1, _ = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals,
                                   None, params=PARAMS, cam=CAM, cfg=cfg1,
                                   bs=BS, cap=128)
        g2, _ = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals,
                                   None, params=PARAMS, cam=CAM, cfg=cfg2,
                                   bs=BS, cap=128)
        D1, D2 = np.asarray(g1.D), np.asarray(g2.D)
        W1, W2 = np.asarray(g1.W), np.asarray(g2.W)
        both = (W1 > 0) & (W2 > 0)
        assert both.sum() > 1000
        # at least 98% of commonly-observed voxels within 2 voxel sizes
        diff = np.abs(D1[both] - D2[both])
        assert np.quantile(diff, 0.98) < 2 * PARAMS.width / PARAMS.m, share
        # support differs only in a thin boundary band
        assert ((W1 > 0) != (W2 > 0)).mean() < 0.02


def test_factored_share_config_bitwise_inert():
    """FusionConfig.factored_share (the jit-cache-keyed replacement for the
    TSDF_FACTORED_SHARE env knob, ADVICE r2) is an HLO-shape A/B only: both
    variants must produce bitwise-identical grids."""
    pts, normals, _ = _frame(POSES[0])
    grids = []
    for fac in (False, True):
        cfg = FusionConfig(fuse_color=False, pixel_share=2, pixel_share_j=2,
                           factored_share=fac)
        g, _ = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals,
                                  None, params=PARAMS, cam=CAM, cfg=cfg,
                                  bs=BS, cap=128)
        grids.append(g)
    np.testing.assert_array_equal(np.asarray(grids[0].D), np.asarray(grids[1].D))
    np.testing.assert_array_equal(np.asarray(grids[0].W), np.asarray(grids[1].W))


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_bricked_matches_dense_nan_speckle(distance):
    """Fuzz the classification proofs: random camera poses (including views
    from inside the volume and oblique angles) and random NaN speckle must
    never break bricked == dense geometry — in BOTH distance modes (the
    point-to-point zeta proof is z_y - delta, fusion/brick._zeta_mip).

    (Was a duplicate of test_bricked_matches_dense_randomized below, which
    silently shadowed this one — renamed.)"""
    rng = np.random.default_rng(7)
    cfg = FusionConfig(fuse_color=False, distance=distance)
    for trial in range(4):
        eye = rng.uniform([-1.3, -1.8, -0.6], [1.3, -0.4, 0.8])
        target = rng.uniform(-0.4, 0.4, 3)
        pose = look_at(tuple(eye), tuple(target))
        depth = render_scene_depth(SCENE, CAM, pose)
        depth = np.asarray(depth)
        speckle = rng.random(depth.shape) < 0.05
        depth = np.where(speckle, np.nan, depth)
        pts = backproject(CAM, jnp.asarray(depth))
        normals = estimate_normals(pts)

        gd = fuse_frame(empty_grid(PARAMS), pose, pts, normals, None,
                        params=PARAMS, cam=CAM, cfg=cfg)
        gb, stats = fuse_frame_bricked(
            empty_grid(PARAMS), pose, pts, normals, None,
            params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=220)
        assert int(stats.overflow) == 0, trial
        np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W),
                                   atol=1e-5, err_msg=f"trial {trial}")
        np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D),
                                   atol=1e-5, err_msg=f"trial {trial}")


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_occluded_bricks_classified_and_exact(distance):
    """Bricks provably behind every candidate surface (d < -delta at every
    voxel) produce zero update in the dense path; the classifier must fold
    them into class 0 (the eta max-mip proof, _zeta_mip) — at 512^3 they
    were 39-40% of FULL bricks — while bricked == dense stays exact."""
    from tracking_sdf_tpu.fusion.brick import classify_bricks

    cfg = FusionConfig(fuse_color=False, distance=distance)
    # mid-grid wall: roughly half the volume sits deep behind the surface
    wall = CuboidScene(min_corner=(-4.0, 0.0, -4.0), max_corner=(4.0, 4.0, 4.0))
    pose = look_at((0.0, -0.9, 0.0), (0.0, 1.0, 0.0))
    depth = render_scene_depth(wall, CAM, pose)
    pts = backproject(CAM, depth)
    nrm = estimate_normals(pts)

    bc = classify_bricks(PARAMS, pose, pts, nrm, CAM, BS, jnp.float32,
                         PARAMS.m // BS[0], 0, distance)
    # bricks well behind the wall (y > delta + a brick) and inside the
    # frustum must be class 0 even though they are in front of the camera
    yc = (jnp.arange(PARAMS.m // BS[1]) * BS[1] + BS[1] / 2) \
        * (PARAMS.height / PARAMS.m) + PARAMS.origin[1]
    deep = np.asarray(bc)[:, np.asarray(yc) > 0.4, :]
    assert (deep == 0).all(), "deep-behind-wall bricks must classify OUT"
    assert int(np.sum(np.asarray(bc) == 2)) > 0  # band bricks remain FULL

    gd = fuse_frame(empty_grid(PARAMS), pose, pts, nrm, None,
                    params=PARAMS, cam=CAM, cfg=cfg)
    gb, stats = fuse_frame_bricked(
        empty_grid(PARAMS), pose, pts, nrm, None,
        params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=220)
    assert int(stats.overflow) == 0
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)


def test_bricked_nan_frame_is_noop():
    cfg = FusionConfig(fuse_color=False)
    nanimg = jnp.full((72, 96, 3), jnp.nan, jnp.float32)
    g0 = empty_grid(PARAMS)
    gb, stats = fuse_frame_bricked(g0, POSES[0], nanimg, nanimg, None,
                                   params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=64)
    assert float(gb.W.sum()) == 0.0
    assert int(stats.n_free) == 0
    assert bool(jnp.isfinite(gb.D).all())


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_brickmajor_matches_dense(distance):
    """Brick-MAJOR storage fusion == dense fusion (geometry everywhere,
    color in fused-color voxels), and the emitted Dm is exactly the masked
    view of the merged grid. Both distance modes (paper Table I axis) —
    the flagship layout must run the paper's best-accuracy variant."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        dense_from_brick_grid,
        fuse_frame_brickmajor,
    )
    from tracking_sdf_tpu.grid.interp import masked_view

    cfg = FusionConfig(fuse_color=True, distance=distance)
    gd = empty_grid(PARAMS)
    bg = brick_grid_from_dense(empty_grid(PARAMS), BS)
    Dm = None
    for pose in POSES:
        pts, normals, rgb = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, rgb,
                        params=PARAMS, cam=CAM, cfg=cfg)
        bg, Dm, stats = fuse_frame_brickmajor(
            bg, pose, pts, normals, rgb, params=PARAMS, cam=CAM, cfg=cfg,
            bs=BS, cap=220)
        assert int(stats.overflow) == 0
        assert int(stats.n_full) > 0
    gb = dense_from_brick_grid(bg, PARAMS, BS)
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)
    fused_c = np.asarray(gb.Wc) > 0
    assert fused_c.sum() > 100
    np.testing.assert_allclose(np.asarray(gb.R)[fused_c],
                               np.asarray(gd.R)[fused_c], atol=1e-5)
    # the emitted Dm equals masked_view of the merged dense grid
    Dm_ref = np.asarray(masked_view(gb.D, gb.W))
    np.testing.assert_array_equal(np.isnan(np.asarray(Dm)), np.isnan(Dm_ref))
    ok = ~np.isnan(Dm_ref)
    np.testing.assert_allclose(np.asarray(Dm)[ok], Dm_ref[ok], atol=1e-6)


@pytest.mark.parametrize("factor", [2, 3])
def test_brickmajor_hier_classify_matches_flat(factor):
    """Hierarchical (super-brick) classification == flat classification ==
    dense, bit-for-bit on every leaf: the super-level OUT/FREE/OCCLUDED
    proofs are monotone (classify_compact_hier docstring), so descending
    only into MIXED supers must not change a single fused voxel. Also pins
    equal n_full/n_free stats — the classification itself is identical,
    not merely fuse-equivalent."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        dense_from_brick_grid,
        fuse_frame_brickmajor,
    )

    bs = (8, 8, 8)  # nb = (6, 6, 6): divisible by both factors
    cfg_flat = FusionConfig(fuse_color=True)
    cfg_hier = cfg_flat._replace(hier_classify=factor, cap_mixed=256)
    gd = empty_grid(PARAMS)
    bg_f = brick_grid_from_dense(empty_grid(PARAMS), bs)
    bg_h = brick_grid_from_dense(empty_grid(PARAMS), bs)
    for pose in POSES:
        pts, normals, rgb = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, rgb,
                        params=PARAMS, cam=CAM, cfg=cfg_flat)
        bg_f, _, st_f = fuse_frame_brickmajor(
            bg_f, pose, pts, normals, rgb, params=PARAMS, cam=CAM,
            cfg=cfg_flat, bs=bs, cap=256)
        bg_h, _, st_h = fuse_frame_brickmajor(
            bg_h, pose, pts, normals, rgb, params=PARAMS, cam=CAM,
            cfg=cfg_hier, bs=bs, cap=256)
        assert int(st_h.n_full) == int(st_f.n_full)
        assert int(st_h.n_free) == int(st_f.n_free)
        assert int(st_h.overflow) == 0
        assert int(st_h.overflow_mixed) == 0
        assert int(st_h.overflow_active) == 0
    for name, lf, lh in zip(TSDF_FIELDS, bg_f, bg_h):
        np.testing.assert_array_equal(
            np.asarray(lf), np.asarray(lh), err_msg=name)
    gb = dense_from_brick_grid(bg_h, PARAMS, bs)
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)


def test_brickmajor_hier_overflow_mixed_reported():
    """Mixed super-bricks beyond cap_mixed are dropped for the frame and
    REPORTED (FuseStats.overflow_mixed) — the reported-never-silent cap
    contract extends to the hierarchy level."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        fuse_frame_brickmajor,
    )

    bs = (8, 8, 8)
    cfg = FusionConfig(fuse_color=False, hier_classify=2, cap_mixed=2)
    bg = brick_grid_from_dense(empty_grid(PARAMS), bs)
    pts, normals, rgb = _frame(POSES[0])
    bg, _, stats = fuse_frame_brickmajor(
        bg, POSES[0], pts, normals, None, params=PARAMS, cam=CAM, cfg=cfg,
        bs=bs, cap=256)
    assert int(stats.overflow_mixed) > 0


def test_brickmajor_bfloat16_storage_close_to_dense():
    """bfloat16 VALUE-leaf storage (FusionConfig.storage_dtype): weights
    stay float32 and must match the dense path exactly; D/color carry only
    per-store rounding (quantum delta/256 resp. 1/256), so multi-frame
    fusion stays within a few quanta of the f32 dense result. Tracking
    interpolation against the bf16 view must run in float32."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        brick_masked_view,
        dense_from_brick_grid,
        fuse_frame_brickmajor,
    )
    from tracking_sdf_tpu.grid.interp import trilinear_with_grad_nan

    cfg = FusionConfig(fuse_color=True)
    gd = empty_grid(PARAMS)
    bg = brick_grid_from_dense(empty_grid(PARAMS), BS,
                               value_dtype=jnp.bfloat16)
    assert bg.D.dtype == jnp.bfloat16 and bg.W.dtype == jnp.float32
    for pose in POSES:
        pts, normals, rgb = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, rgb,
                        params=PARAMS, cam=CAM, cfg=cfg)
        bg, Dm, stats = fuse_frame_brickmajor(
            bg, pose, pts, normals, rgb, params=PARAMS, cam=CAM, cfg=cfg,
            bs=BS, cap=220)
        assert int(stats.overflow) == 0
        assert bg.D.dtype == jnp.bfloat16 and bg.W.dtype == jnp.float32
    gb = dense_from_brick_grid(bg, PARAMS, BS)
    assert gb.D.dtype == jnp.float32  # export surface upcasts
    # weights are f32 accumulators: exact vs dense
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    # values: within a few bf16 quanta (|D| <= delta -> quantum ~delta/256)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D),
                               atol=4 * PARAMS.delta / 256)
    fused_c = np.asarray(gb.Wc) > 0
    assert fused_c.sum() > 100
    np.testing.assert_allclose(np.asarray(gb.R)[fused_c],
                               np.asarray(gd.R)[fused_c], atol=4 / 256)

    # interpolation math promotes to f32 (value AND gradient)
    view = brick_masked_view(bg, PARAMS, BS)
    q = jnp.asarray([[20.2, 21.7, 22.4], [5.5, 30.1, 11.9]], jnp.float32)
    v, g, ok = trilinear_with_grad_nan(view, q)
    assert v.dtype == jnp.float32 and g.dtype == jnp.float32


def test_brick_grid_roundtrip():
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        dense_from_brick_grid,
        empty_brick_grid,
    )

    g = empty_grid(PARAMS)
    # observed half (W > 0): D must roundtrip exactly; unobserved half
    # (W = 0): the brick-major storage invariant (D = NaN there) makes D
    # canonicalize back to the dense far value, whatever was stored.
    D = jnp.arange(PARAMS.m ** 3, dtype=jnp.float32).reshape(
        PARAMS.m, PARAMS.m, PARAMS.m)
    W = (D % 2 == 0).astype(jnp.float32)
    g = g._replace(D=D, W=W)
    bg = brick_grid_from_dense(g, BS)
    g2 = dense_from_brick_grid(bg, PARAMS, BS)
    far = PARAMS.width + PARAMS.height + PARAMS.depth
    expect = np.where(np.asarray(W) > 0, np.asarray(D), np.float32(far))
    np.testing.assert_array_equal(np.asarray(g2.D), expect)
    np.testing.assert_array_equal(np.asarray(g2.W), np.asarray(W))
    be = empty_brick_grid(PARAMS, BS)
    ge = dense_from_brick_grid(be, PARAMS, BS)
    np.testing.assert_array_equal(np.asarray(ge.D), np.asarray(empty_grid(PARAMS).D))


def test_pixel_share_j_close_and_plane_exact():
    """pixel_share_j (2x2 sharing): same closeness bound as pixel_share,
    plus an EXACTNESS oracle — on a single plane filling the FOV, every
    pixel carries the same plane, so which pixel a voxel reads cannot
    matter: shared == exact bit-for-bit (masks aside, support identical)."""
    cfg1 = FusionConfig(fuse_color=False)
    cfg22 = FusionConfig(fuse_color=False, pixel_share=2, pixel_share_j=2)

    # closeness on the full scene
    pts, normals, _ = _frame(POSES[0])
    g1, _ = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals,
                               None, params=PARAMS, cam=CAM, cfg=cfg1,
                               bs=BS, cap=128)
    g2, _ = fuse_frame_bricked(empty_grid(PARAMS), POSES[0], pts, normals,
                               None, params=PARAMS, cam=CAM, cfg=cfg22,
                               bs=BS, cap=128)
    D1, D2 = np.asarray(g1.D), np.asarray(g2.D)
    W1, W2 = np.asarray(g1.W), np.asarray(g2.W)
    both = (W1 > 0) & (W2 > 0)
    assert both.sum() > 1000
    diff = np.abs(D1[both] - D2[both])
    assert np.quantile(diff, 0.98) < 2 * PARAMS.width / PARAMS.m
    assert ((W1 > 0) != (W2 > 0)).mean() < 0.02

    # plane-exactness oracle: wall-only scene -> one plane everywhere
    pose = POSES[0]
    depth = render_scene_depth(WALL, CAM, pose)
    ppts = backproject(CAM, depth)
    pnrm = estimate_normals(ppts)
    ga, _ = fuse_frame_bricked(empty_grid(PARAMS), pose, ppts, pnrm, None,
                               params=PARAMS, cam=CAM, cfg=cfg1, bs=BS,
                               cap=256)
    gb, _ = fuse_frame_bricked(empty_grid(PARAMS), pose, ppts, pnrm, None,
                               params=PARAMS, cam=CAM, cfg=cfg22, bs=BS,
                               cap=256)
    Wa, Wb = np.asarray(ga.W), np.asarray(gb.W)
    ok = (Wa > 0) & (Wb > 0)
    assert ok.sum() > 500
    # identical plane => identical point-to-plane distances; small residual
    # tolerance covers the estimated normals' pixel-to-pixel jitter
    np.testing.assert_allclose(np.asarray(gb.D)[ok], np.asarray(ga.D)[ok],
                               atol=5e-3)


def test_packed_matches_dense():
    """PACKED one-array fusion == dense fusion (geometry everywhere, color
    in fused-color voxels), and its zero-copy pitch view interpolates
    identically to the dense masked view (value, gradient, and validity)."""
    from tracking_sdf_tpu.fusion.packed import (
        dense_from_packed,
        empty_packed_grid,
        fuse_frame_packed,
    )
    from tracking_sdf_tpu.grid.interp import masked_view, trilinear_with_grad_nan

    cfg = FusionConfig(fuse_color=True)
    gd = empty_grid(PARAMS)
    pg = empty_packed_grid(PARAMS, BS)
    view = None
    for pose in POSES:
        pts, normals, rgb = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, rgb,
                        params=PARAMS, cam=CAM, cfg=cfg)
        pg, view, stats = fuse_frame_packed(
            pg, pose, pts, normals, rgb, params=PARAMS, cam=CAM, cfg=cfg,
            bs=BS, cap=220)
        assert int(stats.overflow) == 0
        assert int(stats.n_full) > 0
    gp = dense_from_packed(pg, PARAMS, BS)
    np.testing.assert_allclose(np.asarray(gp.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gp.D), np.asarray(gd.D), atol=1e-5)
    fused_c = np.asarray(gp.Wc) > 0
    assert fused_c.sum() > 100
    for ch in ("R", "G", "B", "Wc"):
        np.testing.assert_allclose(
            np.asarray(getattr(gp, ch))[fused_c],
            np.asarray(getattr(gd, ch))[fused_c], atol=1e-5, err_msg=ch)

    # zero-copy view parity: the packed pitch view (D rows interleaved with
    # the other channels at stride C*BV) must interpolate exactly like the
    # flat masked view — value, analytic gradient, and validity mask.
    rng = np.random.default_rng(3)
    q = jnp.asarray(rng.uniform(-1.0, PARAMS.m, size=(512, 3)), jnp.float32)
    Dm_ref = masked_view(gp.D, gp.W)
    v_ref, g_ref, ok_ref = trilinear_with_grad_nan(Dm_ref, q)
    v, g, ok = trilinear_with_grad_nan(view, q)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=1e-6)


def test_packed_geometry_only_matches_dense():
    """rgb=None fuses only the (D, W) channel rows (nch=2): geometry matches
    dense and the color channels stay at their init values."""
    from tracking_sdf_tpu.fusion.packed import (
        dense_from_packed,
        empty_packed_grid,
        fuse_frame_packed,
    )

    cfg = FusionConfig(fuse_color=False)
    gd = empty_grid(PARAMS)
    pg = empty_packed_grid(PARAMS, BS)
    for pose in POSES:
        pts, normals, _ = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, None,
                        params=PARAMS, cam=CAM, cfg=cfg)
        pg, _, stats = fuse_frame_packed(
            pg, pose, pts, normals, None, params=PARAMS, cam=CAM, cfg=cfg,
            bs=BS, cap=220, emit_dm=False)
        assert int(stats.overflow) == 0
    gp = dense_from_packed(pg, PARAMS, BS)
    np.testing.assert_allclose(np.asarray(gp.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gp.D), np.asarray(gd.D), atol=1e-5)
    assert float(np.asarray(gp.Wc).max()) == 0.0
    np.testing.assert_array_equal(np.asarray(gp.R), np.float32(0.4))


def test_packed_grid_roundtrip():
    from tracking_sdf_tpu.fusion.packed import (
        dense_from_packed,
        empty_packed_grid,
        packed_from_dense,
    )

    g = empty_grid(PARAMS)
    D = jnp.arange(PARAMS.m ** 3, dtype=jnp.float32).reshape(
        PARAMS.m, PARAMS.m, PARAMS.m)
    W = (D % 2 == 0).astype(jnp.float32)
    g = g._replace(D=D, W=W)
    g2 = dense_from_packed(packed_from_dense(g, BS), PARAMS, BS)
    far = PARAMS.width + PARAMS.height + PARAMS.depth
    expect = np.where(np.asarray(W) > 0, np.asarray(D), np.float32(far))
    np.testing.assert_array_equal(np.asarray(g2.D), expect)
    np.testing.assert_array_equal(np.asarray(g2.W), np.asarray(W))
    ge = dense_from_packed(empty_packed_grid(PARAMS, BS), PARAMS, BS)
    np.testing.assert_array_equal(np.asarray(ge.D),
                                  np.asarray(empty_grid(PARAMS).D))


def test_classifier_left_edge_trunc_band_matches_dense():
    """OUT classification must honor C-cast truncation parity: u in (-1, 0)
    truncates to pixel 0 and IS fused by the dense path (fuse.py:159), so a
    brick whose hull-max u lands in (-1, 0) may not be classified OUT.
    Regression for the `u1 < 0` vs `u1 <= -1` bound (found by review):
    grid positioned so bricks straddle the left image edge."""
    params = GridParams(m=16, width=2.0, height=2.0, depth=2.0,
                        origin=(-1.35, -1.0, -1.0), delta=0.3, epsilon=0.05)
    cam = PinholeCamera(fx=20.0, fy=20.0, cx=8.0, cy=8.0,
                        width=16, height=16)
    # flat wall straight ahead: valid depth in image column 0
    h, w = cam.height, cam.width
    jj, ii = jnp.meshgrid(jnp.arange(w, dtype=jnp.float32),
                          jnp.arange(h, dtype=jnp.float32))
    z = jnp.full((h, w), 2.0, jnp.float32)
    pts = jnp.stack([(jj - cam.cx) / cam.fx * z,
                     (ii - cam.cy) / cam.fy * z, z], axis=-1)
    nrm = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
                           (h, w, 3))
    from tracking_sdf_tpu.core.lie import pose_identity
    pose = pose_identity()
    cfg = FusionConfig(fuse_color=False)

    gd = fuse_frame(empty_grid(params), pose, pts, nrm, None,
                    params=params, cam=cam, cfg=cfg)
    gb, stats = fuse_frame_bricked(
        empty_grid(params), pose, pts, nrm, None,
        params=params, cam=cam, cfg=cfg, bs=(4, 4, 4), cap=64)
    assert int(stats.overflow) == 0
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.D), np.asarray(gd.D), atol=1e-5)
    assert float(gd.W.sum()) > 0


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_bricked_matches_dense_randomized(distance):
    """Property test: bricked == dense fusion over randomized cameras,
    grid placements (including grids straddling the image edges), brick
    shapes, and scene poses. The u1<0-vs-<=-1 classifier bug lived in a
    one-pixel band only specific placements hit — sweep placements
    instead of waiting for the next special case."""
    rng = np.random.default_rng(7)

    for trial in range(10):
        m = int(rng.choice([16, 24, 32]))
        bs = tuple(int(b) for b in rng.choice(
            [(4, 4, 4), (2, 8, 8), (8, 4, 2), (1, 8, 16)]))
        if any(m % b for b in bs):
            continue
        origin = (-1.0 + float(rng.uniform(-0.6, 0.2)),
                  -1.0 + float(rng.uniform(-0.4, 0.2)),
                  -1.0 + float(rng.uniform(-0.3, 0.3)))
        params = GridParams(m=m, width=2.0, height=2.0, depth=2.0,
                            origin=origin, delta=0.25, epsilon=0.05)
        cam = PinholeCamera(
            fx=float(rng.uniform(15, 40)), fy=float(rng.uniform(15, 40)),
            cx=float(rng.uniform(4, 12)), cy=float(rng.uniform(4, 12)),
            width=16, height=16)
        # wall + sphere scene rendered from a jittered pose
        scene = SphereScene(center=(float(rng.uniform(-0.3, 0.3)),
                                    float(rng.uniform(-0.2, 0.4)), 0.0),
                            radius=0.4)
        eye = (float(rng.uniform(-0.4, 0.4)), -1.6, float(rng.uniform(-0.3, 0.3)))
        pose = look_at(eye, (0.0, 0.0, 0.0))
        depth = render_scene_depth(scene, cam, pose)
        # fill holes with a far plane so edge pixels carry valid depth
        depth = jnp.where(jnp.isnan(depth), 3.0, depth)
        pts = backproject(cam, depth)
        nrm = estimate_normals(pts)
        cfg = FusionConfig(fuse_color=False, distance=distance)
        gd = fuse_frame(empty_grid(params), pose, pts, nrm, None,
                        params=params, cam=cam, cfg=cfg)
        gb, stats = fuse_frame_bricked(
            empty_grid(params), pose, pts, nrm, None,
            params=params, cam=cam, cfg=cfg, bs=bs, cap=512)
        assert int(stats.overflow) == 0, (trial, m, bs, origin)
        np.testing.assert_allclose(
            np.asarray(gb.W), np.asarray(gd.W), atol=1e-5,
            err_msg=f"trial {trial} m={m} bs={bs} origin={origin}")
        np.testing.assert_allclose(
            np.asarray(gb.D), np.asarray(gd.D), atol=1e-5,
            err_msg=f"trial {trial} m={m} bs={bs} origin={origin}")


def test_share_safe_classification(monkeypatch):
    """share_safe_classify (round 4, VERDICT r3 weak #6): with the proof
    bounds widened by the share-group world radius, the FREE/OCCLUDED/OUT
    shortcuts are EXACT under share semantics — the fused grid equals an
    all-FULL oracle that runs the per-voxel share math on EVERY brick
    (no classification shortcut at all), bitwise."""
    import tracking_sdf_tpu.fusion.brickmajor as bm
    from tracking_sdf_tpu.fusion.brick import share_classify_margin
    from tracking_sdf_tpu.fusion.brickmajor import (
        dense_from_brick_grid, empty_brick_grid)

    bs = (8, 8, 16)
    m = PARAMS.m
    NB = (m // 8) * (m // 8) * (m // 16)
    base = FusionConfig(mode="brickmajor", brick_shape=bs, fuse_color=False,
                        pixel_share=4, pixel_share_j=4)
    cfg_safe = base._replace(share_safe_classify=True)
    assert share_classify_margin(PARAMS, cfg_safe) > 0
    # flag explicitly off -> the historical share-1-exact bounds
    assert share_classify_margin(
        PARAMS, base._replace(share_safe_classify=False)) == 0.0
    # point_to_point is exact under share without widening (round 4)
    assert share_classify_margin(
        PARAMS, cfg_safe._replace(distance="point_to_point")) == 0.0
    assert share_classify_margin(
        PARAMS, base._replace(pixel_share=1, pixel_share_j=1,
                              share_safe_classify=True)) == 0.0

    # wall-only scene head-on: free space in front of the wall actually
    # produces FREE bricks even under the widened bounds
    wall_poses = [look_at((0.0, -1.5, 0.0), (0.0, 1.0, 0.0)),
                  look_at((0.05, -1.45, 0.02), (0.0, 1.0, 0.0))]
    frames = []
    for pose in wall_poses:
        depth = render_scene_depth(WALL, CAM, pose)
        pts = backproject(CAM, depth)
        frames.append((pose, pts, estimate_normals(pts)))

    def run(cfg, all_full):
        if all_full:
            def force_full(params, pose, pts, nrm, cam, bs_, dtype, nbi,
                           i_offset, distance, mip=None, share_margin=0.0):
                return jnp.full((nbi, m // bs_[1], m // bs_[2]), 2,
                                jnp.int32)
            monkeypatch.setattr(bm, "classify_bricks", force_full)
        else:
            monkeypatch.undo()
        bg = empty_brick_grid(PARAMS, bs)
        for pose, pts, normals in frames:
            bg, _, stats = bm.fuse_frame_brickmajor(
                bg, pose, pts, normals, None, params=PARAMS, cam=CAM,
                cfg=cfg, bs=bs, cap=NB, cap_free=NB, emit_dm=False)
            assert int(stats.overflow) == 0
        return dense_from_brick_grid(bg, PARAMS, bs), stats

    g_oracle, _ = run(base._replace(brick_cap=NB), all_full=True)
    g_safe, st_safe = run(cfg_safe, all_full=False)
    # the shortcuts actually fired (FREE bricks exist under widened bounds)
    assert int(st_safe.n_free) > 0
    # FREE-merge arithmetic is the same f32 op sequence as the all-FULL
    # path on provably-free bricks -> bitwise equality
    np.testing.assert_array_equal(np.asarray(g_safe.W), np.asarray(g_oracle.W))
    np.testing.assert_array_equal(np.asarray(g_safe.D), np.asarray(g_oracle.D))


def test_free_fold_bitwise_identical():
    """free_fold (round 4): folding the FREE rows into the FULL D/W pass
    must not change a single bit — same per-row arithmetic, disjoint id
    sets, only the scatter batching differs."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        empty_brick_grid, fuse_frame_brickmajor)

    bs = (8, 8, 16)
    # wall-only head-on frames: guarantees FREE bricks at this brick size
    # (see test_free_bricks_classified_and_exact_on_wall_scene)
    wall_poses = [look_at((0.0, -1.5, 0.0), (0.0, 1.0, 0.0)),
                  look_at((0.06, -1.44, 0.03), (0.0, 1.0, 0.0))]
    frames = []
    for pose in wall_poses:
        depth = render_scene_depth(WALL, CAM, pose)
        pts = backproject(CAM, depth)
        rgb = jnp.full(pts.shape, 0.6, jnp.float32)
        frames.append((pose, pts, estimate_normals(pts), rgb))
    for hier in (0, 2):
        cfg = FusionConfig(mode="brickmajor", brick_shape=bs,
                           fuse_color=True, hier_classify=hier,
                           cap_mixed=64)
        out = {}
        for fold in (False, True):
            bg = empty_brick_grid(PARAMS, bs)
            for pose, pts, normals, rgb in frames:
                bg, _, stats = fuse_frame_brickmajor(
                    bg, pose, pts, normals, rgb, params=PARAMS, cam=CAM,
                    cfg=cfg._replace(free_fold=fold), bs=bs, cap=220,
                    cap_free=128, emit_dm=False)
                assert int(stats.overflow) == 0
            assert int(stats.n_free) > 0  # fold actually has FREE rows
            out[fold] = bg
        for name in out[False]._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(out[True], name), np.float32),
                np.asarray(getattr(out[False], name), np.float32),
                err_msg=f"hier={hier} {name}")


def test_brickmajor_bfloat16_weights_close_to_dense():
    """bfloat16 WEIGHT storage (round 4, FusionConfig.weight_dtype) with a
    max_weight clamp: W/Wc carry per-store bf16 rounding (relative 2^-8),
    so multi-frame fusion must stay within a few quanta of the f32 dense
    result with the same clamp. Arithmetic stays f32; the dense export
    surface upcasts. Flagged approximation — no preset adopts it without
    the closed-loop A/B."""
    from tracking_sdf_tpu.fusion.brickmajor import (
        brick_grid_from_dense,
        dense_from_brick_grid,
        fuse_frame_brickmajor,
    )

    cfg = FusionConfig(fuse_color=True, max_weight=128.0)
    gd = empty_grid(PARAMS)
    bg = brick_grid_from_dense(empty_grid(PARAMS), BS,
                               value_dtype=jnp.bfloat16,
                               weight_dtype=jnp.bfloat16)
    assert bg.W.dtype == jnp.bfloat16 and bg.C.dtype == jnp.uint16
    for pose in POSES:
        pts, normals, rgb = _frame(pose)
        gd = fuse_frame(gd, pose, pts, normals, rgb,
                        params=PARAMS, cam=CAM, cfg=cfg)
        bg, _, stats = fuse_frame_brickmajor(
            bg, pose, pts, normals, rgb, params=PARAMS, cam=CAM, cfg=cfg,
            bs=BS, cap=220)
        assert int(stats.overflow) == 0
        assert bg.W.dtype == jnp.bfloat16
    gb = dense_from_brick_grid(bg, PARAMS, BS)
    assert gb.W.dtype == jnp.float32  # export surface upcasts
    # weights: within a few bf16 quanta of the f32 accumulator (W <= 2
    # frames of updates here, so quantum <= 2/256)
    np.testing.assert_allclose(np.asarray(gb.W), np.asarray(gd.W),
                               atol=4 * 2.0 / 256)
    # same observation mask (W > 0 agrees exactly)
    np.testing.assert_array_equal(np.asarray(gb.W) > 0,
                                  np.asarray(gd.W) > 0)
    both = np.asarray(gd.W) > 0
    np.testing.assert_allclose(np.asarray(gb.D)[both],
                               np.asarray(gd.D)[both],
                               atol=6 * PARAMS.delta / 256)
