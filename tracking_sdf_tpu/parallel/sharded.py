"""Sharded (SPMD) tracking and fusion over a 1-D device mesh.

Replaces the reference's OpenMP parallel structures (SURVEY.md P1-P5) with
`jax.shard_map` over a mesh axis ``'d'``:

* **Fusion** (`sharded_fuse_frame`): grid slabs are local, the (small) image
  is replicated — each device runs the identical per-voxel gather+update on
  its slab with a shifted i-iota. ZERO cross-device traffic, the exact SPMD
  analogue of the reference's `#pragma omp parallel for` over voxels
  (sdf.cpp:232-233).

* **Tracking** (`sharded_track_frame`): pixels are replicated but each query
  is ANSWERED ONLY by the slab that owns its base voxel (floor of the
  continuous i coordinate). A one-plane halo fetched once per frame via
  `lax.ppermute` makes boundary-straddling trilinear stencils local, so the
  full grid is never gathered. Each device folds its owned pixels into
  partial normal equations (JᵀJ ∈ 6x6, Jᵀr ∈ 6) with one contraction and
  a `psum` merges them (up to float32 summation order) — the mesh version of the
  per-thread A_array/B_array + serial reduce (camera_tracking.cpp:148-189).
  The 6x6 solve and pose update then run replicated on every device, keeping
  the Gauss-Newton `lax.while_loop` control flow identical across shards.

Requires `params.m % mesh_size == 0` (slab sharding of the i axis).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tracking_sdf_tpu.config import FusionConfig, GridParams, TrackingConfig
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.fusion.fuse import fuse_voxels, pixel_channels
from tracking_sdf_tpu.grid.grid import TSDFGrid, world_to_voxel
from tracking_sdf_tpu.grid.interp import masked_view, trilinear_with_grad_nan
from tracking_sdf_tpu.tracking.gauss_newton import (
    TrackResult,
    _apply_update,
    _sanitize,
    normal_equations,
)

_HI = jax.lax.Precision.HIGHEST


def _grid_specs():
    return TSDFGrid(
        D=P("d", None, None), W=P("d", None, None), R=P("d", None, None),
        G=P("d", None, None), B=P("d", None, None), Wc=P("d", None, None),
    )


def _halo_plane(slab: jnp.ndarray, axis_name: str, zero_last: bool,
                fill_last: float = 0.0):
    """Fetch the NEXT slab's first i-plane (cyclic); optionally overwrite it
    on the last shard with ``fill_last`` (the global corner i == m is out of
    bounds — 0 for weight planes, NaN for masked-view planes)."""
    n = lax.axis_size(axis_name)
    perm = [((p + 1) % n, p) for p in range(n)]
    halo = lax.ppermute(slab[0:1], axis_name, perm)
    if zero_last:
        is_last = lax.axis_index(axis_name) == n - 1
        halo = jnp.where(is_last, jnp.full_like(halo, fill_last), halo)
    return halo


def _owned_residuals(
    Dm_ext: jnp.ndarray,  # masked_view of the (slab+1, m, m) haloed slab
    pose: Pose,
    points_cam: jnp.ndarray,  # (N, 3) replicated
    i0: jnp.ndarray,  # () global i of this slab's first plane
    slab: int,
    params: GridParams,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-pixel (phi, J, mask) where mask additionally requires that THIS
    shard owns the query's base voxel. Identical math to
    tracking.gauss_newton.pixel_residuals_analytic on owned pixels."""
    p, valid_in = _sanitize(points_cam)
    x = jnp.einsum("ij,nj->ni", pose.R, p, precision=_HI) + pose.t
    uvw = world_to_voxel(params, x)
    in_bounds = jnp.all((uvw >= 0) & (uvw < params.m), axis=-1)

    base_i = jnp.floor(uvw[..., 0])
    owned = (base_i >= i0) & (base_i < i0 + slab)

    uvw_local = uvw - jnp.stack(
        [i0.astype(uvw.dtype), jnp.zeros_like(i0, uvw.dtype), jnp.zeros_like(i0, uvw.dtype)]
    )
    phi, g_uvw, ok = trilinear_with_grad_nan(Dm_ext, uvw_local)
    scale = jnp.asarray(
        [params.m / params.width, params.m / params.height, params.m / params.depth],
        dtype=g_uvw.dtype,
    )
    g_world = g_uvw * scale
    a = x - pose.t
    J = jnp.concatenate([g_world, jnp.cross(a, g_world)], axis=-1)
    mask = valid_in & in_bounds & ok & owned
    return phi, J, mask


def sharded_track_frame(
    mesh: Mesh,
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
):
    """Build the jitted SPMD tracking step for `mesh`.

    Returns fn(grid_sharded, pose, points_cam (N, 3) replicated) ->
    TrackResult (replicated). Only the 'analytic' Jacobian mode is supported
    sharded (the central-difference parity mode stays single-device)."""
    if cfg.jacobian != "analytic":
        raise ValueError("sharded tracking supports jacobian='analytic' only")
    n_dev = mesh.devices.size
    if params.m % n_dev != 0:
        raise ValueError(f"grid m={params.m} not divisible by mesh size {n_dev}")
    slab = params.m // n_dev

    def local_step(D_slab, W_slab, pose, points_cam):
        D_ext = jnp.concatenate([D_slab, _halo_plane(D_slab, "d", False)], axis=0)
        W_ext = jnp.concatenate([W_slab, _halo_plane(W_slab, "d", True)], axis=0)
        Dm_ext = masked_view(D_ext, W_ext)  # one gather per query in the loop
        return _local_gn(Dm_ext, pose, points_cam, slab, params, cfg)

    shmapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("d", None, None), P("d", None, None), Pose(P(), P()), P()),
        out_specs=TrackResult(Pose(P(), P()), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def fn(grid: TSDFGrid, pose: Pose, points_cam: jnp.ndarray) -> TrackResult:
        return shmapped(grid.D, grid.W, pose, points_cam)

    return fn


def _local_gn(Dm_ext, pose, points_cam, slab: int, params: GridParams,
              cfg: TrackingConfig) -> TrackResult:
    """Per-shard GN while_loop over an already-haloed masked slab.

    Dm_ext: (slab+1, m, m) NaN-masked SDF (local slab + next-slab halo
    plane). The psum inside the body keeps pose/convergence replicated."""
    i0 = lax.axis_index("d") * slab
    dtype = jnp.promote_types(Dm_ext.dtype, jnp.float32)

    def converged(twist):
        if cfg.convergence == "norm":
            return jnp.max(jnp.abs(twist)) < cfg.max_twist_diff
        return jnp.all(twist < cfg.max_twist_diff)  # reference quirk

    def cond(state):
        i, _, done, *_ = state
        return (i < cfg.max_iterations) & jnp.logical_not(done)

    def body(state):
        i, pose_c, _, _, _, _, lam = state
        phi, J, mask = _owned_residuals(
            Dm_ext, pose_c, points_cam, i0, slab, params
        )
        A, b = normal_equations(phi, J, mask)
        nvalid = jnp.sum(mask.astype(jnp.int32))
        sum_res = jnp.sum(jnp.where(mask, jnp.abs(phi), 0.0))
        A, b, nvalid, sum_res = lax.psum((A, b, nvalid, sum_res), "d")
        A = A + lam * jnp.diag(jnp.diag(A)) + 1e-12 * jnp.eye(6, dtype=A.dtype)
        twist = jnp.linalg.solve(A, b)
        twist = jnp.where(jnp.all(jnp.isfinite(twist)), twist, jnp.zeros_like(twist))
        done = converged(twist) & (i + 1 >= cfg.min_iterations)
        pose_new = _apply_update(pose_c, twist, cfg.pose_update)
        mean_res = sum_res / jnp.maximum(nvalid, 1)
        return (i + 1, pose_new, done, twist, nvalid, mean_res,
                lam * cfg.damping_decay)

    state0 = (
        jnp.int32(0), pose, jnp.bool_(False),
        jnp.zeros((6,), dtype=dtype), jnp.int32(0),
        jnp.zeros((), dtype=dtype),
        jnp.asarray(cfg.damping, dtype=dtype),
    )
    i, pose_f, _, twist, nvalid, mean_res, _ = lax.while_loop(cond, body, state0)
    return TrackResult(pose=pose_f, iterations=i, final_twist=twist,
                       num_valid=nvalid, mean_abs_residual=mean_res)


def sharded_track_frame_masked(
    mesh: Mesh,
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
):
    """SPMD tracking over PRE-MASKED dense slabs (NaN where unobserved) —
    the Dm slabs that sharded brickmajor fusion emits. Same ownership
    partition + one-plane halo + psum'd normal equations as
    sharded_track_frame; the halo fill for the last shard is NaN (masked
    convention) instead of a zero weight plane."""
    if cfg.jacobian != "analytic":
        raise ValueError("sharded tracking supports jacobian='analytic' only")
    n_dev = mesh.devices.size
    if params.m % n_dev != 0:
        raise ValueError(f"grid m={params.m} not divisible by mesh size {n_dev}")
    slab = params.m // n_dev

    def local_step(Dm_slab, pose, points_cam):
        halo = _halo_plane(Dm_slab, "d", True, fill_last=float("nan"))
        Dm_ext = jnp.concatenate([Dm_slab, halo], axis=0)
        return _local_gn(Dm_ext, pose, points_cam, slab, params, cfg)

    shmapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("d", None, None), Pose(P(), P()), P()),
        out_specs=TrackResult(Pose(P(), P()), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def fn(Dm: jnp.ndarray, pose: Pose, points_cam: jnp.ndarray) -> TrackResult:
        return shmapped(Dm, pose, points_cam)

    return fn


def sharded_track_frame_brickmajor(
    mesh: Mesh,
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
    bs: Tuple[int, int, int] = (8, 8, 8),
    jit: bool = True,
):
    """SPMD tracking STRAIGHT off the sharded brick-major D rows — the
    zero-relayout distributed analogue of the single-device emit_dm="view"
    path. ``jit=False`` returns the untraced callable for composition into
    a larger program (the sharded chunk loop).

    Each device owns a contiguous slab of brick rows (P('d', None) on every
    BrickGrid leaf). Tracking needs corners at base_i and base_i+1, so one
    `lax.ppermute` ships the NEXT shard's first brick LAYER of D rows
    (nbj*nbk rows = bi extra voxel planes; only the first plane is ever
    addressed — ownership restricts base_i < i0+slab) and the local
    (nbi_local+1)-layer extent becomes a slab-local BrickMaskedView
    (grid/interp.py `mi`). Corner gathers, ownership partition, psum'd
    normal equations: identical to sharded_track_frame_masked — minus the
    per-frame slab-dense Dm relayout that path's input costs.

    Returns fn(D_rows (NB, BV) sharded P('d', None), pose, points_cam
    (N, 3) replicated) -> TrackResult (replicated). The D leaf already
    holds the NaN masked-view encoding (BrickGrid storage invariant)."""
    if cfg.jacobian != "analytic":
        raise ValueError("sharded tracking supports jacobian='analytic' only")
    n_dev = mesh.devices.size
    if params.m % n_dev != 0:
        raise ValueError(f"grid m={params.m} not divisible by mesh size {n_dev}")
    slab = params.m // n_dev
    bi, bj, bk = bs
    if slab % bi:
        raise ValueError(f"slab {slab} not divisible by brick i-extent {bi}")
    m = params.m
    nbj, nbk = m // bj, m // bk
    layer = nbj * nbk  # brick rows per i-layer of bricks
    from tracking_sdf_tpu.grid.interp import _ROW_W, BrickMaskedView

    def local_step(D_rows, pose, points_cam):
        n = lax.axis_size("d")
        perm = [((p + 1) % n, p) for p in range(n)]
        halo = lax.ppermute(D_rows[:layer], "d", perm)
        is_last = lax.axis_index("d") == n - 1
        halo = jnp.where(is_last, jnp.full_like(halo, jnp.nan), halo)
        ext = jnp.concatenate([D_rows, halo], axis=0)
        view = BrickMaskedView(ext.reshape(-1, _ROW_W), m, bs, mi=slab + bi)
        return _local_gn(view, pose, points_cam, slab, params, cfg)

    shmapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("d", None), Pose(P(), P()), P()),
        out_specs=TrackResult(Pose(P(), P()), P(), P(), P(), P()),
        check_vma=False,
    )

    def fn(D_rows: jnp.ndarray, pose: Pose, points_cam: jnp.ndarray) -> TrackResult:
        return shmapped(D_rows, pose, points_cam)

    return jax.jit(fn) if jit else fn


def sharded_fuse_frame(
    mesh: Mesh,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
):
    """Build the jitted SPMD fusion step: grid slabs local, image replicated,
    zero collectives (SURVEY.md P2). Returns fn(grid, pose, points, normals,
    rgb) -> grid, donating the grid (updated in place)."""
    n_dev = mesh.devices.size
    if params.m % n_dev != 0:
        raise ValueError(f"grid m={params.m} not divisible by mesh size {n_dev}")
    slab = params.m // n_dev

    def local_fuse(grid_slab: TSDFGrid, pose, pix, hw01):
        i0 = lax.axis_index("d") * slab
        return fuse_voxels(
            grid_slab, pose, pix, (int(hw01.shape[0]), int(hw01.shape[1])),
            params=params, cam=cam, cfg=cfg, i_offset=i0,
        )

    gspec = _grid_specs()
    shmapped = jax.shard_map(
        local_fuse,
        mesh=mesh,
        in_specs=(gspec, Pose(P(), P()), P(), P()),
        out_specs=gspec,
        check_vma=False,
    )

    @partial(jax.jit, donate_argnums=(0,))
    def fn(grid, pose, points_cam, normals_cam, rgb=None):
        pix = pixel_channels(points_cam, normals_cam, rgb, cfg, dtype=grid.D.dtype)
        # hw01: zero-size carrier of the static image shape into shard_map
        hw01 = jnp.zeros(points_cam.shape[:2] + (0,), dtype=grid.D.dtype)
        return shmapped(grid, pose, pix, hw01)

    return fn


def sharded_fuse_frame_bricked(
    mesh: Mesh,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs=None,
    cap: Optional[int] = None,
):
    """SPMD brick-compacted fusion: each slab classifies and compacts ITS
    OWN bricks (fuse_frame_bricked with a per-shard i_offset) — the
    brick-sharded fusion of the BASELINE north star ("fusion
    scatter-updates are resolved per-shard"), still with zero collectives.

    `cap` is PER SHARD (default: brick_cap / n_devices, min 256). Returns
    fn(grid, pose, points, normals, rgb) -> (grid, FuseStats summed over
    shards)."""
    from tracking_sdf_tpu.fusion.brick import FuseStats, fuse_frame_bricked

    n_dev, slab, bs, cap = _slab_bricks(mesh, params, cfg, bs, cap)
    use_color = cfg.fuse_color

    def local_fuse(grid_slab: TSDFGrid, pose, points, normals, rgb):
        i0 = lax.axis_index("d") * slab
        grid_new, stats = fuse_frame_bricked(
            grid_slab, pose, points, normals, rgb if use_color else None,
            params=params, cam=cam, cfg=cfg, bs=bs, cap=cap,
            merge="xla", i_offset=i0,
        )
        stats = FuseStats(*(lax.psum(s, "d") for s in stats))
        return grid_new, stats

    gspec = _grid_specs()
    sspec = FuseStats(*([P()] * len(FuseStats._fields)))
    shmapped = jax.shard_map(
        local_fuse,
        mesh=mesh,
        in_specs=(gspec, Pose(P(), P()), P(), P(), P()),
        out_specs=(gspec, sspec),
        check_vma=False,
    )

    @partial(jax.jit, donate_argnums=(0,))
    def fn(grid, pose, points_cam, normals_cam, rgb=None):
        if use_color and rgb is None:
            raise ValueError("cfg.fuse_color=True but rgb is None")
        if rgb is None:  # unused placeholder (specs are positional arrays)
            rgb = jnp.zeros(points_cam.shape[:2] + (3,), grid.D.dtype)
        return shmapped(grid, pose, points_cam, normals_cam, rgb)

    return fn


def _slab_bricks(mesh: Mesh, params: GridParams, cfg: FusionConfig, bs, cap):
    """Shared slab/brick validation for the brick-sharded fusion builders.

    Returns (n_dev, slab, bs, cap) with ``cap`` scaled PER SHARD (default:
    cfg.brick_cap / n_devices, min 256)."""
    n_dev = mesh.devices.size
    if params.m % n_dev != 0:
        raise ValueError(f"grid m={params.m} not divisible by mesh size {n_dev}")
    slab = params.m // n_dev
    bs = bs if bs is not None else cfg.brick_shape
    if slab % bs[0]:
        raise ValueError(f"slab {slab} not divisible by brick i-extent {bs[0]}")
    cap = cap if cap is not None else max(256, cfg.brick_cap // n_dev)
    return n_dev, slab, bs, cap


def shard_brick_grid(bgrid, mesh: Mesh, axis_name: str = "d"):
    """Slab-shard every BrickGrid leaf's rows over the mesh.

    Brick ids are row-major over (nbi, nbj, nbk), so an equal split of rows
    across n devices is exactly an i-slab of bricks per device (requires
    nbi %% n == 0 — checked by sharded_fuse_frame_brickmajor)."""
    from jax.sharding import NamedSharding

    from tracking_sdf_tpu.parallel.mesh import put_sharded
    s = NamedSharding(mesh, P(axis_name, None))
    return jax.tree.map(lambda x: put_sharded(x, s), bgrid)


def sharded_fuse_frame_brickmajor(
    mesh: Mesh,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs=None,
    cap: Optional[int] = None,
    cap_free: Optional[int] = None,
    emit_dm: bool = True,
    jit: bool = True,
):
    """SPMD fusion over BRICK-MAJOR storage — the fastest single-device
    layout, sharded: each device owns a contiguous slab of brick rows
    (brick ids are row-major over (nbi, nbj, nbk), so an i-slab of bricks
    IS a contiguous row range of every leaf), classifies and merges only
    its own bricks (fuse_frame_brickmajor with nbi_local + i_offset), with
    zero collectives except the stats psum.

    Returns fn(bgrid, pose, points, normals, rgb) ->
    (bgrid, Dm_slabbed, stats): Dm_slabbed is the (m, m, m) NaN-masked SDF
    sharded P('d', None, None) — each device relayouts only its slab —
    ready for sharded_track_frame_masked. With ``emit_dm=False`` the
    relayout is skipped entirely (Dm_slabbed is None): pair with
    sharded_track_frame_brickmajor, which gathers corners straight from
    the sharded bgrid.D rows. ``cap``/``cap_free`` are PER SHARD
    (default: brick_cap / n_devices, min 256)."""
    from tracking_sdf_tpu.fusion.brick import FuseStats
    from tracking_sdf_tpu.fusion.brickmajor import BrickGrid, fuse_frame_brickmajor

    n_dev, slab, bs, cap = _slab_bricks(mesh, params, cfg, bs, cap)
    nbi_l = slab // bs[0]
    cap_free = cap_free if cap_free is not None else cap
    use_color = cfg.fuse_color

    def local_fuse(bgrid_slab: BrickGrid, pose, points, normals, rgb):
        i0 = lax.axis_index("d") * slab
        bg, Dm_slab, stats = fuse_frame_brickmajor(
            bgrid_slab, pose, points, normals, rgb if use_color else None,
            params=params, cam=cam, cfg=cfg, bs=bs, cap=cap,
            cap_free=cap_free, emit_dm=emit_dm, i_offset=i0, nbi_local=nbi_l,
        )
        stats = FuseStats(*(lax.psum(s, "d") for s in stats))
        if emit_dm:
            return bg, Dm_slab, stats
        return bg, stats

    bspec = BrickGrid(*([P("d", None)] * len(BrickGrid._fields)))
    sspec = FuseStats(*([P()] * len(FuseStats._fields)))
    out_specs = ((bspec, P("d", None, None), sspec) if emit_dm
                 else (bspec, sspec))
    shmapped = jax.shard_map(
        local_fuse,
        mesh=mesh,
        in_specs=(bspec, Pose(P(), P()), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )

    def fn(bgrid: BrickGrid, pose, points_cam, normals_cam, rgb=None):
        if use_color and rgb is None:
            raise ValueError("cfg.fuse_color=True but rgb is None")
        if rgb is None:  # unused placeholder (specs are positional arrays)
            rgb = jnp.zeros(points_cam.shape[:2] + (3,), jnp.float32)
        out = shmapped(bgrid, pose, points_cam, normals_cam, rgb)
        return out if emit_dm else (out[0], None, out[1])

    return partial(jax.jit, donate_argnums=(0,))(fn) if jit else fn


def make_sharded_step(
    mesh: Mesh,
    *,
    params: GridParams,
    cam: PinholeCamera,
    tracking: TrackingConfig = TrackingConfig(),
    fusion: FusionConfig = FusionConfig(),
):
    """The full per-frame SPMD step: track (psum'd normal equations) then fuse
    (slab-local). This is the distributed analogue of the reference's
    kinect_callback body (sdf_reconstruction.cpp:21-80)."""
    track = sharded_track_frame(mesh, params=params, cfg=tracking)
    fuse = sharded_fuse_frame(mesh, params=params, cam=cam, cfg=fusion)

    def step(grid: TSDFGrid, pose: Pose, points_img, normals_img, rgb=None,
             track_pose: bool = True):
        if track_pose:
            pts = points_img[::tracking.pixel_stride, ::tracking.pixel_stride]
            result = track(grid, pose, pts.reshape(-1, 3))
            pose = result.pose
        else:
            result = None
        grid = fuse(grid, pose, points_img, normals_img, rgb)
        return grid, pose, result

    return step
