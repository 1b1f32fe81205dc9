"""TSDF depth + color fusion.

Reimplements SDF::update (reference sdf.cpp:224-315) as a single jit'd
per-voxel GATHER pass: every voxel projects into the image ("visit every
voxel exactly once", paper §IV-B — the opposite of raycasting), fetches its
pixel's observed point/normal/color, and folds them into running weighted
means. Where the C++ used `continue` for its skip rules (behind camera
:247, off image :254, NaN :260, beyond truncation :280-283), this carries
boolean masks — the branch-free equivalent.

Because the update is purely per-voxel (a gather from the small replicated
image, never a scatter), sharding the grid over a device mesh axis makes
fusion embarrassingly parallel with zero cross-device traffic (P2 in
SURVEY.md §2).

Sign convention: the canonical D is positive in free space, the NEGATION of
the reference's stored field (see package docstring). The reference's rules
map exactly:

    reference (d_ref)                          here (d = -d_ref)
    ------------------------------------       ---------------------------
    w = 1                 if d_ref <  eps      w = 1            if d > -eps
    w = exp(-.5(d_ref-eps)^2) eps..delta       exp(-.5(d+eps)^2)  -delta..-eps
    skip voxel            if d_ref >  delta    skip             if d < -delta
    clamp d_ref to -delta if d_ref < -delta    clamp d to +delta if d > delta

Precision: fusion math runs in float32. The running means are numerically
benign (weights are O(frames)); bfloat16 storage is a possible future
optimization for the color channels.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.grid.grid import TSDFGrid, voxel_centers_world


def weighting(name: str, d: jnp.ndarray, eps: float, delta: float) -> jnp.ndarray:
    """Fusion weight as a function of the canonical (+free space) distance d.

    Implements the paper Table II family (reference ships "exponential",
    sdf.cpp:276-279). Returns the weight BEFORE the d < -delta occlusion
    cut, which is a mask, not a weight.
    """
    behind = d <= -eps  # behind the observed surface by more than eps
    if name == "exponential":
        w = jnp.where(behind, jnp.exp(-0.5 * (d + eps) ** 2), 1.0)
    elif name == "linear":
        w = jnp.where(behind, jnp.clip((delta + d) / (delta - eps), 0.0, 1.0), 1.0)
    elif name == "constant":
        w = jnp.ones_like(d)
    elif name.startswith("narrow_"):
        # Narrow-band variants (paper Table II): same shapes, band delta/10.
        return weighting(name[len("narrow_"):], d, eps, delta / 10.0)
    else:
        raise ValueError(f"unknown weighting: {name}")
    return w


def _world_to_camera_components(pose: Pose, x, y, z):
    """Rᵀ (p - t) computed channelwise so broadcast iotas stay unmaterialized."""
    Rt = pose.R.T
    dx, dy, dz = x - pose.t[0], y - pose.t[1], z - pose.t[2]
    px = Rt[0, 0] * dx + Rt[0, 1] * dy + Rt[0, 2] * dz
    py = Rt[1, 0] * dx + Rt[1, 1] * dy + Rt[1, 2] * dz
    pz = Rt[2, 0] * dx + Rt[2, 1] * dy + Rt[2, 2] * dz
    return px, py, pz


def pixel_channels(
    points_cam: jnp.ndarray,
    normals_cam: jnp.ndarray,
    rgb: Optional[jnp.ndarray],
    cfg: FusionConfig,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Per-pixel precomputation (tiny vs the voxel pass): (H*W, C) channels.

    s = y·n per pixel lets the per-voxel plane distance be a single fused
    multiply-add chain: d_ref = s - p·n  (projectivePointToPlaneDistance,
    sdf.h:177-181 evaluated as (y - p)·n).
    """
    h, w_img = points_cam.shape[:2]
    n_img = normals_cam
    y_img = points_cam
    finite = (
        jnp.isfinite(y_img[..., 0])
        & jnp.isfinite(y_img[..., 1])
        & jnp.isfinite(n_img[..., 0])
        & jnp.isfinite(n_img[..., 1])
        & jnp.isfinite(n_img[..., 2])
    )  # the reference checks point.x/.y and the normal, not point.z (:260)
    s_img = jnp.sum(jnp.where(finite[..., None], y_img * n_img, 0.0), axis=-1)
    norm_n = jnp.sqrt(jnp.sum(jnp.where(finite[..., None], n_img * n_img, 0.0), -1))
    # color weight cosine = |z·n| / ||n||  (sdf.cpp:294)
    cos_img = jnp.where(
        norm_n > 0, jnp.abs(jnp.where(finite, n_img[..., 2], 0.0)) / jnp.where(norm_n > 0, norm_n, 1.0), 0.0
    )
    yz_img = jnp.where(finite, y_img[..., 2], 0.0)

    channels = [
        jnp.where(finite, n_img[..., 0], 0.0),
        jnp.where(finite, n_img[..., 1], 0.0),
        jnp.where(finite, n_img[..., 2], 0.0),
        s_img,
        cos_img,
        yz_img,
        finite.astype(dtype),
    ]
    if cfg.fuse_color and rgb is not None:
        channels += [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
    return jnp.stack(channels, axis=-1).reshape(h * w_img, -1).astype(dtype)


def fuse_voxels(
    grid: TSDFGrid,
    pose: Pose,
    pix: jnp.ndarray,  # (H*W, C) from pixel_channels
    image_hw: tuple,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig,
    i_offset=0,
) -> TSDFGrid:
    """The per-voxel fusion pass over a (mi, m, m) grid SLAB.

    ``i_offset`` (may be traced, e.g. ``axis_index * slab``) is the global
    voxel-i of the slab's first plane — the hook that makes this the shared
    core of both the dense single-chip path and the slab-sharded SPMD path
    (tracking_sdf_tpu.parallel.sharded): fusion is purely per-voxel, so a
    slab fuses independently with zero cross-device traffic (SURVEY.md P2).
    """
    dtype = grid.D.dtype
    h, w_img = image_hw
    mi = grid.D.shape[0]

    # local voxel-center iotas, shifted into global world coordinates
    # (shared transform: grid.voxel_centers_world, the sdf.h:153-157 map)
    x, y, z = voxel_centers_world(params, dtype, i_offset=i_offset, mi=mi)
    px, py, pz = _world_to_camera_components(pose, x, y, z)

    in_front = pz > 0  # reference: skip z < 0 (:247); >0 also guards the division
    safe_z = jnp.where(in_front, pz, 1.0)
    u = (cam.fx * px + cam.cx * pz) / safe_z
    v = (cam.fy * py + cam.cy * pz) / safe_z
    iu = jnp.trunc(u).astype(jnp.int32)  # C-style (int) casts (:251-252)
    iv = jnp.trunc(v).astype(jnp.int32)
    inside = (iu >= 0) & (iu < w_img) & (iv >= 0) & (iv < h)

    flat = jnp.clip(iv, 0, h - 1) * w_img + jnp.clip(iu, 0, w_img - 1)
    g = pix[flat]  # ONE gather: (m, m, m, C)
    nx, ny, nz, s, cosv, yz, fin = (
        g[..., 0], g[..., 1], g[..., 2], g[..., 3], g[..., 4], g[..., 5], g[..., 6],
    )

    if cfg.distance == "point_to_plane":
        d_ref = s - (px * nx + py * ny + pz * nz)  # (y - p)·n  (sdf.cpp:272)
    elif cfg.distance == "point_to_point":
        d_ref = yz - pz  # observed - voxel z... reference sign: voxel - observed
        d_ref = -d_ref  # projectivePointToPointDistance = p_z - y_z (sdf.h:169-172)
    else:
        raise ValueError(f"unknown distance: {cfg.distance}")
    d = -d_ref  # canonical: positive free space

    observe = in_front & inside & (fin > 0)
    fuse_mask = observe & (d >= -params.delta)  # occlusion cut (skip d_ref > delta)
    d = jnp.minimum(d, params.delta)  # far-free-space truncation (Eq. 28)

    w_new = jnp.where(fuse_mask, weighting(cfg.weighting, d, params.epsilon, params.delta), 0.0)

    # running mean divides by the UNCAPPED sum; only the STORED weight is
    # clamped. Dividing by the clamped weight makes saturated voxels
    # diverge (D + (w/Wmax)*d per frame — coefficients sum to > 1); the
    # correct clamped update is the exponential moving average
    # (Wmax*D + w*d) / (Wmax + w).
    W_sum = grid.W + w_new
    W_new = (W_sum if cfg.max_weight is None
             else jnp.minimum(W_sum, cfg.max_weight))
    has = w_new > 0
    D_new = jnp.where(has, (grid.W * grid.D + w_new * d) / jnp.where(has, W_sum, 1.0), grid.D)

    if cfg.fuse_color and pix.shape[-1] >= 10:
        cr, cg, cb = g[..., 7], g[..., 8], g[..., 9]
        wc_new = w_new * cosv
        Wc_sum = grid.Wc + wc_new
        Wc_new = (Wc_sum if cfg.max_weight is None
                  else jnp.minimum(Wc_sum, cfg.max_weight))
        has_c = wc_new > 0
        safe_wc = jnp.where(has_c, Wc_sum, 1.0)
        R_new = jnp.where(has_c, (grid.Wc * grid.R + wc_new * cr) / safe_wc, grid.R)
        G_new = jnp.where(has_c, (grid.Wc * grid.G + wc_new * cg) / safe_wc, grid.G)
        B_new = jnp.where(has_c, (grid.Wc * grid.B + wc_new * cb) / safe_wc, grid.B)
    else:
        Wc_new, R_new, G_new, B_new = grid.Wc, grid.R, grid.G, grid.B

    return TSDFGrid(D=D_new, W=W_new, R=R_new, G=G_new, B=B_new, Wc=Wc_new)


@partial(jax.jit, static_argnames=("params", "cam", "cfg"), donate_argnames=("grid",))
def fuse_frame(
    grid: TSDFGrid,
    pose: Pose,
    points_cam: jnp.ndarray,  # (H, W, 3) organized camera-frame points (NaN holes)
    normals_cam: jnp.ndarray,  # (H, W, 3) camera-frame normals, oriented toward camera
    rgb: Optional[jnp.ndarray],  # (H, W, 3) colors in [0, 1], or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
) -> TSDFGrid:
    """Fuse one observed frame into the grid. Donates `grid` (updated in place)."""
    pix = pixel_channels(points_cam, normals_cam, rgb, cfg, dtype=grid.D.dtype)
    return fuse_voxels(
        grid, pose, pix, points_cam.shape[:2], params=params, cam=cam, cfg=cfg
    )


def make_fuse_fn(params: GridParams, cam: PinholeCamera, cfg: FusionConfig):
    """Partially-applied fuse_frame with statics bound (handy for scan/loops)."""
    def fn(grid, pose, points_cam, normals_cam, rgb=None):
        return fuse_frame(
            grid, pose, points_cam, normals_cam, rgb, params=params, cam=cam, cfg=cfg
        )
    return fn
