"""Depth-image preprocessing: bilateral smoothing + organized normal estimation.

The reference runs PCL's FastBilateralFilter (default params) and
IntegralImageNormalEstimation with AVERAGE_3D_GRADIENT, MaxDepthChangeFactor
0.02, NormalSmoothingSize 10 (sdf_reconstruction.cpp:36-49). Here both are
expressed as fused elementwise image stencils — static Python loops over a
fixed window unroll into one XLA fusion, the accelerator replacement for
PCL's integral-image trick (no data-dependent branching; invalidity is NaN).

Exact numeric parity with PCL is NOT a goal (PCL's fast bilateral is a
downsampled signal-processing approximation); the integration metric is
trajectory ATE. Synthetic-scene tests use analytic normals instead.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from tracking_sdf_tpu.core.camera import PinholeCamera, backproject


def _shifted(img: jnp.ndarray, dy: int, dx: int, fill: float) -> jnp.ndarray:
    """out[y, x] = img[y + dy, x + dx], `fill` outside. Static dy/dx."""
    h, w = img.shape[:2]
    pad = [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    pad += [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad, constant_values=fill)
    y0 = max(-dy, 0) + dy
    x0 = max(-dx, 0) + dx
    return padded[y0:y0 + h, x0:x0 + w, ...]


@partial(jax.jit, static_argnames=("radius", "sigma_spatial", "sigma_range"))
def bilateral_filter(
    depth: jnp.ndarray,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> jnp.ndarray:
    """Edge-preserving depth smoothing; NaN holes stay NaN.

    Plays the role of PCL FastBilateralFilter (sdf_reconstruction.cpp:37-41).
    """
    center_valid = jnp.isfinite(depth)
    d0 = jnp.where(center_valid, depth, 0.0)
    num = jnp.zeros_like(d0)
    den = jnp.zeros_like(d0)
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    inv2sr = 1.0 / (2.0 * sigma_range ** 2)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sw = math.exp(-(dy * dy + dx * dx) * inv2ss)
            dn = _shifted(depth, dy, dx, jnp.nan)
            ok = jnp.isfinite(dn)
            dn0 = jnp.where(ok, dn, 0.0)
            w = jnp.where(ok, sw * jnp.exp(-((dn0 - d0) ** 2) * inv2sr), 0.0)
            num = num + w * dn0
            den = den + w
    out = num / jnp.maximum(den, 1e-12)
    return jnp.where(center_valid & (den > 0), out, jnp.nan)


def _masked_box(img: jnp.ndarray, valid: jnp.ndarray, radius: int):
    """Separable masked box average; returns (mean, count>0). img (H, W, C)."""
    x = jnp.where(valid, img, 0.0)
    v = valid.astype(img.dtype)
    for axis in (0, 1):
        xs = jnp.zeros_like(x)
        vs = jnp.zeros_like(v)
        for d in range(-radius, radius + 1):
            dy, dx = (d, 0) if axis == 0 else (0, d)
            xs = xs + _shifted(x, dy, dx, 0.0)
            vs = vs + _shifted(v, dy, dx, 0.0)
        x, v = xs, vs
    return x / jnp.maximum(v, 1e-12), v > 0


@partial(jax.jit, static_argnames=("radius", "sigma_spatial", "sigma_range"))
def bilateral_filter_separable(
    depth: jnp.ndarray,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> jnp.ndarray:
    """Separable (vertical-then-horizontal) bilateral approximation.

    2*(2r+1) taps instead of (2r+1)^2 — 22 vs 121 at r=5 —
    with the standard caveat that the two 1-D passes are not exactly the
    2-D kernel near diagonal edges. For DEPTH smoothing ahead of normal
    estimation this is well inside the module's stated contract (PCL's
    FastBilateralFilter is itself a far coarser downsampled approximation;
    the integration metric is trajectory ATE — A/B'd on the 120-frame
    dataset oracle before the presets switched). The range weight in pass
    2 compares against the PASS-1 OUTPUT (the usual separable form).
    NaN holes stay NaN; NaN neighbors are excluded per-pass."""
    center_valid = jnp.isfinite(depth)
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    inv2sr = 1.0 / (2.0 * sigma_range ** 2)

    def pass1d(img, axis):
        d0 = jnp.where(jnp.isfinite(img), img, 0.0)
        num = jnp.zeros_like(d0)
        den = jnp.zeros_like(d0)
        for d in range(-radius, radius + 1):
            sw = math.exp(-(d * d) * inv2ss)
            dy, dx = (d, 0) if axis == 0 else (0, d)
            dn = _shifted(img, dy, dx, jnp.nan)
            ok = jnp.isfinite(dn)
            dn0 = jnp.where(ok, dn, 0.0)
            w = jnp.where(ok, sw * jnp.exp(-((dn0 - d0) ** 2) * inv2sr), 0.0)
            num = num + w * dn0
            den = den + w
        out = num / jnp.maximum(den, 1e-12)
        return jnp.where(jnp.isfinite(img) & (den > 0), out, jnp.nan)

    out = pass1d(pass1d(depth, 0), 1)
    return jnp.where(center_valid, out, jnp.nan)


@partial(jax.jit, static_argnames=("smoothing_radius", "max_depth_change_factor"))
def estimate_normals(
    points_cam: jnp.ndarray,  # (H, W, 3) organized camera-frame points
    max_depth_change_factor: float = 0.02,
    smoothing_radius: int = 4,
) -> jnp.ndarray:
    """Organized normal estimation, AVERAGE_3D_GRADIENT style
    (sdf_reconstruction.cpp:43-49): masked-box-smoothed tangent images along
    u and v, normal = normalize(cross(t_u, t_v)), oriented TOWARD the camera
    (n . p < 0, the PCL viewpoint convention), NaN where invalid."""
    z = points_cam[..., 2]
    z_ok = jnp.isfinite(z)

    def tangent(axis):
        dy, dx = (1, 0) if axis == 0 else (0, 1)
        p_p = _shifted(points_cam, dy, dx, jnp.nan)
        p_m = _shifted(points_cam, -dy, -dx, jnp.nan)
        t = 0.5 * (p_p - p_m)
        dz = jnp.abs(p_p[..., 2] - p_m[..., 2])
        ok = (
            jnp.all(jnp.isfinite(p_p), -1)
            & jnp.all(jnp.isfinite(p_m), -1)
            # depth-discontinuity rejection, scaled by depth like PCL's
            # MaxDepthChangeFactor (factor * depth)
            & (dz < max_depth_change_factor * jnp.maximum(jnp.abs(z), 1.0) * 2.0)
        )
        return t, ok

    t_v, ok_v = tangent(0)  # along rows (v direction)
    t_u, ok_u = tangent(1)  # along cols (u direction)

    tu_s, any_u = _masked_box(t_u, ok_u[..., None], smoothing_radius)
    tv_s, any_v = _masked_box(t_v, ok_v[..., None], smoothing_radius)

    n = jnp.cross(tu_s, tv_s)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = (
        z_ok
        & any_u[..., 0]
        & any_v[..., 0]
        & (norm[..., 0] > 1e-12)
        & jnp.all(jnp.isfinite(n), -1)
    )
    n = n / jnp.maximum(norm, 1e-12)
    # orient toward the viewpoint (origin): n . p < 0, PCL convention
    flip = jnp.sum(jnp.where(ok[..., None], n * points_cam, 0.0), axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    return jnp.where(ok[..., None], n, jnp.nan)


def preprocess_frame(
    depth: jnp.ndarray,
    *,
    cam: PinholeCamera,
    bilateral: bool = True,
    bilateral_mode: str = "full",  # "full" (2-D kernel) | "separable"
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """depth (H, W) -> (points_cam, normals_cam), both (H, W, 3).

    The per-frame preprocessing of kinect_callback (sdf_reconstruction.cpp:29-49).
    """
    if bilateral:
        fn = (bilateral_filter_separable if bilateral_mode == "separable"
              else bilateral_filter)
        depth = fn(depth)
    points = backproject(cam, depth)
    normals = estimate_normals(points)
    return points, normals
