"""Analytic synthetic scenes: SDF oracles, exact depth renderers, trajectories.

The reference ships two analytic SDF generators as debug fixtures —
SDF::create_circle (sphere, sdf.cpp:99-126) and SDF::create_cuboid
(sdf.cpp:62-98), both "helper function[s] for testing issues" (sdf.h:93-102).
Here they are first-class: each scene provides an exact signed distance
(positive OUTSIDE, the same convention as the reference fixtures and this
framework's canonical one), an exact ray intersection for rendering golden
depth images without any dataset (BASELINE config #1), and a color field.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tracking_sdf_tpu.config import GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, pixel_rays
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.grid.grid import TSDFGrid, voxel_centers_world


class SphereScene(NamedTuple):
    """Sphere of `radius` at `center`; color = blue gradient along x like
    create_circle (sdf.cpp:117-124)."""

    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 0.5

    def sdf(self, x: jnp.ndarray) -> jnp.ndarray:
        c = jnp.asarray(self.center, dtype=x.dtype)
        return jnp.linalg.norm(x - c, axis=-1) - self.radius

    def color(self, x: jnp.ndarray) -> jnp.ndarray:
        b = jnp.clip(x[..., 0] - self.center[0] + 0.5, 0.0, 1.0)
        return jnp.stack([0.2 * jnp.ones_like(b), 0.3 * jnp.ones_like(b), b], axis=-1)

    def intersect(self, origins: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
        """Exact ray-sphere intersection. dirs need not be unit; the returned
        t satisfies hit = origins + t * dirs (NaN on miss or behind-origin)."""
        c = jnp.asarray(self.center, dtype=origins.dtype)
        oc = origins - c
        a = jnp.sum(dirs * dirs, axis=-1)
        b = 2.0 * jnp.sum(dirs * oc, axis=-1)
        cc = jnp.sum(oc * oc, axis=-1) - self.radius ** 2
        disc = b * b - 4.0 * a * cc
        hit = disc >= 0
        sq = jnp.sqrt(jnp.where(hit, disc, 0.0))
        t_near = (-b - sq) / (2.0 * a)
        t_far = (-b + sq) / (2.0 * a)
        # origin inside the sphere (near root behind): the interior surface
        # at the far root is still visible — matches CuboidScene's
        # inside-the-primitive semantics (exit hit)
        t = jnp.where(t_near > 0, t_near, t_far)
        return jnp.where(hit & (t > 0), t, jnp.nan)


class CuboidScene(NamedTuple):
    """Axis-aligned box [min_corner, max_corner].

    `sdf` is the exact box SDF. The reference's create_cuboid computes a
    slightly different (non-metric inside faces) field; `sdf_reference_style`
    reproduces that exact formula for fixture-parity tests (sdf.cpp:67-81):
    d = min over axes of distance to the NEAREST pair of parallel faces,
    negated inside.
    """

    min_corner: Tuple[float, float, float] = (-0.5, -0.5, -0.5)
    max_corner: Tuple[float, float, float] = (0.5, 0.5, 0.5)

    def sdf(self, x: jnp.ndarray) -> jnp.ndarray:
        lo = jnp.asarray(self.min_corner, dtype=x.dtype)
        hi = jnp.asarray(self.max_corner, dtype=x.dtype)
        center = (lo + hi) / 2.0
        half = (hi - lo) / 2.0
        q = jnp.abs(x - center) - half
        outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
        inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return outside + inside

    def sdf_reference_style(self, x: jnp.ndarray) -> jnp.ndarray:
        lo = jnp.asarray(self.min_corner, dtype=x.dtype)
        hi = jnp.asarray(self.max_corner, dtype=x.dtype)
        d_axis = jnp.minimum(jnp.abs(x - lo), jnp.abs(x - hi))
        d = jnp.min(d_axis, axis=-1)
        inside = jnp.all((x > lo) & (x < hi), axis=-1)
        return jnp.where(inside, -d, d)

    def color(self, x: jnp.ndarray) -> jnp.ndarray:
        ones = jnp.ones_like(x[..., 0])
        return jnp.stack([ones, 0.3 * ones, 0.2 * ones], axis=-1)

    def intersect(self, origins: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
        """Exact slab-method ray-box intersection (NaN on miss)."""
        lo = jnp.asarray(self.min_corner, dtype=origins.dtype)
        hi = jnp.asarray(self.max_corner, dtype=origins.dtype)
        safe_d = jnp.where(dirs == 0, 1e-20, dirs)
        t0 = (lo - origins) / safe_d
        t1 = (hi - origins) / safe_d
        tmin = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tmax = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = jnp.where(tmin > 0, tmin, tmax)
        return jnp.where(hit, t, jnp.nan)


def grid_from_scene(params: GridParams, scene, weight: float = 1.0,
                    reference_style: bool = False) -> TSDFGrid:
    """Populate a grid with the scene's analytic SDF and color at voxel
    centers — the formalized create_circle/create_cuboid (sdf.cpp:62-126).

    NOTE: unlike fusion, this writes the FULL (untruncated) signed distance,
    exactly like the reference fixtures.
    """
    x, y, z = voxel_centers_world(params)
    pts = jnp.stack(jnp.broadcast_arrays(x, y, z), axis=-1)
    sdf_fn = scene.sdf_reference_style if reference_style and hasattr(
        scene, "sdf_reference_style") else scene.sdf
    D = sdf_fn(pts)
    rgb = scene.color(pts)
    m = params.m
    W = jnp.full((m, m, m), weight, dtype=D.dtype)
    return TSDFGrid(D=D, W=W, R=rgb[..., 0], G=rgb[..., 1], B=rgb[..., 2], Wc=W)


def render_scene_depth(
    scene,
    cam: PinholeCamera,
    pose: Pose,
    noise_sigma: float = 0.0,
    key: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Exact (H, W) z-depth image of the analytic scene from `pose`.

    Rays use z=1 camera directions, so the intersection parameter t IS the
    z-depth. Misses are NaN, mirroring Kinect NaN holes.
    """
    dirs_cam, _ = pixel_rays(cam)
    dirs_world = jnp.einsum("ij,hwj->hwi", pose.R, dirs_cam,
                            precision=jax.lax.Precision.HIGHEST)
    origins = jnp.broadcast_to(pose.t, dirs_world.shape)
    t = scene.intersect(origins, dirs_world)
    if noise_sigma > 0.0:
        assert key is not None
        t = t + noise_sigma * jax.random.normal(key, t.shape, dtype=t.dtype)
    return t


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> Pose:
    """Camera-to-world pose: optical axis (+z, y down) toward `target`."""
    eye = jnp.asarray(eye, dtype=jnp.float32)
    target = jnp.asarray(target, dtype=jnp.float32)
    up = jnp.asarray(up, dtype=jnp.float32)
    f = target - eye
    f = f / jnp.linalg.norm(f)
    x = jnp.cross(f, up)
    x = x / jnp.linalg.norm(x)
    y = jnp.cross(f, x)  # y points "down" for a z-up world
    R = jnp.stack([x, y, f], axis=-1)  # columns = camera axes in world
    return Pose(R, eye)


def orbit_poses(n: int, radius: float, height: float, target=(0.0, 0.0, 0.0),
                arc: float = 2.0 * 3.14159265358979) -> list:
    """`n` poses orbiting `target` on a circle — a synthetic trajectory for
    tracking tests with exact groundtruth."""
    import numpy as np

    poses = []
    for ang in np.linspace(0.0, arc, n, endpoint=False):
        eye = (
            target[0] + radius * np.cos(ang),
            target[1] + radius * np.sin(ang),
            target[2] + height,
        )
        poses.append(look_at(eye, target))
    return poses
