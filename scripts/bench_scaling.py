"""Rays/s + sharded-tracking scaling sweep (BASELINE config #5 harness).

Measures:
  1. single-device tracking throughput: pixels (rays) processed per second
     through the full residual+Jacobian+normal-equation path, at several
     pixel counts;
  2. sharded tracking wall time across mesh sizes (1, 2, 4, 8) — on real
     multi-GPU hardware this is the interconnect scaling curve; here it runs
     on the virtual CPU mesh (JAX_PLATFORMS=cpu
     XLA_FLAGS=--xla_force_host_platform_device_count=8) and validates the
     harness + the collective path.

Prints one JSON line per measurement.

Usage:
  python scripts/bench_scaling.py [--rays-only|--mesh-only]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def build(params_m=256):
    from tracking_sdf_tpu.config import GridParams, TrackingConfig
    from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
    from tracking_sdf_tpu.data.synthetic import (
        CuboidScene, SphereScene, grid_from_scene, look_at, render_scene_depth,
    )

    params = GridParams(m=params_m)
    cam = PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                        width=640, height=480)
    sphere = SphereScene(center=(0.3, 1.2, 0.9), radius=0.45)
    box = CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9))
    wall = CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0))

    class Scene:
        def sdf(self, x):
            return jnp.minimum(jnp.minimum(sphere.sdf(x), box.sdf(x)), wall.sdf(x))

        def color(self, x):
            return sphere.color(x)

        def intersect(self, o, d):
            t = sphere.intersect(o, d)
            for s in (box, wall):
                tb = s.intersect(o, d)
                t = jnp.where(jnp.isnan(t), tb,
                              jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
            return t

    pose = look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7))
    grid = grid_from_scene(params, Scene())
    depth = render_scene_depth(Scene(), cam, pose)
    pts = backproject(cam, depth)
    return params, cam, grid, pose, pts, TrackingConfig(max_twist_diff=0.0)


def bench_rays(reps=20):
    """Pixels/s through residual+J+normal-equations (one GN iteration),
    at the PRODUCTION configuration: single-gather masked view (the
    two-gather dense-grid path measures ~20x slower and is not what the
    tracker runs)."""
    from tracking_sdf_tpu.grid.interp import masked_view
    from tracking_sdf_tpu.tracking.gauss_newton import (
        normal_equations, pixel_residuals_analytic,
    )

    params, cam, grid, pose, pts, _ = build()
    Dm = masked_view(grid.D, grid.W)
    for stride in (3, 2, 1):
        p = pts[::stride, ::stride].reshape(-1, 3)
        n = p.shape[0]

        @jax.jit
        def iters(pose_t):
            def body(k, carry):
                A_prev, b_prev = carry
                phi, J, mask = pixel_residuals_analytic(
                    None, pose_t, p + 1e-9 * A_prev[0, 0], params=params,
                    Dm=Dm,
                )
                return normal_equations(phi, J, mask)

            return jax.lax.fori_loop(
                0, reps, body, (jnp.zeros((6, 6)), jnp.zeros((6,)))
            )

        A, b = iters(pose)
        _ = float(A[0, 0])  # value fetch: the warm call has finished
        # before the clock starts
        t0 = time.perf_counter()
        A, b = iters(pose)
        _ = float(A[0, 0])
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "metric": "tracking_rays_per_s",
            "pixels": n,
            "stride": stride,
            "value": round(n / dt / 1e6, 2),
            "unit": "Mrays/s",
        }), flush=True)


def bench_mesh_scaling(reps=5):
    from tracking_sdf_tpu.parallel import make_mesh, shard_grid, sharded_track_frame

    n_dev = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8) if s <= n_dev]
    params, cam, grid, pose, pts, tcfg = build(params_m=128)
    p = pts[::2, ::2].reshape(-1, 3)
    tcfg = tcfg._replace(max_iterations=5)
    for s in sizes:
        mesh = make_mesh(jax.devices()[:s])
        track = sharded_track_frame(mesh, params=params, cfg=tcfg)
        gs = shard_grid(grid, mesh)
        r = track(gs, pose, p)
        jax.block_until_ready(r.pose.t)
        t0 = time.perf_counter()
        for _ in range(reps):
            r = track(gs, pose, p)
        _ = float(r.pose.t[0])
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "metric": "sharded_track_frame_ms",
            "devices": s,
            "pixels": int(p.shape[0]),
            "value": round(dt * 1e3, 2),
            "unit": "ms",
        }), flush=True)


def bench_render_scaling(reps=3):
    """Ray-sharded renderer across mesh sizes (the BASELINE
    "renderer rays/s 1 chip -> N" ladder harness; on the virtual CPU mesh
    this validates the harness + the all-gather path and shows RELATIVE
    march scaling; absolute numbers need real multi-GPU hardware)."""
    from tracking_sdf_tpu.parallel import make_mesh, shard_grid
    from tracking_sdf_tpu.parallel.render import sharded_raycast

    n_dev = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8) if s <= n_dev]
    params, cam, grid, pose, pts, tcfg = build(params_m=128)
    for s in sizes:
        mesh = make_mesh(jax.devices()[:s])
        fn = sharded_raycast(mesh, params=params, cam=cam, stride=2)
        gs = shard_grid(grid, mesh)
        r = fn(gs, pose)
        _ = float(jnp.nansum(r.depth))
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(gs, pose)
        _ = float(jnp.nansum(r.depth))
        dt = (time.perf_counter() - t0) / reps
        n_rays = r.depth.size
        print(json.dumps({
            "metric": "sharded_raycast_ms",
            "devices": s,
            "rays": int(n_rays),
            "value": round(dt * 1e3, 2),
            "mrays_per_s": round(n_rays / dt / 1e6, 3),
            "unit": "ms",
        }), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays-only", action="store_true")
    ap.add_argument("--mesh-only", action="store_true")
    ap.add_argument("--render-scaling", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (pair with "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=8 "
                         "for the virtual mesh sweep)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.render_scaling:
        bench_render_scaling()
    else:
        if not args.mesh_only:
            bench_rays()
        if not args.rays_only:
            bench_mesh_scaling()
