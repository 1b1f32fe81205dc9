"""Render-loss pose refinement demo.

Uses the differentiable raycaster END-TO-END: gradient descent (adam,
cosine-decayed lr) on a depth+normal render loss — gradients flowing
through the implicit-function Newton step w.r.t. the camera pose —
against a held-out rendered view, and compares its convergence BASIN
with the Gauss-Newton SDF tracker's across perturbation magnitudes.

CPU-friendly (64^3 grid, 96x72 strided renders):

    python scripts/demo_render_refine.py

Expected shape of the result: the GN
tracker converges faster per step and from mid-size perturbations, but
only consumes point measurements; the render-loss refinement works from
images alone (no backprojection), converges from comparable basins at
~300 gradient steps, and extends to any differentiable image loss
(color, silhouette) — the capability axis BASELINE.md names.
"""
import sys

sys.path.insert(0, "/root/repo")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax

from tracking_sdf_tpu.config import GridParams, RaycastConfig, TrackingConfig
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.core.lie import (
    pose_compose, pose_inverse, se3_exp, se3_log)
from tracking_sdf_tpu.data import (
    CuboidScene, SphereScene, grid_from_scene, look_at, render_scene_depth)
from tracking_sdf_tpu.render import raycast
from tracking_sdf_tpu.tracking import strided_points, track_frame

PARAMS = GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.1, epsilon=0.01)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.0, 0.0, 0.0), radius=0.5)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55),
                  max_corner=(-0.35, 0.4, 0.15))


class Scene:  # symmetry-broken: all 6 DoF observable
    def sdf(self, x):
        return jnp.minimum(SPHERE.sdf(x), BOX.sdf(x))

    def color(self, x):
        return SPHERE.color(x)

    def intersect(self, o, d):
        ta, tb = SPHERE.intersect(o, d), BOX.intersect(o, d)
        return jnp.where(jnp.isnan(ta), tb,
                         jnp.where(jnp.isnan(tb), ta, jnp.minimum(ta, tb)))


POSE = look_at((0.0, -1.6, 0.2), (0.0, 0.0, 0.0))
GRID = grid_from_scene(PARAMS, Scene())
RC = RaycastConfig(t_near=0.05, t_far=4.0)
STRIDE = 2
TGT = raycast(GRID, POSE, params=PARAMS, cam=CAM, cfg=RC, stride=STRIDE)


def refine_render(pose_init, steps=300, lr0=5e-3):
    def loss(xi):
        pose = pose_compose(se3_exp(xi), pose_init)
        r = raycast(GRID, pose, params=PARAMS, cam=CAM, cfg=RC,
                    stride=STRIDE)
        ok = r.hit & jnp.isfinite(TGT.depth)
        resid = jnp.where(ok, r.depth - TGT.depth, 0.0)
        d = 0.05
        h = jnp.where(jnp.abs(resid) < d, 0.5 * resid * resid,
                      d * (jnp.abs(resid) - 0.5 * d))
        n_est = jnp.where(ok[..., None], r.normal_cam, 0.0)
        n_t = jnp.where(ok[..., None], TGT.normal_cam, 0.0)
        nl = jnp.sum(jnp.where(ok, 1.0 - jnp.sum(n_est * n_t, -1), 0.0))
        return (jnp.sum(h) + 0.01 * nl) / jnp.maximum(jnp.sum(ok), 1)

    gf = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(optax.cosine_decay_schedule(lr0, steps))
    xi = jnp.zeros(6, jnp.float32)
    st = opt.init(xi)
    for _ in range(steps):
        _, g = gf(xi)
        upd, st = opt.update(g, st)
        xi = optax.apply_updates(xi, upd)
    return pose_compose(se3_exp(xi), pose_init)


def refine_gn(pose_init):
    depth = render_scene_depth(Scene(), CAM, POSE)
    pts = strided_points(backproject(CAM, depth), 2).reshape(-1, 3)
    res = track_frame(GRID, pose_init, pts, params=PARAMS,
                      cfg=TrackingConfig(max_iterations=40))
    return res.pose


def err_mm(pose):
    e = np.asarray(se3_log(pose_compose(pose_inverse(pose), POSE)))
    return np.linalg.norm(e[:3]) * 1e3, np.linalg.norm(e[3:])


def main():
    print(f"{'perturb |t| mm':>15} {'GN |t| mm':>10} {'render |t| mm':>14} "
          f"{'GN |w|':>8} {'render |w|':>10}")
    for scale in (0.5, 1.0, 2.0, 3.0):
        xi0 = scale * jnp.asarray([0.04, -0.03, 0.03, 0.03, -0.02, 0.02],
                                  jnp.float32)
        pose_init = pose_compose(se3_exp(xi0), POSE)
        t0, _ = err_mm(pose_init)
        tg, wg = err_mm(refine_gn(pose_init))
        tr, wr = err_mm(refine_render(pose_init))
        print(f"{t0:15.1f} {tg:10.1f} {tr:14.1f} {wg:8.4f} {wr:10.4f}",
              flush=True)


if __name__ == "__main__":
    main()
