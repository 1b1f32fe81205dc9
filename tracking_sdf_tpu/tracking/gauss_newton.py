"""Direct Gauss-Newton camera tracking against the TSDF.

Reimplements CameraTracking::estimate_new_position (reference
camera_tracking.cpp:66-245) for an accelerator:

* the per-pixel residual phi and 6-vector twist Jacobian are computed for ALL
  pixels at once (vmapped/batched interpolation) instead of an OpenMP loop;
* the normal equations A = J^T J (6x6) and b = J^T r are ONE (6, N) x (N, 6)
  matmul at HIGHEST precision — replacing per-thread partial sums
  with a serial reduction (camera_tracking.cpp:148-189). Under pjit with
  pixels sharded over a mesh axis, XLA turns the same contraction into
  per-device partials + a psum (SURVEY.md P1);
* the 20-iteration outer loop is a lax.while_loop; convergence and the pose
  update come in reference-compatible and corrected variants (see
  TrackingConfig);
* Jacobians come either from the ANALYTIC gradient of trilinear interpolation
  chain-ruled to the twist (default; 1 grid lookup per pixel) or from the
  reference's 13-probe central-difference scheme over Shepard-L1 interpolation
  (camera_tracking.cpp:246-363) for parity.

Math notes. The twist perturbs the camera-to-world pose on the LEFT in world
frame: x(w, v) = (I + hat(w)) R p + t + v, so
    dphi/dv = grad_w phi               (world-frame SDF gradient)
    dphi/dw = (R p) x grad_w phi       (a x g, a = R p = x - t)
which equals the limit of the reference's finite-difference probes (its
translation probes step the voxel coordinate = a world-frame step; its
rotation probes use (I +- w_h * hat(e_i)) R, camera_tracking.cpp:92-145).
The solved step `twist = A^{-1} b` has the sign of the residual GRADIENT, so
the pose update applies exp(twist)^{-1} — the reference does the same
(camera_tracking.cpp:237-238), modulo its translation quirk.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tracking_sdf_tpu.config import GridParams, TrackingConfig
from tracking_sdf_tpu.core.lie import Pose, se3_exp
from tracking_sdf_tpu.grid.grid import TSDFGrid, world_to_voxel
from tracking_sdf_tpu.grid.interp import (
    masked_view,
    shepard_l1,
    trilinear_with_grad,
    trilinear_with_grad_nan,
)

_HI = jax.lax.Precision.HIGHEST


class TrackResult(NamedTuple):
    pose: Pose
    iterations: jnp.ndarray  # () int32 — GN iterations executed
    final_twist: jnp.ndarray  # (6,) last solved twist step
    num_valid: jnp.ndarray  # () int32 — valid pixels in the last iteration
    mean_abs_residual: jnp.ndarray  # () mean |phi| over valid pixels, last iter


def strided_points(points_img: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Flatten an organized (H, W, 3) point image to the reference's strided
    pixel lattice u, v in {0, stride, 2*stride, ...} (camera_tracking.cpp:162-163).
    Returns (N, 3) with NaN holes preserved (masked downstream)."""
    return points_img[::stride, ::stride, :].reshape(-1, 3)


def _sanitize(points_cam: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    valid = jnp.all(jnp.isfinite(points_cam), axis=-1)
    return jnp.where(valid[:, None], points_cam, 0.0), valid


def pixel_residuals_analytic(
    grid: TSDFGrid,
    pose: Pose,
    points_cam: jnp.ndarray,  # (N, 3), NaN holes allowed
    *,
    params: GridParams,
    Dm: Optional[jnp.ndarray] = None,  # masked_view(grid.D, grid.W) if precomputed
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(phi (N,), J (N, 6), mask (N,)) via trilinear value + analytic gradient.

    Pass ``Dm`` (one elementwise pass per frame) to halve the gather count
    per call — the hot-loop configuration used by track_frame."""
    p, valid_in = _sanitize(points_cam)
    x = jnp.einsum("ij,nj->ni", pose.R, p, precision=_HI) + pose.t  # world
    uvw = world_to_voxel(params, x)
    in_bounds = jnp.all((uvw >= 0) & (uvw < params.m), axis=-1)  # :261-268

    if Dm is not None:
        phi, g_uvw, ok = trilinear_with_grad_nan(Dm, uvw)
    else:
        phi, g_uvw, ok = trilinear_with_grad(grid.D, grid.W, uvw)
    # voxel-space gradient -> world meters
    scale = jnp.asarray(
        [params.m / params.width, params.m / params.height, params.m / params.depth],
        dtype=g_uvw.dtype,
    )
    g_world = g_uvw * scale
    a = x - pose.t  # R p
    J = jnp.concatenate([g_world, jnp.cross(a, g_world)], axis=-1)
    mask = valid_in & in_bounds & ok
    return phi, J, mask


def pixel_residuals_central(
    grid: TSDFGrid,
    pose: Pose,
    points_cam: jnp.ndarray,
    *,
    params: GridParams,
    v_h: float = 1.0,
    w_h: float = 0.01,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reference-parity residuals: 13 Shepard-L1 probes per pixel
    (camera_tracking.cpp:246-363). A pixel is valid only if ALL probes
    interpolate (the reference's early-outs discard the pixel)."""
    p, valid_in = _sanitize(points_cam)
    dtype = grid.D.dtype
    x = jnp.einsum("ij,nj->ni", pose.R, p, precision=_HI) + pose.t
    uvw = world_to_voxel(params, x)
    in_bounds = jnp.all((uvw >= 0) & (uvw < params.m), axis=-1)

    phi, ok0 = shepard_l1(grid.D, grid.W, uvw)
    mask = valid_in & in_bounds & ok0

    cols = []
    # translation probes: +-v_h in VOXEL units along each grid axis,
    # divided by 2*v_h*(extent/m) meters (camera_tracking.cpp:13-17, 286/301/316)
    ext = (params.width, params.height, params.depth)
    for axis in range(3):
        e = jnp.zeros((3,), dtype=dtype).at[axis].set(v_h)
        vp, okp = shepard_l1(grid.D, grid.W, uvw + e)
        vm, okm = shepard_l1(grid.D, grid.W, uvw - e)
        mask = mask & okp & okm
        cols.append((vp - vm) / (2.0 * v_h * ext[axis] / params.m))
    # rotation probes: (I +- w_h hat(e_i)) R p + t (camera_tracking.cpp:92-145)
    for axis in range(3):
        w_vec = jnp.zeros((3,), dtype=dtype).at[axis].set(w_h)
        # (I + hat(w)) R p = x - t + w x (x - t); cheaper than materializing R'
        a = x - pose.t
        delta = jnp.cross(jnp.broadcast_to(w_vec, a.shape), a)
        up = world_to_voxel(params, x + delta)
        um = world_to_voxel(params, x - delta)
        vp, okp = shepard_l1(grid.D, grid.W, up)
        vm, okm = shepard_l1(grid.D, grid.W, um)
        mask = mask & okp & okm
        cols.append((vp - vm) / (2.0 * w_h))
    J = jnp.stack(cols, axis=-1)
    return phi, J, mask


def normal_equations(
    phi: jnp.ndarray, J: jnp.ndarray, mask: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """A = J^T J, b = J^T phi over valid pixels — one matmul.

    Under a sharded pixel axis this contraction becomes per-device partials
    + psum, replacing the reference's per-thread A_array/B_array + serial
    reduce (camera_tracking.cpp:148-189).
    """
    Jm = jnp.where(mask[:, None], J, 0.0)
    rm = jnp.where(mask, phi, 0.0)
    A = jnp.einsum("ni,nj->ij", Jm, Jm, precision=_HI)
    b = jnp.einsum("ni,n->i", Jm, rm, precision=_HI)
    return A, b


def _apply_update(pose: Pose, twist: jnp.ndarray, mode: str) -> Pose:
    e = se3_exp(twist)
    Ret = e.R.T
    if mode == "se3":
        # exact left-inverse composition: T <- exp(twist)^-1 ∘ T
        R_new = jnp.matmul(Ret, pose.R, precision=_HI)
        t_new = jnp.matmul(Ret, (pose.t - e.t)[:, None], precision=_HI)[:, 0]
    elif mode == "reference":
        # camera_tracking.cpp:237-238 — t is NOT rotated (quirk)
        R_new = jnp.matmul(Ret, pose.R, precision=_HI)
        t_new = pose.t - jnp.matmul(Ret, e.t[:, None], precision=_HI)[:, 0]
    else:
        raise ValueError(f"unknown pose_update: {mode}")
    return Pose(R_new, t_new)


@partial(jax.jit, static_argnames=("params", "cfg"))
def track_frame(
    grid: Optional[TSDFGrid],
    pose0: Pose,
    points_cam: jnp.ndarray,  # (N, 3) strided camera-frame points (NaN holes ok)
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
    Dm: Optional[jnp.ndarray] = None,  # precomputed masked_view (brick-major
    # fusion emits it as part of its merge relayout — skip the per-frame pass)
) -> TrackResult:
    """Estimate the camera pose for one frame by GN descent on sum phi^2.

    ``grid`` may be None when ``Dm`` is given and jacobian == "analytic"
    (the brick-major pipeline never materializes the dense grid)."""

    if Dm is None and cfg.jacobian == "analytic":
        # one gather per query instead of two in every GN iteration
        Dm = masked_view(grid.D, grid.W)
    # compute dtype: >= f32 even over bf16 grid storage (interp promotes)
    dtype = jnp.promote_types(
        Dm.dtype if Dm is not None else grid.D.dtype, jnp.float32)

    def residuals(pose):
        if cfg.jacobian == "analytic":
            return pixel_residuals_analytic(
                grid, pose, points_cam, params=params, Dm=Dm
            )
        elif cfg.jacobian == "central":
            return pixel_residuals_central(
                grid, pose, points_cam, params=params, v_h=cfg.v_h, w_h=cfg.w_h
            )
        raise ValueError(f"unknown jacobian mode: {cfg.jacobian}")

    def converged(twist):
        if cfg.convergence == "norm":
            return jnp.max(jnp.abs(twist)) < cfg.max_twist_diff
        elif cfg.convergence == "signed":
            # reference quirk: signed comparison (camera_tracking.cpp:216-221)
            return jnp.all(twist < cfg.max_twist_diff)
        raise ValueError(f"unknown convergence mode: {cfg.convergence}")

    def cond(state):
        i, _, done, *_ = state
        return (i < cfg.max_iterations) & jnp.logical_not(done)

    def body(state):
        i, pose, _, _, _, _, lam = state
        phi, J, mask = residuals(pose)
        A, b = normal_equations(phi, J, mask)
        # Marquardt damping (relative, scale-free); tiny absolute floor so a
        # fully-degenerate system stays solvable (guard below catches NaNs)
        A = A + lam * jnp.diag(jnp.diag(A)) + 1e-12 * jnp.eye(6, dtype=A.dtype)
        twist = jnp.linalg.solve(A, b)
        # guard a singular system (e.g. zero valid pixels): no step
        twist = jnp.where(jnp.all(jnp.isfinite(twist)), twist, jnp.zeros_like(twist))
        done = converged(twist) & (i + 1 >= cfg.min_iterations)
        # the reference updates the pose even on the converging iteration
        pose_new = _apply_update(pose, twist, cfg.pose_update)
        nvalid = jnp.sum(mask.astype(jnp.int32))
        mean_res = jnp.sum(jnp.where(mask, jnp.abs(phi), 0.0)) / jnp.maximum(nvalid, 1)
        return (i + 1, pose_new, done, twist, nvalid, mean_res,
                lam * cfg.damping_decay)

    state0 = (
        jnp.int32(0),
        pose0,
        jnp.bool_(False),
        jnp.zeros((6,), dtype=dtype),
        jnp.int32(0),
        jnp.zeros((), dtype=dtype),
        jnp.asarray(cfg.damping, dtype=dtype),
    )
    i, pose, _, twist, nvalid, mean_res, _ = jax.lax.while_loop(cond, body, state0)
    return TrackResult(pose=pose, iterations=i, final_twist=twist,
                       num_valid=nvalid, mean_abs_residual=mean_res)
