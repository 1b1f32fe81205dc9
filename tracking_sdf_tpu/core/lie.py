"""SO(3)/SE(3) Lie-group utilities, branchless and autodiff-safe.

Twist layout is ``(v1, v2, v3, w1, w2, w3)`` — translation first — matching
the reference (camera_tracking.cpp:70, eigen_utils.cpp:95-97). The exponential
map reproduces the math of the reference's ViSP-derived
``direct_exponential_map`` (eigen_utils.cpp:85-128): R = Rodrigues(w) and
t = V(w) v, with the same small-angle series values (sinc -> 1, (1-cos)/th^2
-> 1/2, (1-sinc)/th^2 -> 1/6). Unlike the reference's branches at 1e-8 /
2.5e-4, the guards here are branchless ``jnp.where`` with safe denominators so
the functions are jit- and grad-compatible at theta = 0.

A camera pose is a ``Pose(R, t)`` mapping CAMERA -> WORLD coordinates
(x_world = R @ x_cam + t), the same convention as the reference's
``project_camera_to_world`` (camera_tracking.cpp:55-58).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_SMALL = 1e-8

# 3x3 pose algebra must stay full float32: at default precision a GPU may
# run a float32 matmul in TF32 (10-bit mantissa), ~1e-3 relative error in
# rotation entries, which dwarfs the tracker's 1e-3 convergence threshold.
# These matmuls are tiny; HIGHEST costs nothing.
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


class Pose(NamedTuple):
    """Camera-to-world rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: jnp.ndarray
    t: jnp.ndarray


def pose_identity(dtype=jnp.float32) -> Pose:
    return Pose(jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype))


def pose_inverse(p: Pose) -> Pose:
    Rt = jnp.swapaxes(p.R, -1, -2)
    return Pose(Rt, -(_mm(Rt, p.t[..., None]))[..., 0])


def pose_compose(a: Pose, b: Pose) -> Pose:
    """Returns a ∘ b (apply b first, then a)."""
    return Pose(_mm(a.R, b.R), (_mm(a.R, b.t[..., None]))[..., 0] + a.t)


def pose_apply(p: Pose, x: jnp.ndarray) -> jnp.ndarray:
    """Apply pose to points of shape (..., 3).

    Batched poses (R (..., 3, 3), t (..., 3)) broadcast against the points'
    leading dims, matching pose_inverse/pose_compose."""
    return jnp.einsum("...ij,...j->...i", p.R, x,
                      precision=jax.lax.Precision.HIGHEST) + p.t


def so3_hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix: hat(w) @ x == cross(w, x)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def _theta_coeffs(theta_sq: jnp.ndarray):
    """Branchless (sinc, mcosc, msinc) = (sin/th, (1-cos)/th^2, (th-sin)/th^3).

    Reference equivalents: f_sinc / f_mcosc / f_msinc (eigen_utils.cpp:43-59).
    Near zero, uses the Taylor series to 2nd order (more accurate than the
    reference's constant fallback).
    """
    small = theta_sq < _SMALL
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    sinc = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    mcosc = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / safe_sq)
    msinc = jnp.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - jnp.sin(theta) / theta) / safe_sq
    )
    return sinc, mcosc, msinc


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: exp(hat(w)). Matches UThetaToAffine3d (eigen_utils.cpp:61-83)."""
    theta_sq = jnp.sum(w * w, axis=-1)
    sinc, mcosc, _ = _theta_coeffs(theta_sq)
    K = so3_hat(w)
    eye = jnp.eye(3, dtype=w.dtype)
    # K @ K == w w^T - theta^2 I : an elementwise outer product, full f32
    # without any matmul precision setting
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    return eye + sinc[..., None, None] * K + mcosc[..., None, None] * KK


def so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """V(w) = I + mcosc*K + msinc*K^2; t = V(w) v in se3_exp.

    This is the matrix the reference builds element-wise in
    direct_exponential_map (eigen_utils.cpp:108-118).
    """
    theta_sq = jnp.sum(w * w, axis=-1)
    _, mcosc, msinc = _theta_coeffs(theta_sq)
    K = so3_hat(w)
    eye = jnp.eye(3, dtype=w.dtype)
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    return eye + mcosc[..., None, None] * K + msinc[..., None, None] * KK


def se3_exp(xi: jnp.ndarray, dt: float | jnp.ndarray = 1.0) -> Pose:
    """exp of twist (v, w) * dt -> Pose(R, t). Matches direct_exponential_map."""
    xi = xi * dt
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_mm(so3_left_jacobian(w), v[..., None]))[..., 0]
    return Pose(R, t)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse of so3_exp, valid for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # vee of the antisymmetric part
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    theta_sq = theta * theta
    small = theta_sq < _SMALL
    safe_theta = jnp.where(small, 1.0, theta)
    # w = theta / (2 sin(theta)) * vee; series: 1/2 + theta^2/12 near 0
    scale = jnp.where(
        small, 0.5 + theta_sq / 12.0, safe_theta / (2.0 * jnp.sin(safe_theta))
    )
    return scale[..., None] * vee


def se3_log(p: Pose) -> jnp.ndarray:
    """Inverse of se3_exp: Pose -> twist (v, w)."""
    w = so3_log(p.R)
    theta_sq = jnp.sum(w * w, axis=-1)
    sinc, mcosc, _ = _theta_coeffs(theta_sq)
    K = so3_hat(w)
    eye = jnp.eye(3, dtype=w.dtype)
    # V^{-1} = I - K/2 + coeff * K^2, coeff = (1 - sinc/(2 mcosc)) / theta^2
    small = theta_sq < _SMALL
    safe_sq = jnp.where(small, 1.0, theta_sq)
    coeff = jnp.where(
        small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - sinc / (2.0 * mcosc)) / safe_sq
    )
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    V_inv = eye - 0.5 * K + coeff[..., None, None] * KK
    v = (_mm(V_inv, p.t[..., None]))[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def quaternion_from_matrix(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order.

    Shepperd's method, branchless via selecting the numerically best of the
    four candidate constructions.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (always >= 0).
    qw_sq = jnp.maximum(1.0 + tr, 0.0)
    qx_sq = jnp.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy_sq = jnp.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz_sq = jnp.maximum(1.0 - m00 - m11 + m22, 0.0)

    # All four candidates are computed and the best is where-selected (no
    # lax.switch: its branch index must be a scalar, which would forbid
    # batched R). The non-selected candidates may divide by s == 0, so the
    # denominator is made safe; the argmax candidate always has
    # q*_sq >= 1 (the four sum to 4), hence s >= 2.
    def cand(sq, a, b, c, pos):
        s = 2.0 * jnp.sqrt(sq)
        safe = jnp.where(s > 0, s, 1.0)
        parts = [a / safe, b / safe, c / safe]
        parts.insert(pos, s / 4.0)
        return jnp.stack(parts, -1)

    cands = jnp.stack(
        [
            cand(qw_sq, m21 - m12, m02 - m20, m10 - m01, 3),
            cand(qx_sq, m01 + m10, m02 + m20, m21 - m12, 0),
            cand(qy_sq, m01 + m10, m12 + m21, m02 - m20, 1),
            cand(qz_sq, m02 + m20, m12 + m21, m10 - m01, 2),
        ],
        axis=-2,
    )  # (..., 4, 4)
    idx = jnp.argmax(jnp.stack([qw_sq, qx_sq, qy_sq, qz_sq], axis=-1), axis=-1)
    return jnp.take_along_axis(
        cands, idx[..., None, None].astype(jnp.int32), axis=-2
    )[..., 0, :]


def matrix_from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n > 0, 2.0 / n, 0.0)
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
        ],
        axis=-2,
    )
