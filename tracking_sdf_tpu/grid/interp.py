"""Grid interpolation kernels.

Two families:

* :func:`trilinear` / :func:`trilinear_with_grad` — the default:
  true trilinear interpolation with per-corner observation masking (W > 0)
  and renormalization, plus the exact ANALYTIC gradient w.r.t. the continuous
  voxel coordinate. Fully differentiable; one gather of 8 corners per query.

* :func:`shepard_l1` — bit-faithful reproduction of the reference's
  non-standard scheme (SDF::interpolate_distance, sdf.cpp:127-163):
  inverse-L1-distance (Shepard) weights w = 1/(|di|+|dj|+|dk|) over the 8
  corners surrounding trunc(coords) (C-style (int) cast, truncation toward
  zero — NOT floor), corners skipped when out of bounds or W <= 0, and an
  early exact-hit return when the L1 distance < 1e-5. Used for parity tests
  and the "central" Jacobian mode.

All functions take coords in CONTINUOUS VOXEL units (see
grid.world_to_voxel) of shape (..., 3) and return values shaped (...,).
Invalid queries return value 0 with valid=False — callers carry the mask
(no data-dependent control flow) where the C++ used `continue`.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Corner offsets in the reference's loop order (i, j, k nested; sdf.cpp:140-145).
_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [0, 1, 1],
        [1, 0, 0],
        [1, 0, 1],
        [1, 1, 0],
        [1, 1, 1],
    ],
    dtype=np.int32,
)


def _gather_corners(vol: jnp.ndarray, ci, cj, ck):
    """Gather vol[ci, cj, ck] with out-of-bounds lanes clamped (and masked by caller)."""
    m0, m1, m2 = vol.shape
    ci = jnp.clip(ci, 0, m0 - 1)
    cj = jnp.clip(cj, 0, m1 - 1)
    ck = jnp.clip(ck, 0, m2 - 1)
    return vol[ci, cj, ck]


def _corner_indices(base: jnp.ndarray):
    """base (..., 3) int -> per-corner indices (..., 8) for each axis."""
    off = jnp.asarray(_OFFSETS)  # (8, 3)
    ci = base[..., None, 0] + off[:, 0]
    cj = base[..., None, 1] + off[:, 1]
    ck = base[..., None, 2] + off[:, 2]
    return ci, cj, ck


def _in_bounds(ci, cj, ck, shape):
    return (
        (ci >= 0)
        & (ci < shape[0])
        & (cj >= 0)
        & (cj < shape[1])
        & (ck >= 0)
        & (ck < shape[2])
    )


def trilinear(
    D: jnp.ndarray, W: jnp.ndarray, coords: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Masked renormalized trilinear interpolation. Returns (value, valid)."""
    value, _, valid = trilinear_with_grad(D, W, coords)
    return value, valid


def trilinear_with_grad(
    D: jnp.ndarray, W: jnp.ndarray, coords: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Trilinear value + analytic gradient w.r.t. voxel coords.

    value = N/Z with N = sum_i m_i w_i(f) D_i, Z = sum_i m_i w_i(f), where
    w_i are the trilinear corner weights of the fractional position f and
    m_i masks unobserved (W <= 0) or out-of-bounds corners. The gradient is
    the exact quotient-rule derivative of the renormalized form, so it stays
    correct (and autodiff-consistent) at partially-observed cells.

    Returns (value (...,), grad (..., 3), valid (...,)).

    Like trilinear_with_grad_nan, ALL math runs in >= float32 regardless of
    the storage dtype: with bfloat16 grids (FusionConfig.storage_dtype) the
    corners are upcast right after the gather, so raycast Newton refinement
    and marching-cubes edge interpolation keep full precision.
    """
    dtype = jnp.promote_types(D.dtype, jnp.float32)
    base_f = jnp.floor(coords)
    base = base_f.astype(jnp.int32)
    f = (coords - base_f).astype(dtype)  # fractional position in [0, 1)

    ci, cj, ck = _corner_indices(base)
    inb = _in_bounds(ci, cj, ck, D.shape)
    d = _gather_corners(D, ci, cj, ck).astype(dtype)
    w_obs = _gather_corners(W, ci, cj, ck)
    mask = (inb & (w_obs > 0)).astype(dtype)  # (..., 8)

    off = jnp.asarray(_OFFSETS, dtype=dtype)  # (8, 3)
    # Per-axis factor: o ? f : 1-f  -> (..., 8, 3)
    fax = off * f[..., None, :] + (1.0 - off) * (1.0 - f[..., None, :])
    w = fax[..., 0] * fax[..., 1] * fax[..., 2]  # (..., 8)

    wm = w * mask
    Z = jnp.sum(wm, axis=-1)
    N = jnp.sum(wm * d, axis=-1)
    valid = Z > 1e-12
    safe_Z = jnp.where(valid, Z, 1.0)
    value = jnp.where(valid, N / safe_Z, 0.0)

    # dw_i/df_a = sign_a * prod_{b != a} fax_b ; sign_a = o_a ? +1 : -1
    sign = 2.0 * off - 1.0  # (8, 3)
    prod_other = jnp.stack(
        [
            fax[..., 1] * fax[..., 2],
            fax[..., 0] * fax[..., 2],
            fax[..., 0] * fax[..., 1],
        ],
        axis=-1,
    )  # (..., 8, 3)
    dw = sign * prod_other * mask[..., None]  # (..., 8, 3)
    dN = jnp.sum(dw * d[..., None], axis=-2)  # (..., 3)
    dZ = jnp.sum(dw, axis=-2)  # (..., 3)
    grad = jnp.where(
        valid[..., None], (dN * safe_Z[..., None] - N[..., None] * dZ) / (safe_Z ** 2)[..., None], 0.0
    )
    return value, grad, valid


_OFF4 = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.int32)

_ROW_W = 128  # corner-fetch gather row width (see _corner_fetch_rows)


def _corner_fetch_rows(
    vol: jnp.ndarray, base: jnp.ndarray, row_w: int = _ROW_W
) -> jnp.ndarray:
    """All 8 corner values vol[clip(base+off)] via width-128 row gathers.

    The layout was tuned where gather cost was per ROW, nearly independent
    of row width, and a flat 2D (rows, width) table beat 3D-operand
    advanced indexing. The 8 cube corners are 4 (i, j) pairs x 2
    k-adjacent elements, so fetching 2 consecutive rows per pair (8 rows
    total) always covers both k lanes; lane extraction is an iota-mask
    reduction fused by XLA. Width 128 measured fastest there against
    width-8, -16 and -32 rows. None of this is measured on the H100,
    where fetching 8 scalars per query is the plain alternative.

    Exactly equivalent to the clip-indexed per-corner gather for ALL inputs:
    both corner flat indices are computed with per-corner clipping, so
    boundary behavior (base_k = -1 or m-1) matches the reference path
    bit-for-bit. Out-of-bounds corners still return clamped values that the
    caller masks via _in_bounds.

    base: (..., 3) int32. Returns (..., 8) in _OFFSETS order.
    """
    m0, m1, m2 = vol.shape
    n_rows = (m0 * m1 * m2) // row_w
    t = vol.reshape(n_rows, row_w)
    off = jnp.asarray(_OFF4)
    ci = jnp.clip(base[..., 0, None] + off[:, 0], 0, m0 - 1)  # (..., 4)
    cj = jnp.clip(base[..., 1, None] + off[:, 1], 0, m1 - 1)
    k0 = jnp.clip(base[..., 2], 0, m2 - 1)
    k1 = jnp.clip(base[..., 2] + 1, 0, m2 - 1)
    colbase = (ci * m1 + cj) * m2  # (..., 4)
    f0 = colbase + k0[..., None]
    r0 = f0 // row_w
    rows = jnp.stack([r0, r0 + 1], axis=-1)  # (..., 4, 2)
    got = jnp.take(t, rows.reshape(*base.shape[:-1], 8), axis=0, mode="clip")
    got = got.reshape(*base.shape[:-1], 4, 2 * row_w)
    lane0 = f0 - r0 * row_w
    lane1 = lane0 + (k1 - k0)[..., None]  # k-clip collapses both to one lane
    io = jnp.arange(2 * row_w, dtype=jnp.int32)
    # where-select, NOT multiply-by-mask: the table may hold NaN sentinels
    # (masked_view) and NaN * 0 = NaN would poison every window.
    v0 = jnp.sum(jnp.where(io == lane0[..., None], got, 0.0), axis=-1)
    v1 = jnp.sum(jnp.where(io == lane1[..., None], got, 0.0), axis=-1)
    return jnp.stack([v0, v1], axis=-1).reshape(*base.shape[:-1], 8)


def _corner_fetch(vol: jnp.ndarray, base: jnp.ndarray) -> jnp.ndarray:
    """8 corner values at base..base+1, fast-path when the flat size allows
    the narrow row view (always for m in {64, 128, 256, 512}; tiny test
    grids fall back to plain advanced indexing)."""
    if (vol.shape[0] * vol.shape[1] * vol.shape[2]) % _ROW_W == 0:
        return _corner_fetch_rows(vol, base)
    ci, cj, ck = _corner_indices(base)
    return _gather_corners(vol, ci, cj, ck)


@jax.tree_util.register_pytree_node_class
class BrickMaskedView:
    """Masked SDF view (W <= 0 -> NaN) in BRICK-MAJOR storage order.

    ``rows`` is the brick-major flat array (fusion.brickmajor.BrickGrid.D,
    which already holds the NaN sentinel as its storage invariant) viewed as
    (total // 128, 128) gather rows. Addressing is by GLOBAL brick-major
    flat index F = brick_row * BV + intra-brick offset, so rows may straddle
    brick boundaries — only total % 128 == 0 is required.

    Purpose: tracking's corner fetch can gather straight from the fused
    brick grid — 8 row-gathers per query exactly like the flat-layout path
    — which removes the per-frame Dm relayout transpose from the frame
    budget entirely. The flat (m, m, m) view remains available on demand for
    raycasting/meshing via fusion.brickmajor.masked_dense_D.

    ``pitch`` is the flat-element stride between consecutive bricks' D rows
    (default BV = one brick per row). The PACKED layout (fusion.packed,
    one (NB, C, BV) array with D at channel 0) sets pitch = C * BV: the
    same ``rows`` view then addresses D rows through the interleaved
    channels with no copy.

    ``mi`` (i-extent in voxels; default m) supports SLAB-LOCAL views for
    SPMD tracking (parallel.sharded.sharded_track_frame_brickmajor): the
    rows hold only this shard's nbi_local brick layers plus one ppermute'd
    halo layer, addressed by slab-local i in [0, mi). j/k stay global.
    """

    __slots__ = ("rows", "m", "bs", "pitch", "mi")

    def __init__(self, rows: jnp.ndarray, m: int, bs: Tuple[int, int, int],
                 pitch: int = 0, mi: int = 0):
        self.rows = rows
        self.m = m
        self.bs = tuple(bs)
        bi, bj, bk = self.bs
        self.pitch = pitch if pitch else bi * bj * bk
        self.mi = mi if mi else m

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def shape(self):
        return (self.mi, self.m, self.m)

    def tree_flatten(self):
        return (self.rows,), (self.m, self.bs, self.pitch, self.mi)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1], aux[2], aux[3])


def _corner_fetch_brick(view: BrickMaskedView, base: jnp.ndarray) -> jnp.ndarray:
    """All 8 corner values from a BrickMaskedView via per-corner row gathers.

    Same cost profile as _corner_fetch_rows (8 width-128 row gathers per
    query + one iota-mask lane extraction each); only the address math
    changes: clipped corner (i, j, k) -> brick-major flat index -> (row,
    lane). Boundary behavior matches the flat path: per-corner clip to the
    grid, out-of-bounds corners masked by the caller via _in_bounds.
    """
    bi, bj, bk = view.bs
    m = view.m
    nbj, nbk = m // bj, m // bk
    ci, cj, ck = _corner_indices(base)  # (..., 8) each
    ci = jnp.clip(ci, 0, view.mi - 1)  # mi < m: slab-local i addressing
    cj = jnp.clip(cj, 0, m - 1)
    ck = jnp.clip(ck, 0, m - 1)
    ib, di = ci // bi, ci % bi
    jb, dj = cj // bj, cj % bj
    kb, dk = ck // bk, ck % bk
    F = ((ib * nbj + jb) * nbk + kb) * view.pitch + (di * bj + dj) * bk + dk
    # row width from the view itself: a FAT-row view (width BV, e.g. 512)
    # gathers straight from the brick grid's storage rows with ZERO
    # relayout — the (NB, BV) -> (-1, 128) reshape is logically
    # row-major-preserving but may be a physical copy; only the iota
    # lane-select widens. Which width is faster on the H100 is not
    # measured.
    row_w = view.rows.shape[1]
    row = F // row_w
    lane = F % row_w
    got = jnp.take(view.rows, row, axis=0, mode="clip")  # (..., 8, row_w)
    io = jnp.arange(row_w, dtype=jnp.int32)
    # where-select, NOT multiply-by-mask (NaN sentinels; see _corner_fetch_rows)
    return jnp.sum(jnp.where(io == lane[..., None], got, 0.0), axis=-1)


def masked_view(D: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """D with unobserved voxels (W <= 0) replaced by NaN.

    Folds the observation mask into the value array so per-query
    interpolation needs ONE gather instead of two — the per-corner mask is
    recovered as isfinite(corner). Rebuild after each fusion (one
    elementwise pass) — tracking runs many GN iterations against the same
    grid, so the W gather it removes from every iteration pays for it."""
    return jnp.where(W > 0, D, jnp.nan)


def trilinear_from_corners(
    d_raw: jnp.ndarray, inb: jnp.ndarray, f: jnp.ndarray, dtype=jnp.float32,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Masked trilinear value + gradient from PRE-GATHERED corner values.

    d_raw (..., 8) in _OFFSETS order with NaN = unobserved (masked_view
    encoding), inb (..., 8) bool bounds mask, f (..., 3) fractional
    position. Pure elementwise/reduction math.
    """
    mask = (inb & jnp.isfinite(d_raw)).astype(dtype)
    d = jnp.where(mask > 0, d_raw.astype(dtype), 0.0)

    off = jnp.asarray(_OFFSETS, dtype=dtype)
    fax = off * f[..., None, :] + (1.0 - off) * (1.0 - f[..., None, :])
    w = fax[..., 0] * fax[..., 1] * fax[..., 2]

    wm = w * mask
    Z = jnp.sum(wm, axis=-1)
    N = jnp.sum(wm * d, axis=-1)
    valid = Z > 1e-12
    safe_Z = jnp.where(valid, Z, 1.0)
    value = jnp.where(valid, N / safe_Z, 0.0)

    sign = 2.0 * off - 1.0
    prod_other = jnp.stack(
        [
            fax[..., 1] * fax[..., 2],
            fax[..., 0] * fax[..., 2],
            fax[..., 0] * fax[..., 1],
        ],
        axis=-1,
    )
    dw = sign * prod_other * mask[..., None]
    dN = jnp.sum(dw * d[..., None], axis=-2)
    dZ = jnp.sum(dw, axis=-2)
    grad = jnp.where(
        valid[..., None],
        (dN * safe_Z[..., None] - N[..., None] * dZ) / (safe_Z ** 2)[..., None],
        0.0,
    )
    return value, grad, valid


def trilinear_with_grad_nan(
    Dm: jnp.ndarray, coords: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """trilinear_with_grad against a masked_view array (single gather).

    Bit-equivalent to trilinear_with_grad(D, W, coords): the NaN corners are
    exactly the (W <= 0) corners, and out-of-bounds lanes are masked the
    same way. Returns (value, grad, valid).

    bfloat16 storage (FusionConfig.storage_dtype): corners are upcast right
    after the gather and ALL interpolation math runs in >= float32 — only
    the gathered bytes shrink; weights/gradients lose no precision."""
    dtype = jnp.promote_types(Dm.dtype, jnp.float32)
    base_f = jnp.floor(coords)
    base = base_f.astype(jnp.int32)
    f = (coords - base_f).astype(dtype)

    ci, cj, ck = _corner_indices(base)
    inb = _in_bounds(ci, cj, ck, Dm.shape)
    if isinstance(Dm, BrickMaskedView):
        d_raw = _corner_fetch_brick(Dm, base)
    else:
        d_raw = _corner_fetch(Dm, base)
    return trilinear_from_corners(d_raw, inb, f, dtype)


def shepard_l1(
    D: jnp.ndarray, W: jnp.ndarray, coords: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-exact Shepard inverse-L1 interpolation (sdf.cpp:127-163).

    Semantics reproduced exactly:
      * base corner = (int) cast = truncation toward zero (so coords in
        (-1, 0) probe the 0/1 corners, as the C++ does);
      * corner weight = 1 / L1-distance(corner, coords);
      * corners out of bounds or with W <= 0 contribute nothing;
      * a valid corner with L1 distance < 1e-5 returns its D exactly;
      * valid=False iff no valid corner (C++ then returns 0/0 = NaN; here
        value is 0 and callers must check the flag).

    Returns (value, valid).
    """
    dtype = jnp.promote_types(D.dtype, jnp.float32)  # full-precision math
    base = jnp.trunc(coords).astype(jnp.int32)

    ci, cj, ck = _corner_indices(base)
    inb = _in_bounds(ci, cj, ck, D.shape)
    d = _gather_corners(D, ci, cj, ck).astype(dtype)
    w_obs = _gather_corners(W, ci, cj, ck)
    valid_corner = inb & (w_obs > 0)

    corner_pos = base[..., None, :] + jnp.asarray(_OFFSETS)  # (..., 8, 3)
    vol = jnp.sum(jnp.abs(corner_pos.astype(dtype) - coords[..., None, :]), axis=-1)

    exact = valid_corner & (vol < 1e-5)
    any_exact = jnp.any(exact, axis=-1)
    # (at most one corner can be an exact hit; take it via masked max)
    exact_val = jnp.sum(jnp.where(exact, d, 0.0), axis=-1)

    safe_vol = jnp.where(vol < 1e-5, 1.0, vol)
    w = jnp.where(valid_corner & (vol >= 1e-5), 1.0 / safe_vol, 0.0)
    w_sum = jnp.sum(w, axis=-1)
    blended = jnp.sum(w * d, axis=-1) / jnp.where(w_sum > 0, w_sum, 1.0)

    valid = jnp.any(valid_corner, axis=-1)
    value = jnp.where(any_exact, exact_val, blended)
    return jnp.where(valid, value, 0.0), valid


def shepard_color(
    R: jnp.ndarray,
    G: jnp.ndarray,
    B: jnp.ndarray,
    Wc: jnp.ndarray,
    coords: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-exact color interpolation (SDF::interpolate_color,
    sdf.cpp:164-217): Shepard inverse-L1 weights over the 8 corners gated on
    Color_W > 0, exact-hit early return, output normalized by w_sum.

    The reference stores colors 0..255 and divides by 255 on output
    (sdf.cpp:213-216); this grid stores [0, 1], which scales linearly
    through the weighted mean, so the per-channel formula reduces to
    shepard_l1 with Wc as the gate. Returns (rgb (..., 3), valid)."""
    r, valid = shepard_l1(R, Wc, coords)
    g, _ = shepard_l1(G, Wc, coords)
    b, _ = shepard_l1(B, Wc, coords)
    return jnp.stack([r, g, b], axis=-1), valid


def interp_color(
    R: jnp.ndarray,
    G: jnp.ndarray,
    B: jnp.ndarray,
    Wc: jnp.ndarray,
    coords: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Trilinear color lookup, masked by the color weight Wc.

    The reference's interpolate_color (sdf.cpp:164-217) uses Shepard-L1
    weights gated on Color_W and divides by 255 (its colors are fused at
    0..255); here colors are already in [0, 1] and the default scheme is
    trilinear for smooth differentiable shading. Returns (rgb (..., 3), valid).
    """
    r, valid = trilinear(R, Wc, coords)
    g, _ = trilinear(G, Wc, coords)
    b, _ = trilinear(B, Wc, coords)
    return jnp.stack([r, g, b], axis=-1), valid
