"""PACKED brick-major TSDF fusion: one array, one gather, one scatter.

The brick-major path (fusion.brickmajor) stores six (NB, BV) leaves and
merges them with six row-gathers + six scatter-sets. A 256^3 stage split
showed XLA materializing the six update channels (~150 MB of device-memory
round trip) between the math and the six scatter consumers, because sharing
the gathered pixel rows and the weight chain across six scatter fusions
forces common-subexpression buffers.

This module removes that boundary by packing the grid into ONE
(NB, C=6, BV) array (channels [D, W, R, G, B, Wc]; each (brick, channel) is
a contiguous BV-row). The whole merge — FULL bricks and FREE bricks
together — is then:

    one row-gather   (N, nch, BV)  of the old values        (N = cap + cap_free)
    one elementwise update computation (single consumer -> XLA fuses the
        entire per-voxel math, pixel-gather reads included, into it)
    one scatter-set  back into the donated array in place.

Geometry-only frames (rgb=None) gather/scatter only the D, W channel rows
(nch = 2) through the (NB*C, BV) row view — packing costs them nothing.

Tracking stays zero-copy: D rows live at flat stride C*BV, so the
BrickMaskedView (grid/interp.py) addresses them directly via its ``pitch``
field — same 8 row-gathers per interpolation query as brick-major.

Semantics are identical to fusion.brickmajor (same classifier, same
per-voxel update math — OUT/FREE proofs in fusion/brick.py); parity pinned
by tests/test_brick_fusion.py::test_packed_matches_dense. Reference
semantics: SDF::update, sdf.cpp:224-315.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.fusion.brick import (
    FuseStats,
    _full_brick_updates,
    _pixel_table,
    classify_bricks,
    share_classify_margin,
)
from tracking_sdf_tpu.fusion.brickmajor import _from_rows, _to_rows
from tracking_sdf_tpu.grid.grid import TSDFGrid
from tracking_sdf_tpu.grid.interp import BrickMaskedView

_C = 6  # channels: D, W, R, G, B, Wc


class PackedGrid(NamedTuple):
    """TSDF grid as ONE (NB, 6, BV) array; channel order [D, W, R, G, B, Wc].

    Same storage invariant as brickmajor.BrickGrid: the D channel holds NaN
    wherever W <= 0, so the tracking view is a pure reshape (no mask pass)
    and dense_from_packed restores the reference's far init value."""

    data: jnp.ndarray


def packed_from_dense(grid: TSDFGrid, bs: Tuple[int, int, int]) -> PackedGrid:
    bv = bs[0] * bs[1] * bs[2]
    D = jnp.where(grid.W > 0, grid.D, jnp.nan)  # storage invariant
    # _to_rows yields width-128 storage rows; packed wants (NB, BV) bricks
    rows = [_to_rows(leaf, bs).reshape(-1, bv)
            for leaf in (D, grid.W, grid.R, grid.G, grid.B, grid.Wc)]
    return PackedGrid(jnp.stack(rows, axis=1))


def dense_from_packed(
    pgrid: PackedGrid, params: GridParams, bs: Tuple[int, int, int]
) -> TSDFGrid:
    m = params.m
    far = params.width + params.height + params.depth
    d = pgrid.data
    D = jnp.where(d[:, 1] > 0, d[:, 0], jnp.asarray(far, d.dtype))
    leaves = [D] + [d[:, c] for c in range(1, _C)]
    return TSDFGrid(*(_from_rows(l, (m, m, m), bs) for l in leaves))


def empty_packed_grid(
    params: GridParams, bs: Tuple[int, int, int], dtype=jnp.float32
) -> PackedGrid:
    """Fresh grid (SDF::SDF init, sdf.cpp:28-34) in packed layout."""
    bi, bj, bk = bs
    m = params.m
    NB = (m // bi) * (m // bj) * (m // bk)
    BV = bi * bj * bk
    init = jnp.asarray([jnp.nan, 0.0, 0.4, 0.4, 0.4, 0.0], dtype)
    return PackedGrid(jnp.broadcast_to(init[None, :, None],
                                       (NB, _C, BV)).copy())


def packed_masked_view(
    pgrid: PackedGrid, params: GridParams, bs: Tuple[int, int, int]
) -> BrickMaskedView:
    """Zero-copy masked SDF view over the packed array (D = channel 0).

    The view's pitch (C * BV flat elements between bricks' D rows) makes
    tracking's corner fetch address the interleaved layout directly."""
    bi, bj, bk = bs
    return BrickMaskedView(pgrid.data.reshape(-1, 128), params.m, bs,
                           pitch=_C * bi * bj * bk)


def masked_dense_D(
    pgrid: PackedGrid, params: GridParams, bs: Tuple[int, int, int]
) -> jnp.ndarray:
    """Flat (m, m, m) masked SDF (W <= 0 -> NaN): pure relayout of channel 0."""
    m = params.m
    return _from_rows(pgrid.data[:, 0], (m, m, m), bs)


@partial(
    jax.jit,
    static_argnames=("params", "cam", "cfg", "bs", "cap", "cap_free",
                     "emit_dm"),
    donate_argnames=("pgrid",),
)
def fuse_frame_packed(
    pgrid: PackedGrid,
    pose: Pose,
    points_cam: jnp.ndarray,  # (H, W, 3)
    normals_cam: jnp.ndarray,  # (H, W, 3)
    rgb: Optional[jnp.ndarray],  # (H, W, 3) in [0, 1] or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs: Tuple[int, int, int] = (8, 8, 8),
    cap: int = 6144,
    cap_free: Optional[int] = None,
    emit_dm="view",  # "view": zero-copy BrickMaskedView | True: flat | False
    i_offset=0,
) -> Tuple[PackedGrid, Optional[jnp.ndarray], FuseStats]:
    """Fuse one frame into a packed grid: one gather + one scatter total.

    Exactly fuse_frame_brickmajor's math (same classifier + per-voxel
    updates); FULL and FREE bricks merge in a single combined scatter —
    their row sets are disjoint by class, so unique_indices holds."""
    dtype = pgrid.data.dtype
    h, w_img = points_cam.shape[:2]
    m = params.m
    bi, bj, bk = bs
    if m % bi or m % bj or m % bk:
        raise ValueError(f"grid m={m} not divisible by brick {bs}")
    nbi, nbj, nbk = m // bi, m // bj, m // bk
    NB = nbi * nbj * nbk
    BV = bi * bj * bk
    if cap_free is None:
        cap_free = cap
    fuse_color = cfg.fuse_color and rgb is not None
    nch = _C if fuse_color else 2
    N = cap + cap_free

    pix = _pixel_table(points_cam, normals_cam, rgb, fuse_color, dtype,
                       cfg.distance)
    brick_class = classify_bricks(
        params, pose, points_cam, normals_cam, cam, bs, dtype, nbi,
        i_offset, cfg.distance,
        share_margin=share_classify_margin(params, cfg))
    upd, full_ids, valid_brick, n_full, _ = _full_brick_updates(
        brick_class, pix, pose, params, cam, cfg, bs, cap, dtype,
        (nbi, nbj, nbk), i_offset, (h, w_img), fuse_color)
    ch = [u.reshape(cap, BV) for u in upd]

    # ---- FREE bricks: w = 1, d = +delta, no pixel data ---------------------
    is_free = brick_class.reshape(-1) == 1
    n_free = jnp.sum(is_free.astype(jnp.int32))
    fr_ids = jnp.nonzero(is_free, size=cap_free, fill_value=NB)[0]
    valid_f = fr_ids < NB

    # ---- combined FULL+FREE merge: one gather, one scatter -----------------
    # Row view (NB*C, BV): channel c of brick b is contiguous row b*C + c.
    # Padded slots gather brick 0 (harmless) and scatter to DISTINCT
    # out-of-bounds rows (unique_indices stays true; mode="drop" discards).
    rows2 = pgrid.data.reshape(NB * _C, BV)
    bid = jnp.concatenate([full_ids, fr_ids]).astype(jnp.int32)  # (N,)
    valid = jnp.concatenate([valid_brick, valid_f])
    chans = jnp.arange(nch, dtype=jnp.int32)
    idx = jnp.where(valid, bid, 0)[:, None] * _C + chans[None, :]  # (N, nch)
    oob = NB * _C + jnp.arange(N * nch, dtype=jnp.int32).reshape(N, nch)
    idx_s = jnp.where(valid[:, None], idx, oob)

    old = jnp.take(rows2, idx, axis=0)  # (N, nch, BV)
    Dold, Wold = old[:, 0], old[:, 1]
    # storage invariant: Dold is NaN where Wold <= 0 — sanitize before the
    # Wold * Dold product (0 * NaN = NaN), keep NaN where nothing fused
    Dold_s = jnp.where(Wold > 0, Dold, 0.0)
    ones_f = jnp.ones((cap_free, BV), dtype)
    w_add = jnp.concatenate([ch[0], ones_f])
    wd_add = jnp.concatenate([ch[1], ones_f * jnp.asarray(params.delta, dtype)])
    # denominator = UNCAPPED sum; clamp only the stored weight (dividing
    # by the clamped weight diverges at saturation — see fusion/fuse.py)
    W_sum = Wold + w_add
    W_new = (W_sum if cfg.max_weight is None
             else jnp.minimum(W_sum, cfg.max_weight))
    has = w_add > 0
    D_new = jnp.where(
        has, (Wold * Dold_s + wd_add) / jnp.where(has, W_sum, 1.0), Dold)
    new = [D_new, W_new]

    if fuse_color:
        Rold, Gold, Bold, Wcold = old[:, 2], old[:, 3], old[:, 4], old[:, 5]
        zeros_f = jnp.zeros((cap_free, BV), dtype)
        wc_add = jnp.concatenate([ch[2], zeros_f])
        Wc_sum = Wcold + wc_add
        Wc_new = (Wc_sum if cfg.max_weight is None
                  else jnp.minimum(Wc_sum, cfg.max_weight))
        has_c = wc_add > 0
        safe = jnp.where(has_c, Wc_sum, 1.0)
        cadd = [jnp.concatenate([ch[c], zeros_f]) for c in (3, 4, 5)]
        new += [
            jnp.where(has_c, (Wcold * Rold + cadd[0]) / safe, Rold),
            jnp.where(has_c, (Wcold * Gold + cadd[1]) / safe, Gold),
            jnp.where(has_c, (Wcold * Bold + cadd[2]) / safe, Bold),
            Wc_new,
        ]

    rows2 = rows2.at[idx_s].set(
        jnp.stack(new, axis=1), mode="drop", unique_indices=True)
    out = PackedGrid(rows2.reshape(NB, _C, BV))

    stats = FuseStats(
        n_full=n_full,
        overflow=jnp.maximum(n_full - cap, 0),
        n_free=n_free,
        overflow_active=jnp.maximum(n_free - cap_free, 0),
    )
    if emit_dm == "view":
        Dm = packed_masked_view(out, params, bs)  # zero-copy
    elif emit_dm:
        Dm = masked_dense_D(out, params, bs)
    else:
        Dm = None
    return out, Dm, stats
