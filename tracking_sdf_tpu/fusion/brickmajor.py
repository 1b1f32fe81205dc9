"""Brick-MAJOR TSDF fusion: compact-brick classification with a cheap merge.

The flat-layout bricked path (fusion.brick) faces a shape trade-off:
COMPACT bricks like (8, 8, 8) classify far better (the FREE proof fires,
~2.9M FULL voxels vs 4.95M for (1, 8, 128) at 256^3 — 1.7x fewer
pixel-row gathers) but the merge tail then writes k-runs of only bk
elements into the flat (m, m, m) grid: at bk = 8 that is ~365k 32-byte
scatter rows per frame instead of a few thousand fat ones.

This module removes the trade-off by changing the STORAGE layout: grid
leaves live as (NB, BV) brick-row tables (one brick = BV = bi*bj*bk
contiguous voxels = one fat row). The merge is then gather/merge/scatter of
~n_full fat 2-KB rows, independent of brick shape, so the
classification-optimal compact brick wins outright.

Consumers that need the flat (m, m, m) layout (raycasting, meshing —
contiguous k rows) get it from ONE relayout pass which doubles as the
masked_view build (W <= 0 -> NaN); tracking reads the brick rows directly
(brick_masked_view).
Color leaves stay brick-major and are only relayouted on demand (mesh
export / color rendering, ~1 Hz in the reference, sdf.cpp:317-391).

Semantics are identical to fusion.brick (same classifier, same per-voxel
update math — see that module's OUT/FREE proofs); parity is pinned by
tests/test_brick_fusion.py::test_brickmajor_matches_dense.
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
    _compact_ids,
    _full_brick_updates,
    _pixel_table,
    classify_bricks,
    classify_compact_hier,
    share_classify_margin,
)
from tracking_sdf_tpu.grid.grid import TSDFGrid
from tracking_sdf_tpu.grid.interp import BrickMaskedView


class BrickGrid(NamedTuple):
    """TSDF grid in brick-major layout.

    Brick b = (ib, jb, kb) row-major over (nbi, nbj, nbk); within a brick,
    voxels are (di, dj, dk) row-major over the brick shape. Equivalent to
    the dense (m, m, m) grid via a pure reshape/transpose (to_dense).

    STORAGE SHAPE: each leaf is (NB, BV) — one fat row per brick (see
    _row_w for the negative A/B on width-128 rows). The tracking view's
    (NB, BV) -> (-1, 128) reshape is row-major-preserving; whether XLA
    makes it a copy on the H100 is not measured.

    STORAGE INVARIANT: D holds NaN wherever W <= 0 (the masked-view
    encoding, grid/interp.masked_view) instead of the dense layout's "far"
    init value (sdf.cpp:28-34). Tracking's per-frame Dm relayout is then a
    pure transpose of D — no W read, no elementwise mask.
    dense_from_brick_grid restores the reference's far value, so
    every dense-visible behavior (parity tests, checkpoints, meshing) is
    unchanged.

    PACKED COLOR: the four color leaves (R, G, B, Wc) live in ONE
    uint16-lane leaf ``C`` of shape (NB, 3*LV + LW) — block layout
    [R | G | B | Wc] per row, each value bitcast to its uint16 lanes (LV =
    BV * itemsize(value)/2, LW likewise for the weight dtype). Motivation:
    one gather + one scatter of 4x-wide rows replaces four of each; it
    paid where row operations were bound by their count, not their bytes
    (not re-measured on the H100). Bitcasting (not dtype promotion) keeps
    every stored bit identical to the unpacked layout for ANY value/weight
    dtype combo, so
    fusion arithmetic is bitwise unchanged. D and W deliberately stay
    separate: D's standalone layout backs the zero-copy tracking view
    (brick_masked_view) and the Dm relayout — packing it would turn those
    free reshapes into real strided copies of the whole grid.

    ``C`` always stores lanes for the R/G/B/Wc blocks in that order; use
    color_lane_widths() + pack_color()/unpack_color() rather than slicing
    by hand."""

    D: jnp.ndarray
    W: jnp.ndarray
    C: jnp.ndarray  # (NB, 3*LV + LW) uint16 — packed [R | G | B | Wc]


def _row_w(bv: int) -> int:
    """Storage row width: one FAT row per brick (width BV).

    Width-128 storage rows (row_w = 128 when BV % 128 == 0, making the
    tracking view a zero-op wrap of D) multiply the row count of every
    merge op by BV/128 (4x at BV = 512); where merge cost follows the row
    count that loses far more than the view relayout saves, and it
    measured a large loss on the machine this was first tuned on. Not
    re-measured on the H100."""
    return bv


def _to_rows(leaf: jnp.ndarray, bs: Tuple[int, int, int]) -> jnp.ndarray:
    mi, mj, mk = leaf.shape
    bi, bj, bk = bs
    return (
        leaf.reshape(mi // bi, bi, mj // bj, bj, mk // bk, bk)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(-1, _row_w(bi * bj * bk))
    )


def _from_rows(rows: jnp.ndarray, shape, bs: Tuple[int, int, int]) -> jnp.ndarray:
    mi, mj, mk = shape
    bi, bj, bk = bs
    return (
        rows.reshape(mi // bi, mj // bj, mk // bk, bi, bj, bk)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(mi, mj, mk)
    )


def _lanes(x: jnp.ndarray) -> jnp.ndarray:
    """(..., w) 16/32-bit leaf -> (..., w*k) uint16 lane view (pure
    bitcast + free minor-dim reshape; k = itemsize/2)."""
    k = x.dtype.itemsize // 2
    u = jax.lax.bitcast_convert_type(x, jnp.uint16)
    if k == 1:
        return u
    return u.reshape(*x.shape[:-1], x.shape[-1] * k)


def _unlanes(u: jnp.ndarray, dtype, w: int) -> jnp.ndarray:
    """Inverse of _lanes: (..., w*k) uint16 -> (..., w) dtype."""
    k = jnp.dtype(dtype).itemsize // 2
    if k > 1:
        u = u.reshape(*u.shape[:-1], w, k)
    return jax.lax.bitcast_convert_type(u, dtype)


def color_lane_widths(bv: int, value_dtype, weight_dtype) -> Tuple[int, int]:
    """(LV, LW): uint16 lanes per R/G/B block and per Wc block."""
    lv = bv * (jnp.dtype(value_dtype).itemsize // 2)
    lw = bv * (jnp.dtype(weight_dtype).itemsize // 2)
    return lv, lw


def pack_color(R, G, B, Wc) -> jnp.ndarray:
    """Four color leaves -> one packed uint16-lane leaf [R | G | B | Wc]."""
    return jnp.concatenate(
        [_lanes(R), _lanes(G), _lanes(B), _lanes(Wc)], axis=-1)


def unpack_color(C: jnp.ndarray, value_dtype, weight_dtype, bv: int):
    """Packed leaf/rows -> (R, G, B, Wc) in their stored dtypes. The block
    slices are minor-dim contiguous, so unpack fuses into whatever
    consumes the channels (no materialized copies)."""
    lv, lw = color_lane_widths(bv, value_dtype, weight_dtype)
    R = _unlanes(C[..., 0 * lv:1 * lv], value_dtype, bv)
    G = _unlanes(C[..., 1 * lv:2 * lv], value_dtype, bv)
    B = _unlanes(C[..., 2 * lv:3 * lv], value_dtype, bv)
    Wc = _unlanes(C[..., 3 * lv:3 * lv + lw], weight_dtype, bv)
    return R, G, B, Wc


def unpack_color_grid(bgrid: BrickGrid):
    """(R, G, B, Wc) rows of a BrickGrid (dtypes self-described: D's dtype
    is the value dtype, W's the weight dtype; BV is D's row width)."""
    return unpack_color(bgrid.C, bgrid.D.dtype, bgrid.W.dtype,
                        bgrid.D.shape[-1])


def brick_grid_from_dense(grid: TSDFGrid, bs: Tuple[int, int, int],
                          value_dtype=None, weight_dtype=None) -> BrickGrid:
    """value_dtype (e.g. bfloat16) applies to D/R/G/B; weight_dtype (round
    4, FusionConfig.weight_dtype) to the W/Wc accumulators (default:
    unchanged)."""
    D = jnp.where(grid.W > 0, grid.D, jnp.nan)  # storage invariant
    vdt = value_dtype or grid.D.dtype
    wdt = weight_dtype or grid.W.dtype
    return BrickGrid(
        D=_to_rows(D, bs).astype(vdt),
        W=_to_rows(grid.W, bs).astype(wdt),
        C=pack_color(_to_rows(grid.R, bs).astype(vdt),
                     _to_rows(grid.G, bs).astype(vdt),
                     _to_rows(grid.B, bs).astype(vdt),
                     _to_rows(grid.Wc, bs).astype(wdt)))


def dense_from_brick_grid(
    bgrid: BrickGrid, params: GridParams, bs: Tuple[int, int, int]
) -> TSDFGrid:
    """Upcasts bf16 value/weight leaves to (at least) float32: the dense
    grid is the export/meshing/checkpoint surface."""
    m = params.m
    far = params.width + params.height + params.depth
    wdt = jnp.promote_types(bgrid.W.dtype, jnp.float32)
    D = jnp.where(bgrid.W > 0, bgrid.D.astype(wdt), jnp.asarray(far, wdt))
    R, G, B, Wc = unpack_color_grid(bgrid)
    return TSDFGrid(_from_rows(D, (m, m, m), bs),
                    *(_from_rows(l.astype(wdt), (m, m, m), bs)
                      for l in (bgrid.W, R, G, B, Wc)))


def empty_brick_grid(
    params: GridParams, bs: Tuple[int, int, int], dtype=jnp.float32,
    value_dtype=None, weight_dtype=None,
) -> BrickGrid:
    """Fresh grid (SDF::SDF init, sdf.cpp:28-34) already in brick layout.

    value_dtype (e.g. bfloat16, FusionConfig.storage_dtype) applies to the
    VALUE leaves D/R/G/B; weight_dtype (FusionConfig.weight_dtype) to the
    W/Wc accumulators — bf16 weights halve the merge's W traffic but
    quantize the running sum (pair with max_weight; see config)."""
    bi, bj, bk = bs
    m = params.m
    NB = (m // bi) * (m // bj) * (m // bk)
    BV = bi * bj * bk
    shp = (NB * BV // _row_w(BV), _row_w(BV))
    vdt = value_dtype or dtype
    wdt = weight_dtype or dtype
    return BrickGrid(
        D=jnp.full(shp, jnp.nan, dtype=vdt),  # storage invariant (W=0)
        W=jnp.zeros(shp, dtype=wdt),
        C=pack_color(jnp.full(shp, 0.4, dtype=vdt),
                     jnp.full(shp, 0.4, dtype=vdt),
                     jnp.full(shp, 0.4, dtype=vdt),
                     jnp.zeros(shp, dtype=wdt)),
    )


def masked_dense_D(
    bgrid: BrickGrid, params: GridParams, bs: Tuple[int, int, int]
) -> jnp.ndarray:
    """Flat (m, m, m) masked SDF view (W <= 0 -> NaN) for interpolation.

    Thanks to the storage invariant (D already NaN at W <= 0) this is a
    pure layout transpose — no W read, no mask pass."""
    m = params.m
    return _from_rows(bgrid.D, (m, m, m), bs)


def brick_masked_view(
    bgrid: BrickGrid, params: GridParams, bs: Tuple[int, int, int]
) -> BrickMaskedView:
    """Zero-copy masked SDF view in brick order (a reshape, no transpose).

    Tracking interpolates directly from this (interp._corner_fetch_brick),
    which removes the per-frame masked_dense_D relayout from the hot loop.
    The (-1, 128) reshape is row-major-preserving; a backend may still
    copy D for it when BV != 128 (see _row_w for why rows stay fat)."""
    if bgrid.D.shape[1] == 128:
        return BrickMaskedView(bgrid.D, params.m, bs)
    return BrickMaskedView(bgrid.D.reshape(-1, 128), params.m, bs)


@partial(
    jax.jit,
    static_argnames=("params", "cam", "cfg", "bs", "cap", "cap_free",
                     "emit_dm", "nbi_local"),
    donate_argnames=("bgrid",),
)
def fuse_frame_brickmajor(
    bgrid: BrickGrid,
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
    emit_dm=True,  # True: flat (m,m,m) | "view": zero-copy BrickMaskedView | False
    i_offset=0,
    nbi_local: Optional[int] = None,  # SPMD slab: local brick count along i
    sat: Optional[jnp.ndarray] = None,  # (NB,) bool saturated-FREE bitset
) -> Tuple[BrickGrid, Optional[jnp.ndarray], FuseStats]:
    """Fuse one frame into a brick-major grid.

    Returns (bgrid, Dm, stats) where Dm is the masked SDF for the NEXT
    frame's tracking/raycasting: the flat (m, m, m) relayout when
    emit_dm=True, a zero-copy BrickMaskedView when emit_dm="view" (the
    hot-loop configuration — tracking gathers corners brick-major, no
    relayout pass), or None. Donates bgrid: the merge scatter-sets rows in
    place in device memory.

    Geometry is exactly the dense path's math (same classifier + per-voxel
    updates as fuse_frame_bricked); color is fused in FULL (surface-band)
    bricks only — see fusion.brick docstring for why that loses nothing.

    SATURATED-FREE SKIP (``sat`` — FusionConfig.sat_skip): with a
    max_weight clamp, a FREE brick's update converges to a bitwise no-op
    once W saturates (measured: exactly at frame max_weight for
    from-empty bricks, no oscillation, f32 and bf16). ``sat`` is a persistent
    (NB,) bool carried by the caller; when given, the function returns
    ``(bgrid, Dm, stats, sat')`` and:
      * FREE-classified bricks with sat=True are EXCLUDED from compaction
        (their cap_free slot is reclaimed — the sole point: capacity, and
        with it a smaller compile-time cap_free).
      * sat is SET for a FREE brick exactly when this frame's merge landed
        bitwise-identical stored rows (D_new cast == D_old stored AND
        W likewise) — detected on values already in registers.
      * sat is CLEARED for every brick in the FULL update list (the only
        other path that mutates rows), keeping the invariant: sat=True =>
        the brick's stored rows equal those of its last proven-no-op FREE
        update => skipping its next FREE update is bitwise invisible.
    Exactness is pinned by tests/test_brick_fusion.py (skip-on == skip-off
    bitwise, flat + hier classify).

    bfloat16 STORAGE (FusionConfig.storage_dtype): when the VALUE leaves
    (D/R/G/B) are bf16 — weights stay float32: they are running
    accumulators, and bf16's 2^-8 relative quantum would freeze W once it
    grows past ~256x the per-frame increment — all math (pixel table,
    classification, per-voxel updates, merge) still runs in float32: old
    values upcast at the merge gather, new values round to bf16 only at
    the scatter-set. Storage quantization is ~0.4% of delta per
    running-average step (bf16 has 8 mantissa bits and |D| <= delta),
    while the merge moves 2/3 the bytes."""
    dtype = jnp.promote_types(bgrid.D.dtype, jnp.float32)  # compute dtype
    h, w_img = points_cam.shape[:2]
    m = params.m
    bi, bj, bk = bs
    if m % bj or m % bk or (nbi_local is None and m % bi):
        raise ValueError(f"grid m={m} not divisible by brick {bs}")
    # nbi_local (SPMD): this shard's bgrid holds only the slab of bricks
    # starting at global voxel i = i_offset (parallel.sharded); emit_dm
    # then refers to the slab extent, not the full grid
    nbi, nbj, nbk = (m // bi if nbi_local is None else nbi_local,
                     m // bj, m // bk)
    NB = nbi * nbj * nbk
    BV = bi * bj * bk
    if cap_free is None:
        cap_free = cap
    fuse_color = cfg.fuse_color and rgb is not None

    pix = _pixel_table(points_cam, normals_cam, rgb, fuse_color, dtype,
                       cfg.distance)
    # hierarchical classification (FusionConfig.hier_classify): super-brick
    # OUT/FREE/OCCLUDED pruning shrinks the fine classify + compaction
    # domain ~3-4x at 512^3 (conservative-exact — proofs in
    # classify_compact_hier). SPMD slabs run it too (round 4): the
    # super-brick proofs are slab-local — classify_compact_hier
    # parametrizes on (nbi, i_offset), both already threaded through —
    # requiring only that the slab's brick count divides the super factor.
    # cap_mixed stays the full-grid value per shard (conservative).
    hier = getattr(cfg, "hier_classify", 0)
    use_hier = (hier > 1 and nbi % hier == 0
                and nbj % hier == 0 and nbk % hier == 0)
    ovf_mixed = jnp.int32(0)
    share_m = share_classify_margin(params, cfg)
    if use_hier:
        full_ids, fr_ids, n_full, n_free, ovf_mixed, ovf_free = \
            classify_compact_hier(
                params, pose, points_cam, normals_cam, cam, bs, dtype,
                nbi, i_offset, cfg.distance, cap, cap_free, hier,
                cfg.cap_mixed, share_margin=share_m, sat=sat)
        upd, _, valid_brick, _, _ = _full_brick_updates(
            None, pix, pose, params, cam, cfg, bs, cap, dtype,
            (nbi, nbj, nbk), i_offset, (h, w_img), fuse_color,
            full_ids=full_ids, n_full=n_full)
    else:
        brick_class = classify_bricks(
            params, pose, points_cam, normals_cam, cam, bs, dtype, nbi,
            i_offset, cfg.distance, share_margin=share_m)
        upd, full_ids, valid_brick, n_full, _ = _full_brick_updates(
            brick_class, pix, pose, params, cam, cfg, bs, cap, dtype,
            (nbi, nbj, nbk), i_offset, (h, w_img), fuse_color)
    # channels stay unstacked: XLA fuses the per-voxel update math directly
    # into the merge elementwise ops below (no (cap, BV, C) U round-trip)
    row_w = _row_w(BV)
    R = BV // row_w  # storage rows per brick
    ch = [u.reshape(cap * R, row_w) for u in upd]

    # ---- FULL merge: n_full*R row gather/merge/scatter-set -----------------
    # Brick b occupies storage rows [b*R, (b+1)*R). Padded slots gather row 0
    # (harmless) and scatter to DISTINCT out-of-bounds rows (unique_indices
    # stays true; mode="drop" discards).
    def expand(rows_b):  # brick ids (n,) -> storage rows (n*R,)
        if R == 1:
            return rows_b
        return (rows_b[:, None] * R
                + jnp.arange(R, dtype=jnp.int32)[None, :]).reshape(-1)

    rows_g = expand(jnp.where(valid_brick, full_ids, 0))
    oob = NB * R + jnp.arange(cap * R, dtype=jnp.int32)
    rows_s = jnp.where(jnp.repeat(valid_brick, R), expand(full_ids), oob
                       ).astype(jnp.int32)

    def sset(tab, new):
        return tab.at[rows_s].set(new.astype(tab.dtype), mode="drop",
                                  unique_indices=True)

    # FREE ids (needed up front when folding them into the FULL pass)
    if not use_hier:
        is_free = brick_class.reshape(-1) == 1
        if sat is not None:  # saturated-FREE skip: proven-no-op bricks out
            is_free = is_free & ~sat
        n_free = jnp.sum(is_free.astype(jnp.int32))
        fr_ids = _compact_ids(is_free, cap_free, NB)
    valid_f = fr_ids < NB

    # free_fold (round 4): merge FREE rows in the SAME D/W
    # gather/merge/scatter pass as the FULL rows — a FREE brick's update
    # is exactly (w_add = 1, wd_add = delta) per voxel, the identical
    # running-mean arithmetic, and the FULL/FREE id sets are disjoint
    # (class 2 vs 1), so one combined pass is valid. Removes the second
    # D/W row-pass per frame AND its serialization on the FULL scatter.
    fold = getattr(cfg, "free_fold", False)
    w_add = ch[0]
    wd_add = ch[1]
    if fold:
        ones_f = jnp.ones((cap_free * R, row_w), dtype)
        w_add = jnp.concatenate([w_add, ones_f], axis=0)
        wd_add = jnp.concatenate(
            [wd_add, jnp.full_like(ones_f, params.delta)], axis=0)
        rows_fg0 = expand(jnp.where(valid_f, fr_ids, 0))
        rows_g = jnp.concatenate([rows_g, rows_fg0], axis=0)
        oob_all = NB * R + jnp.arange((cap + cap_free) * R, dtype=jnp.int32)
        valid_all = jnp.concatenate(
            [jnp.repeat(valid_brick, R), jnp.repeat(valid_f, R)])
        ids_all = jnp.concatenate([expand(full_ids), expand(fr_ids)])
        rows_s_dw = jnp.where(valid_all, ids_all, oob_all).astype(jnp.int32)
    else:
        rows_s_dw = rows_s

    def sset_dw(tab, new):
        return tab.at[rows_s_dw].set(new.astype(tab.dtype), mode="drop",
                                     unique_indices=True)

    Dold_raw = jnp.take(bgrid.D, rows_g, axis=0)  # (cap[+capf]*R, BV) stored
    Wold_raw = jnp.take(bgrid.W, rows_g, axis=0)
    Dold = Dold_raw.astype(dtype)
    Wold = Wold_raw.astype(dtype)
    # storage invariant: Dold is NaN where Wold <= 0 — sanitize before the
    # Wold * Dold product (0 * NaN = NaN), keep NaN where nothing fused
    Dold_s = jnp.where(Wold > 0, Dold, 0.0)
    # denominator = UNCAPPED sum; clamp only the stored weight (dividing
    # by the clamped weight diverges at saturation — see fusion/fuse.py)
    W_sum = Wold + w_add
    W_new = (W_sum if cfg.max_weight is None
             else jnp.minimum(W_sum, cfg.max_weight))
    has = w_add > 0
    D_new = jnp.where(
        has, (Wold * Dold_s + wd_add) / jnp.where(has, W_sum, 1.0), Dold)
    Db = sset_dw(bgrid.D, D_new)
    Wb = sset_dw(bgrid.W, W_new)
    free_noop = None
    if sat is not None and fold:
        # idempotence detection on the FREE segment (rows cap*R onward) of
        # the folded pass: compare the values ABOUT TO BE STORED (cast to
        # storage dtype) against the raw stored rows. NaN rows (W<=0,
        # storage invariant) compare unequal -> not yet saturated. All
        # operands are already in registers; this fuses into the merge.
        seg = slice(cap * R, None)
        noop_v = ((D_new[seg].astype(bgrid.D.dtype) == Dold_raw[seg])
                  & (W_new[seg].astype(bgrid.W.dtype) == Wold_raw[seg]))
        free_noop = jnp.all(noop_v.reshape(cap_free, BV), axis=1)
    if fold:
        # color still addresses FULL rows only — restore the FULL-row slices
        rows_g = rows_g[:cap * R]

    if fuse_color:
        # ONE gather + ONE scatter on the packed color leaf instead of
        # four of each: the row ops are per-row-cost-bound (round-5
        # row-width probe: 4x width costs ~1.2-1.7x, not 4x), so packing
        # is the bulk of the color merge's cost. unpack/pack are bitcasts
        # + minor-dim reshapes that fuse into the update arithmetic; the
        # per-channel math and the store-time dtype rounding are bitwise
        # identical to the historical four-leaf formulation.
        vdt_s, wdt_s = bgrid.D.dtype, bgrid.W.dtype
        Cold = jnp.take(bgrid.C, rows_g, axis=0)
        Rold_s, Gold_s, Bold_s, Wcold_s = unpack_color(
            Cold, vdt_s, wdt_s, row_w)
        Rold = Rold_s.astype(dtype)
        Gold = Gold_s.astype(dtype)
        Bold = Bold_s.astype(dtype)
        Wcold = Wcold_s.astype(dtype)
        wc_add = ch[2]
        Wc_sum = Wcold + wc_add
        Wc_new = (Wc_sum if cfg.max_weight is None
                  else jnp.minimum(Wc_sum, cfg.max_weight))
        has_c = wc_add > 0
        safe = jnp.where(has_c, Wc_sum, 1.0)
        R_new = jnp.where(has_c, (Wcold * Rold + ch[3]) / safe, Rold)
        G_new = jnp.where(has_c, (Wcold * Gold + ch[4]) / safe, Gold)
        B_new = jnp.where(has_c, (Wcold * Bold + ch[5]) / safe, Bold)
        C_new = pack_color(R_new.astype(vdt_s), G_new.astype(vdt_s),
                           B_new.astype(vdt_s), Wc_new.astype(wdt_s))
        Cb = bgrid.C.at[rows_s].set(C_new, mode="drop",
                                    unique_indices=True)
    else:
        Cb = bgrid.C

    # ---- FREE merge: w = 1, d = +delta, no pixel data ----------------------
    # (folded into the combined D/W pass above when cfg.free_fold)
    if not fold:
        rows_fg = expand(jnp.where(valid_f, fr_ids, 0))
        oob_f = NB * R + jnp.arange(cap_free * R, dtype=jnp.int32)
        rows_fs = jnp.where(jnp.repeat(valid_f, R), expand(fr_ids), oob_f
                            ).astype(jnp.int32)
        Dof_raw = jnp.take(Db, rows_fg, axis=0)
        Wof_raw = jnp.take(Wb, rows_fg, axis=0)
        Dof = Dof_raw.astype(dtype)
        Wof = Wof_raw.astype(dtype)
        Dof_s = jnp.where(Wof > 0, Dof, 0.0)  # storage invariant (FULL merge)
        W_sumf = Wof + 1.0
        W_nf = (W_sumf if cfg.max_weight is None
                else jnp.minimum(W_sumf, cfg.max_weight))
        D_nf = (Wof * Dof_s + jnp.asarray(params.delta, dtype)) / W_sumf
        if sat is not None:
            noop_v = ((D_nf.astype(Db.dtype) == Dof_raw)
                      & (W_nf.astype(Wb.dtype) == Wof_raw))
            free_noop = jnp.all(noop_v.reshape(cap_free, BV), axis=1)
        Db = Db.at[rows_fs].set(D_nf.astype(Db.dtype), mode="drop",
                                unique_indices=True)
        Wb = Wb.at[rows_fs].set(W_nf.astype(Wb.dtype), mode="drop",
                                unique_indices=True)

    out = BrickGrid(D=Db, W=Wb, C=Cb)
    stats = FuseStats(
        n_full=n_full,
        overflow=jnp.maximum(n_full - cap, 0),
        n_free=n_free,
        overflow_active=(ovf_free if use_hier
                         else jnp.maximum(n_free - cap_free, 0)),
        overflow_mixed=ovf_mixed,
    )
    if sat is not None:
        # clear every FULL-updated brick (its rows changed), then set FREE
        # bricks whose update just proved bitwise no-op; padded slots
        # scatter to index NB (out of bounds, dropped)
        sat_new = sat.at[jnp.where(valid_brick, full_ids, NB)].set(
            False, mode="drop")
        sat_new = sat_new.at[jnp.where(valid_f & free_noop, fr_ids, NB)].set(
            True, mode="drop")
        stats = stats._replace(n_sat=jnp.sum(sat_new.astype(jnp.int32)))
    if emit_dm == "view":
        if nbi_local is not None:
            raise ValueError("emit_dm='view' addresses the full grid; SPMD "
                             "slabs use emit_dm=True (local dense slab)")
        Dm = brick_masked_view(out, params, bs)  # zero-copy, no relayout
    elif emit_dm:
        if nbi_local is not None:
            # slab-extent relayout (the SPMD caller stitches/halos it)
            Dm = _from_rows(out.D, (nbi * bi, m, m), bs)
        else:
            Dm = masked_dense_D(out, params, bs)
    else:
        Dm = None
    if sat is not None:
        return out, Dm, stats, sat_new
    return out, Dm, stats
