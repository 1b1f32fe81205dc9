"""Brick-compacted TSDF fusion — the fast path.

The dense path (fuse.fuse_frame) gathers a pixel row for EVERY voxel (16.7M
random gathers per 256^3 frame). This path reduces gathered rows by
~10-30x with EXACT per-brick classification:

  OUT   brick entirely behind the camera or off-image -> every voxel skipped
        (exactly the dense path's per-voxel skip rules: pz is affine in the
        voxel index, and the projection of a box with all corners in front
        is the convex hull of the corner projections, so corner bounds are
        exact). Also folds in OCCLUDED bricks — provably deep behind every
        candidate surface (d < -delta at every voxel, the eta max-mip bound
        in _zeta_mip) or over invalid pixels, where the dense path's
        d >= -delta mask rejects everything: zero update, zero cost.
  FREE  brick entirely inside the image and strictly in front of every
        candidate surface: max brick z < zeta_min over its pixel bbox, where
        per pixel  zeta = z_y - delta / (-r.n)  is the camera-z at which the
        point-to-plane distance falls to delta (r = the pixel's unit-z ray;
        invalid/NaN pixels get zeta = -inf). Then EVERY voxel's update is
        exactly (w = 1, d = +delta) — the same numbers the dense path
        computes — applied with zero gathers. zeta is queried conservatively
        through a min-mip pyramid (4 cell lookups at a level where the
        brick's pixel bbox spans <= 2x2 cells).
  FULL  everything else (surface band, image/frustum edges, NaN regions):
        compacted per-voxel processing with the exact dense math. Updates
        are expressed as (w, w*d) partial sums and SCATTER-ADDED into dense
        accumulators — the running weighted mean never needs to gather old
        D/W — then one fused elementwise merge applies FREE and FULL
        updates together.

Color is fused only inside FULL (surface-band) bricks: free-space voxels'
colors are unobservable garbage in the reference anyway (sdf.cpp:294-304
fuses the color of whatever pixel is BEHIND the free voxel); renders only
read colors at the surface. Set FusionConfig(mode="dense") for bit-exact
reference-everywhere color parity.

Sizing: `cap` bounds the number of FULL bricks processed per frame (static
shape); overflowing bricks are dropped for that frame and reported in
FuseStats.overflow — size `cap` to the surface area of the scene.
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import Pose
from tracking_sdf_tpu.fusion.fuse import weighting
from tracking_sdf_tpu.grid.grid import TSDFGrid

# float32 contractions stay float32 on every backend (a GPU may otherwise
# run them in TF32): the classification bounds below must be exact.
_HI = jax.lax.Precision.HIGHEST

_TILE = 8  # zeta mip base tile, pixels


class FuseStats(NamedTuple):
    n_full: jnp.ndarray  # () int32 — bricks classified FULL
    overflow: jnp.ndarray  # () int32 — FULL bricks dropped (cap too small)
    n_free: jnp.ndarray  # () int32
    # merge='rows' and brickmajor: FREE bricks dropped (cap_free too
    # small) — capacity overflow in the merge tail, reported never silent.
    overflow_active: jnp.ndarray = jnp.int32(0)
    # hierarchical classification (FusionConfig.hier_classify): mixed
    # super-bricks beyond cap_mixed — their child bricks are DROPPED for
    # the frame (same reported-never-silent contract as `overflow`)
    overflow_mixed: jnp.ndarray = jnp.int32(0)
    # saturated-FREE skip (FusionConfig.sat_skip): bricks currently marked
    # saturated (their FREE update is a proven bitwise no-op; excluded from
    # FREE compaction). 0 when the skip is off.
    n_sat: jnp.ndarray = jnp.int32(0)


def _mip_levels(img, h, w, dtype, largest: bool):
    """Min- (largest=False) or max- (largest=True) mip pyramid over _TILE
    tiles. Returns the per-level 2-D arrays. Padding uses the reduction's
    neutral element; pad + wrap cells only ever ADD candidates, so queries
    stay conservative (a min can only drop, a max can only rise — both
    degrade FREE/OCCLUDED candidates to FULL, never the reverse)."""
    neutral = jnp.asarray(-jnp.inf if largest else jnp.inf, dtype)
    red = (lambda a, axis: a.max(axis=axis)) if largest \
        else (lambda a, axis: a.min(axis=axis))
    H = -(-h // _TILE) * _TILE
    W = -(-w // _TILE) * _TILE
    img = jnp.pad(img, ((0, H - h), (0, W - w)), constant_values=neutral)
    lvl = red(img.reshape(H // _TILE, _TILE, W // _TILE, _TILE), (1, 3))
    levels = [lvl]
    while lvl.shape[0] > 1 or lvl.shape[1] > 1:
        ph = lvl.shape[0] % 2
        pw = lvl.shape[1] % 2
        lvl = jnp.pad(lvl, ((0, ph), (0, pw)), constant_values=neutral)
        lvl = red(lvl.reshape(lvl.shape[0] // 2, 2, lvl.shape[1] // 2, 2),
                  (1, 3))
        levels.append(lvl)
    return levels, neutral


def _flatten_pair(levels, neutral):
    """(flat, flat_down): each level flattened row-major, plus the ROW-BELOW
    companion (cell (v+1, u) of the same level; last row pads neutral).
    Pairing lets one gathered table row answer TWO window rows."""
    downs = [jnp.concatenate(
        [l[1:], jnp.full((1, l.shape[1]), neutral, l.dtype)], axis=0)
        for l in levels]
    return (jnp.concatenate([l.reshape(-1) for l in levels]),
            jnp.concatenate([d.reshape(-1) for d in downs]))


def _overlap8(flat, neutral):
    """Overlapped stride-4 width-8 row table: row r = flat[4r : 4r+8], so
    any 4-contiguous cell run lives in ONE gathered row (start lane =
    f0 % 4 <= 3, end <= 6). Wrap cells only ADD candidates — conservative."""
    npad = (-flat.shape[0]) % 4
    fp = jnp.pad(flat, (0, npad), constant_values=neutral).reshape(-1, 4)
    return jnp.concatenate([fp, jnp.roll(fp, -1, axis=0)], axis=1)


def _compact_vals(flags, vals, cap, fill):
    """Stable compaction: the values of the first ``cap`` set flags, in
    order, padded with ``fill`` — exactly ``jnp.nonzero(flags, size=cap,
    fill_value=fill)[0]`` semantics when ``vals = arange`` (including the
    keep-FIRST-cap behavior on overflow), without the full-length sort.

    XLA lowers nonzero(size) through a full-length sort; this is a
    two-level cumsum (segment counts + within-segment ranks — both highly
    parallel) plus one scalar scatter. The scatter is the remaining cost,
    which is why hierarchical classification — shrinking N itself —
    compounds. Not re-measured against nonzero on the H100."""
    n = flags.shape[0]
    seg = 128 if n % 128 == 0 else (64 if n % 64 == 0 else 1)
    f2 = flags.reshape(-1, seg).astype(jnp.int32)
    within = jnp.cumsum(f2, axis=1) - 1
    cnt = f2.sum(1)
    base = jnp.cumsum(cnt) - cnt  # exclusive segment offsets
    pos = base[:, None] + within
    # overflow positions (pos >= cap) go to the drop slot `cap`, preserving
    # nonzero's first-cap-survive semantics
    tgt = jnp.where((f2 > 0) & (pos < cap), pos, cap)
    buf = jnp.full((cap + 1,), fill, vals.dtype)
    return buf.at[tgt.reshape(-1)].set(
        vals.reshape(-1), mode="drop")[:cap]


def _compact_ids(flags, cap, fill):
    """First-``cap`` indices of set flags (sorted), ``fill``-padded."""
    return _compact_vals(
        flags, jnp.arange(flags.shape[0], dtype=jnp.int32), cap, fill)


def share_classify_margin(params: GridParams, cfg: FusionConfig) -> float:
    """World-space distance margin making the FREE/OCCLUDED proofs exact
    under pixel-share semantics (FusionConfig.share_safe_classify).

    With share, a group voxel v fuses against the group CENTER c's pixel:
    its point-to-plane distance differs from the center voxel's distance
    against that same pixel by (v - c)·n, so widening delta by the
    group's world radius x ||n|| — (share/2) voxels along grid k (world
    z) x (share_j/2) along grid j (world y) — restores the share-1 proof
    chain exactly.

    POINT-TO-POINT needs NO margin (round-4 self-review): d = z_y(center
    pixel) - pz(voxel) uses the voxel's OWN pz, and the center pixel lies
    inside the brick's mip query window (hull property), so the existing
    pz bounds against zeta = z_y - delta / eta = z_y + delta already
    cover every group member exactly. Returns 0.0 there, and when share
    is 1 or the flag is off (bounds unchanged)."""
    if not getattr(cfg, "share_safe_classify", False):
        return 0.0
    if cfg.distance == "point_to_point":
        return 0.0
    sk = max(cfg.pixel_share, 1)
    sj = max(getattr(cfg, "pixel_share_j", 1), 1)
    if sk <= 1 and sj <= 1:
        return 0.0
    vs = params.voxel_size
    dk = 0.5 * sk * vs[2]
    dj = 0.5 * sj * vs[1]
    return float((dk * dk + dj * dj) ** 0.5)


def _zeta_mip(points_cam, normals_cam, cam, delta, dtype,
              distance="point_to_plane", share_margin=0.0):
    """Conservative free-space AND occluded-space depth mips.

    zeta (min-mip): the camera-z at which the pixel's fusion distance falls
    to +delta — a voxel strictly closer than zeta over its whole pixel bbox
    is provably far-free-space (update exactly (w = 1, d = +delta)).

    eta (max-mip): the camera-z beyond which the distance is provably below
    -delta — a voxel strictly beyond eta over its bbox is provably OCCLUDED
    (the dense path's d >= -delta mask rejects every voxel: ZERO update).
    Invalid pixels get eta = -inf (they also produce zero update), so an
    occluded brick may cover NaN regions — unlike FREE, which requires
    valid pixels.

    Derivation (point-to-plane): with unit-z ray r, a = -(r.n) and the
    voxel's own ray r'' = r + (du/fx, dv/fy, 0), du,dv in [0,1):
        d = a (z_y - z_p) + z_p e,   e in [-e_minus, +e_plus]
    so d <= a z_y - z_p (a - e_plus) < -delta  <=>
        z_p > (a z_y + delta) / (a - e_plus) = eta    (when a > e_plus;
    else eta = +inf — no occlusion guarantee). Point-to-point: d = z_y -
    z_p exactly, so eta = z_y + delta.

    Returns (t32 (rows, 32): [zeta | zeta-row-below | eta | eta-row-below],
    offsets, dims) — one gathered row serves both queries for two window
    rows, so the 4x4 bbox window costs 2 gathers per brick.
    """
    h, w = points_cam.shape[:2]
    z_y = points_cam[..., 2]
    n = normals_cam
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    pos_inf = jnp.asarray(jnp.inf, dtype)
    # validity matches the dense path's per-voxel gate (NaN point OR normal
    # skips, reference sdf.cpp:260) in BOTH distance modes
    fin = (
        jnp.isfinite(points_cam[..., 0])
        & jnp.isfinite(points_cam[..., 1])
        & jnp.isfinite(n[..., 0])
        & jnp.isfinite(n[..., 1])
        & jnp.isfinite(n[..., 2])
    )
    # share_safe_classify: delta widened by the share-group world radius
    # (x ||n|| for point-to-plane below) — see share_classify_margin
    if distance == "point_to_point":
        # d = z_y - z_p (sdf.h:169-172, canonical sign): no ray or normal
        # dependence at all, so the proofs are plain per-pixel bounds.
        d_eff = delta + share_margin
        zeta = jnp.where(fin, z_y - d_eff, neg_inf)
        eta = jnp.where(fin, z_y + d_eff, neg_inf)
    else:
        # unit-z ray r = ((u-cx)/fx, (v-cy)/fy, 1)
        v = jnp.arange(h, dtype=dtype)[:, None]
        u = jnp.arange(w, dtype=dtype)[None, :]
        rx = (u - cam.cx) / cam.fx
        ry = (v - cam.cy) / cam.fy
        rn = rx * n[..., 0] + ry * n[..., 1] + n[..., 2]
        # normal toward camera required; else no free-space guarantee
        ok = fin & (rn < 0)
        a = jnp.maximum(-rn, 1e-6)
        e_minus = (
            jnp.maximum(-n[..., 0], 0.0) / cam.fx
            + jnp.maximum(-n[..., 1], 0.0) / cam.fy
        )
        e_plus = (
            jnp.maximum(n[..., 0], 0.0) / cam.fx
            + jnp.maximum(n[..., 1], 0.0) / cam.fy
        )
        if share_margin:
            nrm2 = jnp.sqrt(jnp.sum(
                jnp.where(fin[..., None], n * n, 0.0), axis=-1))
            d_eff = delta + share_margin * nrm2
        else:
            d_eff = delta
        zeta = jnp.where(ok, (z_y * a - d_eff) / (a + e_minus), neg_inf)
        eta = jnp.where(
            fin & (rn < 0) & (a > e_plus),
            (z_y * a + d_eff) / jnp.maximum(a - e_plus, 1e-9),
            jnp.where(fin, pos_inf, neg_inf),
        )

    zl, zneut = _mip_levels(zeta, h, w, dtype, largest=False)
    el, eneut = _mip_levels(eta, h, w, dtype, largest=True)
    dims = [l.shape for l in zl]
    offsets = np.concatenate([[0], np.cumsum([dh * dw for dh, dw in dims])])
    zf, zfd = _flatten_pair(zl, zneut)
    ef, efd = _flatten_pair(el, eneut)
    # 32-lane table: [zeta | zeta-row-below | eta | eta-row-below] — one
    # gathered row answers BOTH queries for TWO window rows, so the 4x4
    # window costs 2 gathers per brick (was 4; originally 16 scalar)
    t32 = jnp.concatenate([_overlap8(zf, zneut), _overlap8(zfd, zneut),
                           _overlap8(ef, eneut), _overlap8(efd, eneut)],
                          axis=1)
    return t32, offsets[:-1], dims


def _query_zeta(t32, offsets, dims, u0, u1, v0, v1):
    """Conservative (min of zeta, max of eta) over pixel bbox
    [u0,u1]x[v0,v1] (inclusive), from the paired 32-lane table
    ([zeta | zeta-row-below | eta | eta-row-below]) in TWO row gathers
    per brick.

    Uses a 4x4 cell window at the level where 3 cells cover the bbox span —
    over-coverage <= ~1.7x per axis (a 2x2 window at the next-coarser level
    would over-cover up to 4x and misclassify many genuinely-free bricks).

    Each window row (4 contiguous cells) is ONE width-8 overlapped-row
    gather + lane-window min (4 rows/brick vs 16 scalar gathers; measured
    ~4 ns vs ~8 ns per gathered row). Window starts clamp to [0, dim-4]:
    when that widens the window past the original clipped cells (bbox at the
    image edge, or levels smaller than 4 cells where the run crosses into a
    neighboring image row / level / the +inf pad), the extra cells can only
    LOWER the min — a FREE brick may conservatively degrade to FULL (exact
    either way), never the reverse."""
    dtype = t32.dtype
    span = jnp.maximum(u1 - u0, v1 - v0) / (3.0 * _TILE)
    lvl = jnp.ceil(jnp.log2(jnp.maximum(span, 1.0))).astype(jnp.int32)
    lvl = jnp.clip(lvl, 0, len(dims) - 1)
    offs = jnp.asarray(offsets, jnp.int32)[lvl]
    dh = jnp.asarray([d[0] for d in dims], jnp.int32)[lvl]
    dw = jnp.asarray([d[1] for d in dims], jnp.int32)[lvl]
    cell = (_TILE * (2 ** lvl)).astype(dtype)
    cu0 = jnp.clip((u0 / cell).astype(jnp.int32), 0, jnp.maximum(dw - 4, 0))
    cv0 = jnp.clip((v0 / cell).astype(jnp.int32), 0, jnp.maximum(dh - 4, 0))
    # two gathered rows cover the 4 window rows: each table row carries the
    # cell run AND its row-below companion. Row-index clamping may re-read
    # rows, which only ADDS candidates (conservative); coverage: pair 1
    # covers rows {cv0, cv0+1}, pair 2 {min(cv0+2, dh-1), +1} — their union
    # contains every valid bbox row <= min(cv0+3, dh-1).
    f0s = []
    for dv in (0, 2):
        cv = jnp.minimum(cv0 + dv, dh - 1)
        f0s.append((offs + cv * dw + cu0).reshape(-1))
    f0 = jnp.stack(f0s, axis=0)  # (2, NB) — 2D-shaped take = fast path
    r0 = f0 // 4
    got = jnp.take(t32, jnp.minimum(r0, t32.shape[0] - 1), axis=0)  # (2, NB, 32)
    lane0 = (f0 - r0 * 4)[..., None]
    io = jnp.arange(32, dtype=jnp.int32)
    seg = io // 8  # 0: zeta, 1: zeta-down, 2: eta, 3: eta-down
    ioseg = io % 8
    inlane = (ioseg >= lane0) & (ioseg < lane0 + 4)
    zeta_min = jnp.min(
        jnp.where(inlane & (seg <= 1), got, jnp.asarray(jnp.inf, dtype)),
        axis=(0, -1))
    eta_max = jnp.max(
        jnp.where(inlane & (seg >= 2), got, jnp.asarray(-jnp.inf, dtype)),
        axis=(0, -1))
    return zeta_min.reshape(u0.shape), eta_max.reshape(u0.shape)


def _brick_corners_cam(params, pose, bs, dtype, nbi, i_offset):
    """Camera coords of every brick's 8 voxel-CENTER-hull corners.

    Returns (px, py, pz) each (nbi, NBj, NBk, 8). Voxel centers of brick b
    span [b*B + 0.5, b*B + B - 0.5] in continuous voxel units; pz is affine
    in the voxel index so corner extrema bound the interior exactly, and
    with all corners in front the (u, v) hull bound is exact too.

    p = Rt (c - t) is SEPARABLE per world axis, so the 8 corners are sums of
    three per-axis contribution tables (nb, 2, 3) — one fused broadcast-add
    kernel instead of an 8-iteration Python loop of channelwise matvecs.

    ``nbi``/``i_offset`` support SLAB grids (SPMD): the local slab's bricks
    start at global voxel i = i_offset (may be traced).
    """
    bi, bj, bk = bs
    m = params.m
    Rt = pose.R.T

    def axis_lohi(nb, b, extent, origin, off=0):
        idx = jnp.arange(nb, dtype=dtype) * b + jnp.asarray(off, dtype)
        lo = (extent / m) * (idx + 0.5) + origin
        hi = (extent / m) * (idx + b - 0.5) + origin
        return jnp.stack([lo, hi], axis=-1)  # (nb, 2)

    xs = axis_lohi(nbi, bi, params.width, params.origin[0], i_offset)
    ys = axis_lohi(m // bj, bj, params.height, params.origin[1])
    zs = axis_lohi(m // bk, bk, params.depth, params.origin[2])
    Ax = xs[..., None] * Rt[:, 0]  # (nbi, 2, 3)
    Ay = ys[..., None] * Rt[:, 1]
    Az = zs[..., None] * Rt[:, 2]
    base = -jnp.matmul(Rt, pose.t[:, None], precision=_HI)[:, 0]  # (3,)
    sel = np.array([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)])
    cx = Ax[:, sel[:, 0], :]  # (nbi, 8, 3)
    cy = Ay[:, sel[:, 1], :]
    cz = Az[:, sel[:, 2], :]
    c = (cx[:, None, None] + cy[None, :, None] + cz[None, None, :]) + base
    return c[..., 0], c[..., 1], c[..., 2]


def classify_compact_hier(params, pose, points_cam, normals_cam, cam, bs,
                          dtype, nbi, i_offset, distance, cap, cap_free,
                          factor, cap_mixed, share_margin=0.0, sat=None):
    """Hierarchical OUT/FREE/FULL classification + FULL/FREE compaction.

    Classifies SUPER-bricks of ``factor``^3 fine bricks first, then
    descends only into MIXED (class-FULL) super-bricks: fine-brick proofs
    + id compaction run over ``cap_mixed * factor^3`` slots instead of all
    NB bricks (3.4x fewer at 512^3, where ~73% of super-bricks are provably
    OUT/OCCLUDED on the bench trajectory).

    EXACTNESS (same conservative-exact contract as classify_bricks):
      * super OUT: pz is affine in the voxel index and the corner hull
        bounds the interior, so every child corner lies within the super's
        corner extrema -> each child satisfies the same OUT proof.
      * super OCCLUDED: eta_max over the super's (conservative) window
        >= eta over every pixel of every child's true bbox, and child
        pz_min >= super pz_min > eta_max -> every child voxel provably
        zero-update.
      * super FREE: zeta_min over the super window <= zeta at every pixel
        of the super bbox (superset of each child bbox) and child pz_max
        <= super pz_max < zeta_min -> every child is FREE (exact w = 1,
        d = +delta update), emitted WITHOUT descent.
      * MIXED supers descend to the exact same per-fine-brick proofs as
        classify_bricks (shared zeta/eta mip, identical corner math).
    Capacity: mixed supers beyond ``cap_mixed`` are dropped and REPORTED
    (overflow_mixed), as are FREE bricks beyond ``cap_free`` — the
    reported-never-silent contract of the flat path.

    Returns (full_ids (cap,), fr_ids (cap_free,), n_full (), n_free (),
    overflow_mixed (), overflow_free ()). ids are global brick ids padded
    with NB; full_ids order is (mixed-super rank, child) — consumers only
    require uniqueness + NB padding, not global sortedness.

    ``sat`` (optional, (NB,) bool): saturated-FREE skip mask
    (FusionConfig.sat_skip). A True brick's FREE update is a proven bitwise
    no-op (see fuse_frame_brickmajor), so it is EXCLUDED from the FREE
    candidate set before compaction — freeing cap_free capacity — at three
    levels: fine-FREE bricks in mixed supers, whole FREE supers whose
    children are ALL saturated (skipped pre-compaction, reclaiming their
    cap_sfree slot), and saturated children of partially-saturated kept
    supers (masked in the append; their slot positions become inert holes —
    acceptable: partial saturation is a transition state). n_free /
    overflow_free then count only non-skipped candidates (the counts for
    DROPPED supers keep the historical all-children overcount — overflow
    stays conservative, never silent).
    """
    h, w_img = points_cam.shape[:2]
    bi, bj, bk = bs
    m = params.m
    nbj, nbk = m // bj, m // bk
    NB = nbi * nbj * nbk
    f = factor
    vol = f * f * f
    nsi, nsj, nsk = nbi // f, nbj // f, nbk // f
    NS = nsi * nsj * nsk
    mip = _zeta_mip(points_cam, normals_cam, cam, params.delta, dtype,
                    distance, share_margin)

    # ---- level 1: super-bricks ---------------------------------------------
    sbs = (bi * f, bj * f, bk * f)
    scls = classify_bricks(params, pose, points_cam, normals_cam, cam, sbs,
                           dtype, nsi, i_offset, distance, mip=mip
                           ).reshape(-1)
    n_mixed = jnp.sum((scls == 2).astype(jnp.int32))
    mixed_ids = _compact_ids(scls == 2, cap_mixed, NS)
    valid_s = mixed_ids < NS
    ms = jnp.where(valid_s, mixed_ids, 0)
    si, sj, sk = ms // (nsj * nsk), (ms // nsk) % nsj, ms % nsk

    # ---- level 2: fine bricks within mixed supers (gathered corners) -------
    # per-axis corner contribution tables at FINE granularity (tiny: nb x 2
    # x 3 each), gathered per descent slot — same separable construction as
    # _brick_corners_cam
    Rt = pose.R.T

    def axis_tab(nb, b, extent, origin, col, off=0):
        idx = jnp.arange(nb, dtype=dtype) * b + jnp.asarray(off, dtype)
        lo = (extent / m) * (idx + 0.5) + origin
        hi = (extent / m) * (idx + b - 0.5) + origin
        return jnp.stack([lo, hi], axis=-1)[..., None] * Rt[:, col]

    Ax = axis_tab(nbi, bi, params.width, params.origin[0], 0, i_offset)
    Ay = axis_tab(nbj, bj, params.height, params.origin[1], 1)
    Az = axis_tab(nbk, bk, params.depth, params.origin[2], 2)
    base = -jnp.matmul(Rt, pose.t[:, None], precision=_HI)[:, 0]
    la = jnp.arange(f, dtype=jnp.int32)
    fi = si[:, None] * f + la  # (S, f) fine indices per axis
    fj = sj[:, None] * f + la
    fk = sk[:, None] * f + la
    sel = np.array([[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)])
    Axg = jnp.take(Ax, fi, axis=0)[:, :, sel[:, 0], :]  # (S, f, 8, 3)
    Ayg = jnp.take(Ay, fj, axis=0)[:, :, sel[:, 1], :]
    Azg = jnp.take(Az, fk, axis=0)[:, :, sel[:, 2], :]
    c = (Axg[:, :, None, None] + Ayg[:, None, :, None]
         + Azg[:, None, None, :]) + base  # (S, f, f, f, 8, 3)
    fcls = _class_from_corners(c[..., 0], c[..., 1], c[..., 2], mip, cam,
                               (h, w_img))
    fcls = jnp.where(valid_s[:, None, None, None], fcls, 0)
    # global fine-brick ids per descent slot
    gid = (fi[:, :, None, None] * (nbj * nbk)
           + fj[:, None, :, None] * nbk
           + fk[:, None, None, :])  # (S, f, f, f)
    gid = jnp.where(valid_s[:, None, None, None], gid, NB)
    fflat = fcls.reshape(-1)
    gflat = gid.reshape(-1)

    n_full = jnp.sum((fflat == 2).astype(jnp.int32))
    full_ids = _compact_vals(fflat == 2, gflat, cap, NB)

    # ---- FREE ids: fine-FREE within mixed supers + children of FREE supers -
    free_fine = fflat == 1
    if sat is not None:
        satg = jnp.take(sat, jnp.minimum(gflat, NB - 1))
        free_fine = free_fine & ~satg  # fflat==1 implies gflat < NB
    n_free_mixed = jnp.sum(free_fine.astype(jnp.int32))
    fr_ids = _compact_vals(free_fine, gflat, cap_free, NB)
    cap_sfree = max(cap_free // vol, 1)
    free_super = scls == 1
    if sat is not None:
        # a FREE super whose children are ALL saturated is skipped before
        # compaction (its cap_sfree slot is reclaimed, not holed)
        sat_super = jnp.all(
            sat.reshape(nsi, f, nsj, f, nsk, f).transpose(0, 2, 4, 1, 3, 5)
            .reshape(NS, vol), axis=1)
        free_super = free_super & ~sat_super
    n_sf = jnp.sum(free_super.astype(jnp.int32))
    sf_ids = _compact_ids(free_super, cap_sfree, NS)
    valid_sf = sf_ids < NS
    sfs = jnp.where(valid_sf, sf_ids, 0)
    sfi = (sfs // (nsj * nsk))[:, None] * f + la
    sfj = ((sfs // nsk) % nsj)[:, None] * f + la
    sfk = (sfs % nsk)[:, None] * f + la
    sf_gid = (sfi[:, :, None, None] * (nbj * nbk)
              + sfj[:, None, :, None] * nbk
              + sfk[:, None, None, :]).reshape(cap_sfree, vol)
    sf_gid = jnp.where(valid_sf[:, None], sf_gid, NB)
    # append after the compacted mixed-free prefix (contiguous positions)
    pos = n_free_mixed + jnp.arange(cap_sfree * vol, dtype=jnp.int32)
    keep = valid_sf[:, None].repeat(vol, 1).reshape(-1) & (pos < cap_free)
    n_sat_child = jnp.int32(0)
    if sat is not None:
        # saturated children of kept (partially saturated) supers: masked
        # out of the append — their positions become inert NB-padded holes
        sat_child = jnp.take(
            sat, jnp.minimum(sf_gid.reshape(-1), NB - 1)
        ) & valid_sf[:, None].repeat(vol, 1).reshape(-1)
        keep = keep & ~sat_child
        n_sat_child = jnp.sum(sat_child.astype(jnp.int32))
    fr_ids = fr_ids.at[jnp.where(keep, pos, cap_free)].set(
        sf_gid.reshape(-1), mode="drop")
    n_sf_kept = jnp.minimum(n_sf, cap_sfree)
    n_free = n_free_mixed + vol * n_sf - n_sat_child
    overflow_free = (
        jnp.maximum(n_free_mixed + vol * n_sf_kept - cap_free, 0)
        + vol * jnp.maximum(n_sf - cap_sfree, 0))
    overflow_mixed = jnp.maximum(n_mixed - cap_mixed, 0)
    return full_ids, fr_ids, n_full, n_free, overflow_mixed, overflow_free


def _class_from_corners(cx_, cy_, cz_, mip, cam, hw):
    """OUT/FREE/FULL class from per-brick corner camera coords (..., 8).

    The proof core of classify_bricks, factored out so hierarchical
    classification can run it on GATHERED fine-brick corners (arbitrary
    batch shape) with a shared zeta/eta mip. Proof comments live here;
    classify_bricks retains the public contract."""
    h, w_img = hw
    zflat, zoffs, zdims = mip
    pz_min = cz_.min(-1)
    pz_max = cz_.max(-1)
    all_front = pz_min > 0
    safe_z = jnp.where(cz_ > 0, cz_, 1.0)
    u_c = (cam.fx * cx_ + cam.cx * cz_) / safe_z
    v_c = (cam.fy * cy_ + cam.cy * cz_) / safe_z
    u0, u1 = u_c.min(-1), u_c.max(-1)
    v0, v1 = v_c.min(-1), v_c.max(-1)
    # fully inside the image (after per-voxel trunc): hull bound is exact
    # only when all corners are in front
    inside = all_front & (u0 >= 0) & (u1 < w_img) & (v0 >= 0) & (v1 < h)
    # entirely out: behind camera, or hull misses the image (hull bound on
    # (u, v) is valid only when all corners are in front — otherwise keep).
    # Left/top bound is <= -1, NOT < 0: the per-voxel path truncates toward
    # zero (C-cast parity, fuse.py:159), so u in (-1, 0) maps to pixel 0
    # and is VALID — an OUT test at u1 < 0 would skip a one-pixel band the
    # dense path fuses. Right/bottom stays >= w/h (u >= w truncates to
    # iu >= w, invalid).
    out = (pz_max <= 0) | (
        all_front & ((u1 <= -1) | (u0 >= w_img) | (v1 <= -1) | (v0 >= h))
    )
    # One fused query answers BOTH proofs from one row gather. The bbox is
    # clamped to the image: for FREE candidates (`inside` required) the
    # clamp is a no-op; for OCCLUDED, in-image voxels project inside the
    # clamped bbox (hull property) and off-image voxels are zero-update
    # regardless. Window widening/padding only degrades FREE/OCCLUDED to
    # FULL, never the reverse.
    zeta_min, eta_max = _query_zeta(
        zflat, zoffs, zdims,
        jnp.clip(u0, 0, w_img - 1), jnp.clip(u1, 0, w_img - 1),
        jnp.clip(v0, 0, h - 1), jnp.clip(v1, 0, h - 1))
    free = inside & (pz_max < zeta_min)
    # OCCLUDED: every voxel provably produces zero update (deep behind
    # every candidate surface, d < -delta, or over invalid pixels). Unlike
    # FREE this does NOT require the brick inside the image — only
    # all_front, for the exact hull bbox.
    occluded = all_front & (pz_min > eta_max)
    return jnp.where(out | occluded, 0,
                     jnp.where(free, 1, 2)).astype(jnp.int32)


def classify_bricks(params, pose, points_cam, normals_cam, cam, bs, dtype,
                    nbi, i_offset, distance="point_to_plane", mip=None,
                    share_margin=0.0):
    """Exact conservative OUT/FREE/FULL brick classification.

    Returns brick_class (nbi, nbj, nbk) int32: 0 = OUT, 1 = FREE, 2 = FULL.
    Shared by the flat-layout (fuse_frame_bricked) and brick-major
    (fusion.brickmajor) paths; proofs in the module docstring.

    SHARE-MODE CAVEAT: the FREE/OCCLUDED ray-footprint bounds
    (e_minus/e_plus in _zeta_mip) assume each voxel reads its OWN pixel
    (du, dv in [0,1)). With pixel_share > 1 a FULL-brick voxel fuses
    against the group-center pixel up to share/2 voxels away, so the
    proofs are strictly exact only at share 1 — consistent with share
    mode itself being a flagged approximation (FusionConfig.pixel_share);
    FREE/OCCLUDED treatment remains EXACT w.r.t. the share-1 semantics
    the equivalence tests pin. ``share_margin``
    (FusionConfig.share_safe_classify -> share_classify_margin) closes the
    gap exactly: widening delta by the group's world radius x ||n||
    bounds the share-induced distance shift (v-c)·n, restoring the proof
    chain under share semantics (pinned by
    tests/test_brick_fusion.py::test_share_safe_classification). The FREE
    (zeta min-mip) and OCCLUDED (eta max-mip) proofs depend on the distance
    mode; plain OUT is geometry-only. OCCLUDED bricks — provably zero
    update at every voxel (deep behind every candidate surface, d < -delta,
    or over invalid pixels) — fold into class 0: at 512^3 they were 39-40%
    of all FULL bricks (the shadow volume behind surfaces plus NaN
    shadows), each paying full gather+math+merge cost for nothing.
    """
    h, w_img = points_cam.shape[:2]
    if mip is None:
        mip = _zeta_mip(points_cam, normals_cam, cam, params.delta, dtype,
                        distance, share_margin)
    cx_, cy_, cz_ = _brick_corners_cam(params, pose, bs, dtype, nbi, i_offset)
    return _class_from_corners(cx_, cy_, cz_, mip, cam, (h, w_img))


def _pixel_table(points_cam, normals_cam, rgb, fuse_color, dtype,
                 distance="point_to_plane"):
    """(H*W, C) gather table: [nx, ny, nz, s (, cos, cos*r, cos*g, cos*b)].

    Channel 3 (``s``) is the distance mode's per-pixel scalar: y·n for
    point-to-plane (d = -(s - p·n)), the observed depth z_y for
    point-to-point (d = s - p_z directly).

    C is 4 (geometry) or 8 (color): power-of-two rows keep every gathered
    row inside aligned 32-byte units (9-float rows measured 2-5x slower
    per row on the machine this was first tuned on; not measured on the
    H100). Hence:
      * no `finite` flag channel — an invalid pixel (NaN point/normal,
        reference sdf.cpp:260) is encoded with the sign that drives the
        canonical distance to -inf (+inf for point-to-plane's negated s,
        -inf for point-to-point's direct s) so the d >= -delta fuse mask
        goes False (exactly the flag's effect);
      * cos is premultiplied into rgb (w_c·r = w·(cos·r)), saving a
        channel at one extra f32 rounding vs the dense path (<=1 ulp).
    """
    h, w_img = points_cam.shape[:2]
    n_img, y_img = normals_cam, points_cam
    finite = (
        jnp.isfinite(y_img[..., 0]) & jnp.isfinite(y_img[..., 1])
        & jnp.isfinite(n_img[..., 0]) & jnp.isfinite(n_img[..., 1])
        & jnp.isfinite(n_img[..., 2])
    )
    if distance == "point_to_point":
        s_img = jnp.where(finite, y_img[..., 2], -jnp.inf)
    else:
        s_img = jnp.where(
            finite,
            jnp.sum(jnp.where(finite[..., None], y_img * n_img, 0.0), axis=-1),
            jnp.inf,
        )
    channels = [
        jnp.where(finite, n_img[..., 0], 0.0),
        jnp.where(finite, n_img[..., 1], 0.0),
        jnp.where(finite, n_img[..., 2], 0.0),
        s_img,
    ]
    if fuse_color:
        norm_n = jnp.sqrt(jnp.sum(jnp.where(finite[..., None], n_img * n_img, 0.0), -1))
        cos_img = jnp.where(norm_n > 0,
                            jnp.abs(jnp.where(finite, n_img[..., 2], 0.0))
                            / jnp.where(norm_n > 0, norm_n, 1.0), 0.0)
        channels += [cos_img, cos_img * rgb[..., 0], cos_img * rgb[..., 1],
                     cos_img * rgb[..., 2]]
    return jnp.stack(channels, axis=-1).reshape(h * w_img, -1).astype(dtype)


def _full_brick_updates(brick_class, pix, pose, params, cam, cfg, bs, cap,
                        dtype, nb3, i_offset, hw, fuse_color,
                        full_ids=None, n_full=None):
    """Compact the FULL bricks and compute their (w, w*d, ...) update sums.

    The heart of brick-compacted fusion: ONE random pixel-row gather per
    FULL-brick voxel + exact dense per-voxel math. Returns
        (upd [C arrays, each (cap, bi, bj, bk)], full_ids (cap,),
         valid_brick (cap,), n_full (),
         (vi (cap, bi), vj (cap, bj), fbk (cap,)))
    with padded slots masked invalid (their upd rows are all-zero). The
    channels stay UNSTACKED so a consumer that merges them elementwise
    (brickmajor) lets XLA fuse the update math straight into the merge — a
    stacked (cap, BV, C) U is a ~75 MB device-memory round trip at cap
    6144."""
    bi, bj, bk = bs
    nbi, nbj, nbk = nb3
    h, w_img = hw
    m = params.m
    NB = nbi * nbj * nbk

    if full_ids is None:
        is_full = brick_class.reshape(-1) == 2
        n_full = jnp.sum(is_full.astype(jnp.int32))
        full_ids = _compact_ids(is_full, cap, NB)  # sorted
    valid_brick = full_ids < NB
    fb = jnp.where(valid_brick, full_ids, 0)
    fbi = fb // (nbj * nbk)
    fbj = (fb // nbk) % nbj
    fbk = fb % nbk

    # voxel coords of compacted bricks
    di = jnp.arange(bi, dtype=jnp.int32)
    dj = jnp.arange(bj, dtype=jnp.int32)
    dk = jnp.arange(bk, dtype=jnp.int32)
    vi = (fbi[:, None] * bi + di[None, :])  # (cap, bi)
    vj = (fbj[:, None] * bj + dj[None, :])  # (cap, bj)
    vk = (fbk[:, None] * bk + dk[None, :])  # (cap, bk)
    # broadcast to (cap, bi, bj, bk)
    I = vi[:, :, None, None]
    J = vj[:, None, :, None]
    K = vk[:, None, None, :]

    ox, oy, oz = params.origin
    X = (params.width / m) * (I.astype(dtype) + jnp.asarray(i_offset, dtype) + 0.5) + ox
    Y = (params.height / m) * (J.astype(dtype) + 0.5) + oy
    Z = (params.depth / m) * (K.astype(dtype) + 0.5) + oz
    Rt = pose.R.T
    t = pose.t
    dx, dy, dz = X - t[0], Y - t[1], Z - t[2]
    px = Rt[0, 0] * dx + Rt[0, 1] * dy + Rt[0, 2] * dz
    py = Rt[1, 0] * dx + Rt[1, 1] * dy + Rt[1, 2] * dz
    pz = Rt[2, 0] * dx + Rt[2, 1] * dy + Rt[2, 2] * dz

    in_front = pz > 0
    safe_pz = jnp.where(in_front, pz, 1.0)
    u = (cam.fx * px + cam.cx * pz) / safe_pz
    v = (cam.fy * py + cam.cy * pz) / safe_pz
    iu = jnp.trunc(u).astype(jnp.int32)
    iv = jnp.trunc(v).astype(jnp.int32)
    ins = (iu >= 0) & (iu < w_img) & (iv >= 0) & (iv < h)
    flat_pix = jnp.clip(iv, 0, h - 1) * w_img + jnp.clip(iu, 0, w_img - 1)

    # Gather with a 128-wide index minor dim regardless of brick shape: the
    # layout was chosen for another backend's gather lowering (bk=8-wide
    # indices ran 3x slower there); its effect on the H100 is not measured.
    sk = getattr(cfg, "pixel_share", 1)
    sj = getattr(cfg, "pixel_share_j", 1)
    if bk % sk:
        sk = 1
    if bj % sj:
        sj = 1
    if sk > 1 or sj > 1:
        # approximate fast mode (see FusionConfig.pixel_share): groups of
        # `sk` adjacent k-voxels (x `sj` adjacent j-voxels) read the
        # group-CENTER voxel's pixel row; the per-row-bound gather shrinks
        # by the same factor. Per-voxel projection, masks, and distance
        # math below stay per-voxel.
        # NOTE (negative A/B): temporal share
        # DITHERING — cycling the representative voxel through the group
        # positions across frames so the running mean averages the bias
        # out — was implemented and measured WORSE on the 120-frame
        # dataset oracle (512^3: 16.3 -> 17.1 mm at share 8x4, 10.3 ->
        # 13.7 mm at 4x4). The tracker reads the grid every frame, so the
        # larger per-frame bias of non-center positions (up to the full
        # group radius vs the center's half) hurts more than the long-run
        # averaging helps. Removed; the group CENTER is the right pick.
        fp = flat_pix.reshape(cap, bi, bj // sj, sj, bk // sk, sk)
        fp = fp[:, :, :, sj // 2, :, sk // 2]  # (cap, bi, bj/sj, bk/sk)
        nrow = cap * bi * (bj // sj) * (bk // sk)
        lane = 128 if nrow % 128 == 0 else bk // sk
        g = jnp.take(pix, fp.reshape(nrow // lane, lane), axis=0)
        # Broadcast the shared pixel rows up to per-voxel shape HERE.
        # Keeping g factored (share dims size-1, broadcasting inside the
        # arithmetic) avoids a ~100 MB (256^3) to ~640 MB (512^3) broadcast
        # materialize, but XLA may schedule the explicit broadcast better;
        # which wins on the H100 is not measured.
        # FusionConfig.factored_share is the A/B switch (numerically inert —
        # cross-checked bit-for-bit on CPU); the TSDF_FACTORED_SHARE env var
        # remains as a process-START probe knob only (trace-time read: NOT
        # in the jit cache key, unlike the cfg field).
        if (getattr(cfg, "factored_share", False)
                or os.environ.get("TSDF_FACTORED_SHARE") == "1"):
            g = g.reshape(cap, bi, bj // sj, 1, bk // sk, 1, -1)
            gs = (cap, bi, bj // sj, sj, bk // sk, sk)
            px, py, pz = (a.reshape(gs) for a in (px, py, pz))
            in_front = in_front.reshape(gs)
            ins = ins.reshape(gs)
            shaped = gs
        else:
            g = g.reshape(cap, bi, bj // sj, 1, bk // sk, 1, -1)
            g = jnp.broadcast_to(
                g, (cap, bi, bj // sj, sj, bk // sk, sk, g.shape[-1])
            ).reshape(cap, bi, bj, bk, -1)
            shaped = None
    else:
        nvox = cap * bi * bj * bk
        lane = 128 if nvox % 128 == 0 else bk
        g = jnp.take(
            pix, flat_pix.reshape(nvox // lane, lane), axis=0
        ).reshape(cap, bi, bj, bk, -1)
        shaped = None
    nx, ny, nz, s = g[..., 0], g[..., 1], g[..., 2], g[..., 3]

    if cfg.distance == "point_to_plane":
        d_ref = s - (px * nx + py * ny + pz * nz)  # (y - p)·n (sdf.cpp:272)
        d = -d_ref  # canonical +free-space; invalid pixels (s = +inf) -> -inf
    elif cfg.distance == "point_to_point":
        # s holds z_y; canonical d = z_y - p_z (sdf.h:169-172 negated);
        # invalid pixels (s = -inf) -> -inf, masked below
        d = s - pz
    else:
        raise ValueError(f"unknown distance: {cfg.distance}")

    vb = (valid_brick[:, None, None, None, None, None] if shaped
          else valid_brick[:, None, None, None])
    observe = in_front & ins & vb
    fuse_mask = observe & (d >= -params.delta)
    # sanitize BEFORE multiplying: 0 * (-inf) from an invalid pixel is NaN
    d = jnp.where(fuse_mask, jnp.minimum(d, params.delta), 0.0)
    w_new = jnp.where(
        fuse_mask, weighting(cfg.weighting, d, params.epsilon, params.delta), 0.0
    )

    upd = [w_new, w_new * d]
    if fuse_color:
        cosv, cosr, cosg, cosb = g[..., 4], g[..., 5], g[..., 6], g[..., 7]
        upd += [w_new * cosv, w_new * cosr, w_new * cosg, w_new * cosb]
    if shaped:
        # factored mode: math ran in the 6-D share structure with size-1
        # broadcast dims; restore the canonical per-voxel shape
        upd = [jnp.broadcast_to(
            u, (cap, bi, bj // sj, sj, bk // sk, sk)
        ).reshape(cap, bi, bj, bk) for u in upd]
    return upd, full_ids, valid_brick, n_full, (vi, vj, fbk)


@partial(
    jax.jit,
    static_argnames=("params", "cam", "cfg", "bs", "cap", "merge",
                     "cap_free"),
    donate_argnames=("grid",),
)
def fuse_frame_bricked(
    grid: TSDFGrid,
    pose: Pose,
    points_cam: jnp.ndarray,  # (H, W, 3)
    normals_cam: jnp.ndarray,  # (H, W, 3)
    rgb: Optional[jnp.ndarray],  # (H, W, 3) in [0,1] or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs: Tuple[int, int, int] = (8, 8, 32),
    cap: int = 1024,
    merge: str = "xla",
    cap_free: Optional[int] = None,
    i_offset=0,  # global voxel-i of grid.D[0] — traced OK (SPMD slabs)
) -> Tuple[TSDFGrid, FuseStats]:
    """Brick-compacted fusion; exact dense semantics for geometry, color in
    surface-band bricks only. Returns (grid, FuseStats).

    ``merge`` selects the tail:
      * "xla": scatter-add (w, w*d, ...) into dense accumulators + one
        full-grid merge pass. Robust; cost has a full-grid floor (~1.2 GB of
        device-memory traffic at 256^3 with color).
      * "rows": gather the touched grid rows, merge in-register, scatter-SET
        back (in-place on the donated buffers) — same numbers, traffic
        proportional to active bricks only. FREE bricks get a second
        row-pass bounded by ``cap_free`` (default = cap; overflow reported
        in FuseStats.overflow_active)."""
    dtype = grid.D.dtype
    h, w_img = points_cam.shape[:2]
    m = params.m
    mi = grid.D.shape[0]  # slab extent along i (== m unless sharded)
    bi, bj, bk = bs
    if mi % bi or m % bj or m % bk:
        raise ValueError(f"grid slab {grid.D.shape} not divisible by brick {bs}")
    nbi, nbj, nbk = mi // bi, m // bj, m // bk
    fuse_color = cfg.fuse_color and rgb is not None

    pix = _pixel_table(points_cam, normals_cam, rgb, fuse_color, dtype,
                       cfg.distance)

    # ---- brick classification: 0 = OUT, 1 = FREE, 2 = FULL -----------------
    brick_class = classify_bricks(
        params, pose, points_cam, normals_cam, cam, bs, dtype, nbi,
        i_offset, cfg.distance,
        share_margin=share_classify_margin(params, cfg))

    upd, full_ids, valid_brick, n_full, (vi, vj, fbk) = _full_brick_updates(
        brick_class, pix, pose, params, cam, cfg, bs, cap, dtype,
        (nbi, nbj, nbk), i_offset, (h, w_img), fuse_color)
    U = jnp.stack(upd, axis=-1)  # (cap, bi, bj, bk, C)
    C = U.shape[-1]

    stats = FuseStats(
        n_full=n_full,
        overflow=jnp.maximum(n_full - cap, 0),
        n_free=jnp.sum((brick_class == 1).astype(jnp.int32)),
    )

    if merge == "rows":
        return _merge_rows(
            grid, U, brick_class, vi, vj, fbk, valid_brick, params, cfg,
            bs, cap, cap_free, fuse_color, mi, m, nbj, nbk, stats)

    # ---- scatter-add into dense run-row accumulators -----------------------
    # dense flat index ordered (i, j, k); k-runs of bk are contiguous rows.
    # Padded/dropped bricks get DISTINCT out-of-bounds rows so the
    # unique_indices promise stays true; mode="drop" discards them.
    NR = mi * m * m // bk
    run_row = (vi[:, :, None] * m + vj[:, None, :]) * (m // bk) + fbk[:, None, None]
    oob = NR + jnp.arange(cap * bi * bj, dtype=jnp.int32).reshape(cap, bi, bj)
    run_row = jnp.where(valid_brick[:, None, None], run_row, oob)
    acc = jnp.zeros((NR, bk, C), dtype)
    acc = acc.at[run_row.reshape(-1)].add(
        U.reshape(cap * bi * bj, bk, C),
        indices_are_sorted=False, unique_indices=True, mode="drop",
    )

    # ---- fused dense merge -------------------------------------------------
    # All elementwise merge math runs on FLAT (mi, m, m) arrays so the minor
    # (lane) dim is m, not bk: with compact bricks (bk=8) the 6-D
    # (nbi,bi,nbj,bj,nbk,bk) view gives every vectorized op a minor dim of
    # 8 over ~1.2 GB of full-grid traffic.
    # The per-voxel class is materialized by broadcast+reshape (free: the
    # reshape is contiguous) instead of keeping the 6-D view alive.
    cls_vox = jnp.broadcast_to(
        brick_class[:, None, :, None, :, None], (nbi, bi, nbj, bj, nbk, bk)
    ).reshape(mi, m, m)
    accf = acc.reshape(mi, m, m, C)

    is_free = cls_vox == 1
    is_fullc = cls_vox == 2
    w_add = jnp.where(is_free, 1.0, jnp.where(is_fullc, accf[..., 0], 0.0))
    wd_add = jnp.where(is_free, params.delta,
                       jnp.where(is_fullc, accf[..., 1], 0.0))
    # denominator = UNCAPPED sum; clamp only the stored weight (dividing
    # by the clamped weight diverges at saturation — see fusion/fuse.py)
    W_sum = grid.W + w_add
    W_out = (W_sum if cfg.max_weight is None
             else jnp.minimum(W_sum, cfg.max_weight))
    has = w_add > 0
    D_out = jnp.where(
        has, (grid.W * grid.D + wd_add) / jnp.where(has, W_sum, 1.0), grid.D
    )

    if fuse_color:
        wc_add = jnp.where(is_fullc, accf[..., 2], 0.0)
        Wc_sum = grid.Wc + wc_add
        Wc_out = (Wc_sum if cfg.max_weight is None
                  else jnp.minimum(Wc_sum, cfg.max_weight))
        has_c = wc_add > 0
        safe = jnp.where(has_c, Wc_sum, 1.0)
        R_out = jnp.where(has_c, (grid.Wc * grid.R + accf[..., 3]) / safe, grid.R)
        G_out = jnp.where(has_c, (grid.Wc * grid.G + accf[..., 4]) / safe, grid.G)
        B_out = jnp.where(has_c, (grid.Wc * grid.B + accf[..., 5]) / safe, grid.B)
    else:
        R_out, G_out, B_out, Wc_out = grid.R, grid.G, grid.B, grid.Wc

    return (
        TSDFGrid(D=D_out, W=W_out, R=R_out, G=G_out, B=B_out, Wc=Wc_out),
        stats,
    )


def _merge_rows(grid, U, brick_class, vi, vj, fbk, valid_brick, params, cfg,
                bs, cap, cap_free, fuse_color, mi, m, nbj, nbk, stats):
    """Row-granular merge tail: gather touched grid rows, merge, scatter-SET.

    Each brick's voxels are bi*bj contiguous k-runs of bk elements in the
    (i, j, k) row-major grid, so rows are fat (bk floats) and FULL/FREE
    bricks touch disjoint row sets (runs align to brick boundaries). All
    traffic is proportional to cap + cap_free rows; there is no accumulator
    and no full-grid pass — at 512^3 the "xla" tail's dense passes would be
    8x the 256^3 cost while this tail's cost is unchanged for the same
    surface area. Scatter-sets alias the donated grid buffers in place."""
    bi, bj, bk = bs
    NR = mi * m * m // bk
    NB = brick_class.size
    if cap_free is None:
        cap_free = cap
    dtype = grid.D.dtype

    def leaf_rows(leaf):
        return leaf.reshape(NR, bk)

    def gather(tab2, rows2):  # rows2 (n, bi*bj) int32, clamped valid
        return jnp.take(tab2, rows2, axis=0)  # (n, bi*bj, bk)

    def scatter_set(tab2, rows_s, new_rows):
        return tab2.at[rows_s.reshape(-1)].set(
            new_rows.reshape(-1, bk), mode="drop", unique_indices=True)

    # ---- FULL bricks -------------------------------------------------------
    run_row = (vi[:, :, None] * m + vj[:, None, :]) * (m // bk) + fbk[:, None, None]
    rows = run_row.reshape(cap, bi * bj)
    rows_g = jnp.where(valid_brick[:, None], rows, 0)
    # distinct out-of-bounds rows for padded bricks keep unique_indices true
    oob = NR + jnp.arange(cap * bi * bj, dtype=jnp.int32).reshape(cap, bi * bj)
    rows_s = jnp.where(valid_brick[:, None], rows, oob)

    Ur = U.reshape(cap, bi * bj, bk, -1)
    Dt, Wt = leaf_rows(grid.D), leaf_rows(grid.W)
    Dold = gather(Dt, rows_g)
    Wold = gather(Wt, rows_g)
    w_add = Ur[..., 0]
    W_sum = Wold + w_add
    W_new = (W_sum if cfg.max_weight is None
             else jnp.minimum(W_sum, cfg.max_weight))
    has = w_add > 0
    D_new = jnp.where(has, (Wold * Dold + Ur[..., 1]) / jnp.where(has, W_sum, 1.0),
                      Dold)
    Dt = scatter_set(Dt, rows_s, D_new)
    Wt = scatter_set(Wt, rows_s, W_new)

    if fuse_color:
        Rt, Gt, Bt, Wct = (leaf_rows(l) for l in (grid.R, grid.G, grid.B, grid.Wc))
        Rold, Gold, Bold, Wcold = (gather(t, rows_g) for t in (Rt, Gt, Bt, Wct))
        wc_add = Ur[..., 2]
        Wc_sum = Wcold + wc_add
        Wc_new = (Wc_sum if cfg.max_weight is None
                  else jnp.minimum(Wc_sum, cfg.max_weight))
        has_c = wc_add > 0
        safe = jnp.where(has_c, Wc_sum, 1.0)
        R_new = jnp.where(has_c, (Wcold * Rold + Ur[..., 3]) / safe, Rold)
        G_new = jnp.where(has_c, (Wcold * Gold + Ur[..., 4]) / safe, Gold)
        B_new = jnp.where(has_c, (Wcold * Bold + Ur[..., 5]) / safe, Bold)
        Rt = scatter_set(Rt, rows_s, R_new)
        Gt = scatter_set(Gt, rows_s, G_new)
        Bt = scatter_set(Bt, rows_s, B_new)
        Wct = scatter_set(Wct, rows_s, Wc_new)
    # ---- FREE bricks: w = 1, d = +delta, no pixel data needed --------------
    is_free_f = brick_class.reshape(-1) == 1
    fr_ids = jnp.nonzero(is_free_f, size=cap_free, fill_value=NB)[0]
    valid_f = fr_ids < NB
    fb = jnp.where(valid_f, fr_ids, 0)
    fbi_f = fb // (nbj * nbk)
    fbj_f = (fb // nbk) % nbj
    fbk_f = fb % nbk
    di = jnp.arange(bi, dtype=jnp.int32)
    dj = jnp.arange(bj, dtype=jnp.int32)
    vi_f = fbi_f[:, None] * bi + di[None, :]
    vj_f = fbj_f[:, None] * bj + dj[None, :]
    run_f = (vi_f[:, :, None] * m + vj_f[:, None, :]) * (m // bk) + fbk_f[:, None, None]
    rows_f = run_f.reshape(cap_free, bi * bj)
    rows_fg = jnp.where(valid_f[:, None], rows_f, 0)
    oob_f = NR + jnp.arange(cap_free * bi * bj, dtype=jnp.int32).reshape(
        cap_free, bi * bj)
    rows_fs = jnp.where(valid_f[:, None], rows_f, oob_f)
    Dof = gather(Dt, rows_fg)
    Wof = gather(Wt, rows_fg)
    W_sumf = Wof + 1.0
    W_nf = (W_sumf if cfg.max_weight is None
            else jnp.minimum(W_sumf, cfg.max_weight))
    D_nf = (Wof * Dof + jnp.asarray(params.delta, dtype)) / W_sumf
    Dt = scatter_set(Dt, rows_fs, D_nf)
    Wt = scatter_set(Wt, rows_fs, W_nf)

    out = TSDFGrid(
        D=Dt.reshape(mi, m, m), W=Wt.reshape(mi, m, m),
        R=Rt.reshape(mi, m, m) if fuse_color else grid.R,
        G=Gt.reshape(mi, m, m) if fuse_color else grid.G,
        B=Bt.reshape(mi, m, m) if fuse_color else grid.B,
        Wc=Wct.reshape(mi, m, m) if fuse_color else grid.Wc,
    )
    n_free = stats.n_free
    return out, stats._replace(
        overflow_active=jnp.maximum(n_free - cap_free, 0))
